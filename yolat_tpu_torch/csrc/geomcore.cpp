// Native geometry kernel for the offline preprocessor.
//
// The proposal generator's per-proposal node-angle statistics
// (yolat_tpu/geom/proposals.py::_angle_stats; reference semantics
// Datasets/graph_dict3.py:649-688) are a pure Python triple loop and the
// hottest host-side code. This kernel computes them in C++; bound via
// ctypes (yolat_tpu/geom/_native.py), with the numpy path as fallback and
// equivalence oracle (tests/test_native.py).
//
// Build: g++ -O3 -shared -fPIC -o libgeomcore.so geomcore.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <unordered_set>
#include <utility>
#include <vector>

namespace {

// path-compressed union-find (mirror of graph_build.UnionFind)
struct UnionFind {
  std::vector<int64_t> parent;
  explicit UnionFind(long n) : parent(n) {
    for (long i = 0; i < n; ++i) parent[i] = i;
  }
  int64_t find(int64_t i) {
    while (parent[i] != i) {
      parent[i] = parent[parent[i]];
      i = parent[i];
    }
    return i;
  }
  void unite(int64_t a, int64_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[std::max(a, b)] = std::min(a, b);
  }
};

// [0, 0, 0, 0, angle, dist^2] super-edge attribute
// (graph_build._edge_geometry_attr; build_graph_bbox.py:196-197)
inline void super_attr(const double* pos, int64_t a, int64_t b, double* out) {
  const double dx = pos[2 * a] - pos[2 * b];
  const double dy = pos[2 * a + 1] - pos[2 * b + 1];
  const double d2 = dx * dx + dy * dy;
  out[0] = out[1] = out[2] = out[3] = 0.0;
  out[4] = dx / (std::sqrt(d2) + 1e-7);
  out[5] = d2;
}

// Greedy row-order merge of points closer than merge_th, groups collapse
// to their mean (split_cross.merge_close_points; reference
// split_cross.py:57-69). io: k points in `pts`, returns merged count.
inline long merge_close(std::vector<double>& pts, double merge_th) {
  const long k = (long)pts.size() / 2;
  if (k == 0) return 0;
  std::vector<uint8_t> merged(k, 0);
  std::vector<double> out;
  out.reserve(pts.size());
  for (long i = 0; i < k; ++i) {
    double sx = 0, sy = 0;
    long cnt = 0;
    // first pass: mean over unmerged close points
    for (long j = 0; j < k; ++j) {
      const double dx = pts[2 * i] - pts[2 * j];
      const double dy = pts[2 * i + 1] - pts[2 * j + 1];
      if (std::sqrt(dx * dx + dy * dy) < merge_th && !merged[j]) {
        sx += pts[2 * j];
        sy += pts[2 * j + 1];
        ++cnt;
      }
    }
    if (cnt == 0) continue;
    out.push_back(sx / cnt);
    out.push_back(sy / cnt);
    // second pass: mark everything close to i merged (incl. already-merged)
    for (long j = 0; j < k; ++j) {
      const double dx = pts[2 * i] - pts[2 * j];
      const double dy = pts[2 * i + 1] - pts[2 * j + 1];
      if (std::sqrt(dx * dx + dy * dy) < merge_th) merged[j] = 1;
    }
  }
  pts.swap(out);
  return (long)pts.size() / 2;
}

}  // namespace

extern "C" {

// Split each line at candidate points lying on it (split_cross.split_line +
// _points_on_line_batch; reference split_cross.py:237-321). Epsilon
// semantics preserved exactly: 1px endpoint exclusion boxes keyed on the
// min/max corners, 3px point-to-line distance (line_th), bbox projection
// containment, merge_th greedy point merging, dominant-axis stable
// ordering. Returns the emitted line count, or -1 on capacity exhaustion.
long split_lines(const double* lines, long n_lines,
                 const double* points, long n_points,
                 double line_th, double merge_th,
                 double* out_lines, long cap_out) {
  const double th2 = line_th * line_th;
  std::vector<double> sp;
  std::vector<long> order;
  long n_out = 0;
  for (long li = 0; li < n_lines; ++li) {
    const double x0 = lines[4 * li], y0 = lines[4 * li + 1];
    const double x1 = lines[4 * li + 2], y1 = lines[4 * li + 3];
    const double min_x = x0 < x1 ? x0 : x1, max_x = x0 < x1 ? x1 : x0;
    const double min_y = y0 < y1 ? y0 : y1, max_y = y0 < y1 ? y1 : y0;
    const bool vert = (x1 - x0) == 0.0;
    const double dx = vert ? 1.0 : x1 - x0;
    const double a = (y1 - y0) / dx;
    const double b = y0 - a * x0;
    const double denom = a * a + 1;

    sp.clear();
    for (long p = 0; p < n_points; ++p) {
      const double x = points[2 * p], y = points[2 * p + 1];
      const bool is_se =
          (std::fabs(x - min_x) <= 1 && std::fabs(y - min_y) <= 1) ||
          (std::fabs(x - max_x) <= 1 && std::fabs(y - max_y) <= 1);
      if (is_se) continue;
      const double t = a * x - y + b;
      const double d2 = vert ? (x - x0) * (x - x0) : t * t / denom;
      if (!(d2 < th2)) continue;
      const double x_proj = vert ? x0 : (a * (y - b) + x) / denom;
      const double y_proj = vert ? y : a * x_proj + b;
      if (x_proj >= min_x && x_proj <= max_x && y_proj >= min_y &&
          y_proj <= max_y) {
        sp.push_back(x);
        sp.push_back(y);
      }
    }
    if (sp.empty()) {
      if (n_out >= cap_out) return -1;
      out_lines[4 * n_out] = x0;
      out_lines[4 * n_out + 1] = y0;
      out_lines[4 * n_out + 2] = x1;
      out_lines[4 * n_out + 3] = y1;
      ++n_out;
      continue;
    }
    merge_close(sp, merge_th);
    // [start, merged..., end], stable-ordered along the dominant axis
    // (split_cross.py:296-306)
    sp.insert(sp.begin(), {x0, y0});
    sp.push_back(x1);
    sp.push_back(y1);
    const long k = (long)sp.size() / 2;
    const int axis = (x1 == x0) ? 1 : (std::fabs(a) > 0.5 ? 1 : 0);
    order.resize(k);
    for (long i = 0; i < k; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](long u, long v) {
      return sp[2 * u + axis] < sp[2 * v + axis];
    });
    if (n_out + k - 1 > cap_out) return -1;
    for (long i = 0; i + 1 < k; ++i) {
      out_lines[4 * n_out] = sp[2 * order[i]];
      out_lines[4 * n_out + 1] = sp[2 * order[i] + 1];
      out_lines[4 * n_out + 2] = sp[2 * order[i + 1]];
      out_lines[4 * n_out + 3] = sp[2 * order[i + 1] + 1];
      ++n_out;
    }
  }
  return n_out;
}

// edges_local: [n_edges, 2] int64 local node ids in [0, n_local)
// pos:         [n_local, 2] float64
// out:         [7] doubles: n_90, n_less90, n_more90, mean, max, min, std
// returns number of angle pairs (0 => proposal must be skipped)
long angle_stats(const int64_t* edges, long n_edges, const double* pos,
                 long n_local, double th, double* out) {
  std::vector<std::vector<int64_t>> nbr(n_local);
  for (long e = 0; e < n_edges; ++e) {
    int64_t a = edges[2 * e], b = edges[2 * e + 1];
    if (a < 0 || b < 0 || a >= n_local || b >= n_local) continue;
    nbr[a].push_back(b);
    nbr[b].push_back(a);
  }

  long n90 = 0, nless = 0, nmore = 0, count = 0;
  double sum = 0.0, sumsq = 0.0;
  double mx = -1e300, mn = 1e300;

  for (long anchor = 0; anchor < n_local; ++anchor) {
    auto& ns = nbr[anchor];
    if (ns.size() < 2) continue;
    std::sort(ns.begin(), ns.end());
    ns.erase(std::unique(ns.begin(), ns.end()), ns.end());
    const double ax = pos[2 * anchor], ay = pos[2 * anchor + 1];
    for (size_t i = 0; i < ns.size(); ++i) {
      const double v0x = pos[2 * ns[i]] - ax;
      const double v0y = pos[2 * ns[i] + 1] - ay;
      for (size_t j = i + 1; j < ns.size(); ++j) {
        const double v1x = pos[2 * ns[j]] - ax;
        const double v1y = pos[2 * ns[j] + 1] - ay;
        const double dot = v0x * v1x + v0y * v1y;
        if (dot <= -th) ++nmore;
        else if (dot >= th) ++nless;
        else if (std::fabs(dot) < th) ++n90;
        sum += dot;
        sumsq += dot * dot;
        if (dot > mx) mx = dot;
        if (dot < mn) mn = dot;
        ++count;
      }
    }
  }

  if (count == 0) return 0;
  const double mean = sum / count;
  double var = sumsq / count - mean * mean;
  if (var < 0) var = 0;
  out[0] = (double)n90;
  out[1] = (double)nless;
  out[2] = (double)nmore;
  out[3] = mean;
  out[4] = mx;
  out[5] = mn;
  out[6] = std::sqrt(var);
  return count;
}

// Batched rectangle point-membership for the grid sweep: for each rect r
// (bounds in value-index space) and each point p (xi/yi value indices),
// set hits[r * n_points + p]. Replaces the per-rect numpy mask churn.
void rect_membership(const int32_t* xi, const int32_t* yi, long n_points,
                     const int32_t* rects,  // [n_rects, 4]: x0, x1, y0, y1
                     long n_rects, uint8_t* hits) {
  for (long r = 0; r < n_rects; ++r) {
    const int32_t x0 = rects[4 * r], x1 = rects[4 * r + 1];
    const int32_t y0 = rects[4 * r + 2], y1 = rects[4 * r + 3];
    uint8_t* row = hits + r * n_points;
    for (long p = 0; p < n_points; ++p) {
      row[p] = (xi[p] >= x0) & (xi[p] <= x1) & (yi[p] >= y0) & (yi[p] <= y1);
    }
  }
}

// Full rectangle enumeration + point-set dedup for one connected component
// (the inner sweep of proposals._enumerate_subclusters). Points are given
// by their x/y value indices; rects by index bounds [x0, x1] x [y0, y1]
// (inclusive). Emits the distinct non-empty point-id sets in first-seen
// order, flattened into out_ids with out_offsets (CSR-style).
//
// Capacity contract: out_ids must hold max_total ids; out_offsets holds
// max_sets + 1 entries. Returns the number of distinct sets, or -1 if
// capacity was exhausted (caller falls back to the Python path).
long enumerate_rect_sets(const int32_t* xi, const int32_t* yi, long n_points,
                         const int32_t* rects, long n_rects,
                         int64_t* out_ids, long max_total,
                         int64_t* out_offsets, long max_sets) {
  std::unordered_set<uint64_t> seen;
  seen.reserve(n_rects * 2);
  std::vector<int64_t> ids;
  ids.reserve(n_points);

  long n_sets = 0;
  long total = 0;
  out_offsets[0] = 0;
  // collision handling: on hash match we accept the set as duplicate. To
  // make collisions negligible the hash is 64-bit FNV-1a over the id list.
  for (long r = 0; r < n_rects; ++r) {
    const int32_t x0 = rects[4 * r], x1 = rects[4 * r + 1];
    const int32_t y0 = rects[4 * r + 2], y1 = rects[4 * r + 3];
    ids.clear();
    uint64_t h = 1469598103934665603ull;
    for (long p = 0; p < n_points; ++p) {
      if (xi[p] >= x0 && xi[p] <= x1 && yi[p] >= y0 && yi[p] <= y1) {
        ids.push_back(p);
        h ^= (uint64_t)p + 0x9e3779b97f4a7c15ull;
        h *= 1099511628211ull;
      }
    }
    if (ids.empty()) continue;
    if (!seen.insert(h).second) continue;
    if (n_sets >= max_sets || total + (long)ids.size() > max_total) return -1;
    for (int64_t v : ids) out_ids[total++] = v;
    ++n_sets;
    out_offsets[n_sets] = total;
  }
  return n_sets;
}

// Full proposal-core sweep: rectangle enumeration + point-set dedup +
// induced-edge computation in one pass. Membership of a point in a window
// is a pure index-range check (the windows are value-index rectangles), so
// induced edges need only 4 comparisons per CC edge, and only for DISTINCT
// windows (the dedup guard runs first, on the O(n_points) membership scan).
//
// Inputs:
//   xi/yi [n_points]   point value-indices within the CC
//   rects [n_rects,4]  x0,x1,y0,y1 inclusive index bounds (reference order)
//   eu/ev [n_edges]    CC edge endpoints as local point indices
// Outputs (CSR): point ids / edge ids per distinct window.
// Returns n_sets, or -1 on capacity exhaustion (caller falls back).
long build_rect_proposals(const int32_t* xi, const int32_t* yi, long n_points,
                          const int32_t* rects, long n_rects,
                          const int64_t* eu, const int64_t* ev, long n_edges,
                          const int64_t* su, const int64_t* sv, long n_supers,
                          int64_t* out_ids, long max_total_ids,
                          int64_t* out_id_off,
                          int64_t* out_eids, long max_total_eids,
                          int64_t* out_eid_off,
                          int64_t* out_sids, long max_total_sids,
                          int64_t* out_sid_off, long max_sets) {
  std::unordered_set<uint64_t> seen;
  seen.reserve(n_rects * 2);
  std::vector<int64_t> ids;
  ids.reserve(n_points);

  long n_sets = 0, total_ids = 0, total_eids = 0, total_sids = 0;
  out_id_off[0] = 0;
  out_eid_off[0] = 0;
  out_sid_off[0] = 0;

  for (long r = 0; r < n_rects; ++r) {
    const int32_t x0 = rects[4 * r], x1 = rects[4 * r + 1];
    const int32_t y0 = rects[4 * r + 2], y1 = rects[4 * r + 3];
    ids.clear();
    uint64_t h = 1469598103934665603ull;
    for (long p = 0; p < n_points; ++p) {
      if (xi[p] >= x0 && xi[p] <= x1 && yi[p] >= y0 && yi[p] <= y1) {
        ids.push_back(p);
        h ^= (uint64_t)p + 0x9e3779b97f4a7c15ull;
        h *= 1099511628211ull;
      }
    }
    if (ids.empty()) continue;
    if (!seen.insert(h).second) continue;
    if (n_sets >= max_sets || total_ids + (long)ids.size() > max_total_ids)
      return -1;

    for (int64_t v : ids) out_ids[total_ids++] = v;

    auto inside = [&](int64_t p) {
      return xi[p] >= x0 && xi[p] <= x1 && yi[p] >= y0 && yi[p] <= y1;
    };
    for (long e = 0; e < n_edges; ++e) {
      if (inside(eu[e]) && inside(ev[e])) {
        if (total_eids >= max_total_eids) return -1;
        out_eids[total_eids++] = e;
      }
    }
    for (long e = 0; e < n_supers; ++e) {
      if (inside(su[e]) && inside(sv[e])) {
        if (total_sids >= max_total_sids) return -1;
        out_sids[total_sids++] = e;
      }
    }

    ++n_sets;
    out_id_off[n_sets] = total_ids;
    out_eid_off[n_sets] = total_eids;
    out_sid_off[n_sets] = total_sids;
  }
  return n_sets;
}

// Full per-CC proposal pipeline: rectangle enumeration + point-set dedup +
// acceptance filters + per-window features + GT labelling + attribute-row
// gathers, one pass, no Python in the loop. Replaces generate_proposals'
// per-proposal body AND the numpy labelling epilogue (yolat_tpu/geom/
// proposals.py; reference semantics Datasets/graph_dict3.py:556-705,625-641):
//   * window accepted iff it has >=1 induced shape edge, extent > min_extent
//     on both axes, and >=1 node-angle pair (graph_dict3.py:597,621,681);
//   * induced edge endpoints are emitted as CC-LOCAL row indices (window
//     start in the flat member stream + rank in the window's ascending
//     point-id list) — the accumulator only adds its global offset;
//   * out_feats row: [min_x, min_y, max_x, max_y,  n_points, n_edges,
//     n_90, n_less90, n_more90, w, h, angle mean/max/min/std,
//     edge-dist mean/std]  (4 box coords + the 13-dim stat_feat);
//   * attr_e/attr_s are the per-cluster-edge 6-dim attribute rows; the
//     induced windows' rows are copied out alongside the edge ids
//     (edge dist = attr_e col 5 feeds the dist stats);
//   * GT labelling per accepted window (same float order as the numpy
//     _iou_ios_many epilogue): IoU argmax over gtb, label = gt_lab[argmax]
//     if best IoU > iou_th else bg_label, target box = the matched GT (0 if
//     background), has_obj = IoS-at-IoU-argmax > ios_th.
// n_distinct_out counts distinct non-empty point sets BEFORE filtering
// (the caller's "CC produced candidate windows" invariant check).
// Returns accepted window count, or -1 on capacity exhaustion.
long window_pipeline(const int32_t* xi, const int32_t* yi, long n_points,
                     const double* pos, const int32_t* rects, long n_rects,
                     const int64_t* eu, const int64_t* ev, long n_edges,
                     const double* attr_e,
                     const int64_t* su, const int64_t* sv, long n_supers,
                     const double* attr_s, const uint8_t* issuper,
                     const double* gtb, const int64_t* gt_lab, long n_gt,
                     long bg_label, double iou_th, double ios_th,
                     double angle_th, double min_extent,
                     int64_t* out_ids, long max_total_ids, int64_t* out_id_off,
                     int64_t* out_eids, long max_total_eids,
                     int64_t* out_eid_off, int64_t* out_eloc,
                     int64_t* out_sids, long max_total_sids,
                     int64_t* out_sid_off, int64_t* out_sloc,
                     double* out_feats, long max_sets,
                     int64_t* n_distinct_out,
                     int normalize, double* out_pos,
                     double* out_eattr, double* out_sattr,
                     uint8_t* out_issuper, int64_t* out_labels,
                     double* out_targets, int64_t* out_hasobj,
                     int64_t* req_out) {
  // counting mode: on the first capacity overflow, stop writing outputs
  // but keep enumerating, so the exact required capacities come out of
  // ONE pass (req_out[3] = ids/eids/sids; return -2). The caller then
  // re-runs once with exact buffers instead of a blind multiply-and-retry
  // loop — half the bench images used to pay a full second pass.
  bool counting = false;
  std::unordered_set<uint64_t> seen;
  seen.reserve(n_rects * 2);
  std::vector<int64_t> ids;
  ids.reserve(n_points);
  std::vector<int64_t> loc(n_points, -1);  // point -> window-local rank
  std::vector<std::vector<int64_t>> nbr;

  // Per-axis prefix bitsets: the grid extents gx/gy are tiny (the sweep
  // emits ~bbox_sampling_step boundaries per axis), so membership of a
  // rect [x0,x1]x[y0,y1] is 4 fused AND/ANDNOT word-ops per 64 entities —
  // `xle[c]` holds the entities with coordinate <= c, so the in-range set
  // is xle[x1] & ~xle[x0-1] (& the same for y). Bit extraction walks ids
  // in ascending order, which the dedup hash, the window-local ranks, and
  // the emitted id/edge order all rely on (parity with the numpy oracle).
  long gx = 1, gy = 1;
  for (long p = 0; p < n_points; ++p) {
    if ((long)xi[p] >= gx) gx = xi[p] + 1;
    if ((long)yi[p] >= gy) gy = yi[p] + 1;
  }
  const long W = (n_points + 63) >> 6;
  const long We = (n_edges + 63) >> 6;
  const long Ws = (n_supers + 63) >> 6;
  if ((gx + gy) * (W + We + Ws) > (1L << 27)) return -1;  // degenerate grid
  std::vector<uint64_t> pxle(gx * W, 0), pyle(gy * W, 0);
  for (long p = 0; p < n_points; ++p) {
    pxle[(long)xi[p] * W + (p >> 6)] |= 1ull << (p & 63);
    pyle[(long)yi[p] * W + (p >> 6)] |= 1ull << (p & 63);
  }
  // edges/supers: both endpoints inside <=> max coord <= hi AND min >= lo
  std::vector<uint64_t> exle(gx * We, 0), exnle(gx * We, 0),
      eyle(gy * We, 0), eynle(gy * We, 0);
  for (long e = 0; e < n_edges; ++e) {
    const int32_t xa = xi[eu[e]], xb = xi[ev[e]];
    const int32_t ya = yi[eu[e]], yb = yi[ev[e]];
    exle[(long)(xa > xb ? xa : xb) * We + (e >> 6)] |= 1ull << (e & 63);
    exnle[(long)(xa < xb ? xa : xb) * We + (e >> 6)] |= 1ull << (e & 63);
    eyle[(long)(ya > yb ? ya : yb) * We + (e >> 6)] |= 1ull << (e & 63);
    eynle[(long)(ya < yb ? ya : yb) * We + (e >> 6)] |= 1ull << (e & 63);
  }
  std::vector<uint64_t> sxle(gx * Ws, 0), sxnle(gx * Ws, 0),
      syle(gy * Ws, 0), synle(gy * Ws, 0);
  for (long e = 0; e < n_supers; ++e) {
    const int32_t xa = xi[su[e]], xb = xi[sv[e]];
    const int32_t ya = yi[su[e]], yb = yi[sv[e]];
    sxle[(long)(xa > xb ? xa : xb) * Ws + (e >> 6)] |= 1ull << (e & 63);
    sxnle[(long)(xa < xb ? xa : xb) * Ws + (e >> 6)] |= 1ull << (e & 63);
    syle[(long)(ya > yb ? ya : yb) * Ws + (e >> 6)] |= 1ull << (e & 63);
    synle[(long)(ya < yb ? ya : yb) * Ws + (e >> 6)] |= 1ull << (e & 63);
  }
  auto prefix_or = [](std::vector<uint64_t>& t, long n, long w) {
    for (long c = 1; c < n; ++c)
      for (long k = 0; k < w; ++k) t[c * w + k] |= t[(c - 1) * w + k];
  };
  prefix_or(pxle, gx, W);
  prefix_or(pyle, gy, W);
  prefix_or(exle, gx, We);
  prefix_or(exnle, gx, We);
  prefix_or(eyle, gy, We);
  prefix_or(eynle, gy, We);
  prefix_or(sxle, gx, Ws);
  prefix_or(sxnle, gx, Ws);
  prefix_or(syle, gy, Ws);
  prefix_or(synle, gy, Ws);
  // in-range word for entity table (xle, optional-lo xnle) at word k
  auto range_word = [&](const std::vector<uint64_t>& xle_t,
                        const std::vector<uint64_t>& xnle_t,
                        const std::vector<uint64_t>& yle_t,
                        const std::vector<uint64_t>& ynle_t, long w,
                        long cx1, long cx0, long cy1, long cy0, long k) {
    uint64_t m = xle_t[cx1 * w + k] & yle_t[cy1 * w + k];
    if (cx0 >= 0) m &= ~xnle_t[cx0 * w + k];
    if (cy0 >= 0) m &= ~ynle_t[cy0 * w + k];
    return m;
  };

  long n_sets = 0, n_distinct = 0;
  long total_ids = 0, total_eids = 0, total_sids = 0;
  // edge rows are written as SCRATCH during discovery (a window can still
  // be rejected by the later angle filter without advancing total_eids),
  // so the required capacity is the peak total+scratch, not the final sum
  long peak_eids = 0;
  out_id_off[0] = 0;
  out_eid_off[0] = 0;
  out_sid_off[0] = 0;

  for (long r = 0; r < n_rects; ++r) {
    const int32_t x0 = rects[4 * r], x1 = rects[4 * r + 1];
    const int32_t y0 = rects[4 * r + 2], y1 = rects[4 * r + 3];
    if (x1 < 0 || y1 < 0) continue;
    const long cx1 = x1 < gx ? x1 : gx - 1;
    const long cy1 = y1 < gy ? y1 : gy - 1;
    const long cx0 = x0 <= 0 ? -1 : (x0 - 1 < gx ? x0 - 1 : gx - 1);
    const long cy0 = y0 <= 0 ? -1 : (y0 - 1 < gy ? y0 - 1 : gy - 1);
    // dedup pre-pass: hash the masked membership WORDS (set identity —
    // equal point sets give bit-equal non-zero words at equal k) so the
    // ~60% duplicate rects never pay member extraction at all
    uint64_t h = 1469598103934665603ull;
    long popcnt = 0;
    for (long k = 0; k < W; ++k) {
      uint64_t m = range_word(pxle, pxle, pyle, pyle, W, cx1, cx0, cy1, cy0, k);
      if (m) {
        h ^= (uint64_t)k + 0x9e3779b97f4a7c15ull;
        h *= 1099511628211ull;
        h ^= m;
        h *= 1099511628211ull;
        popcnt += __builtin_popcountll(m);
      }
    }
    if (popcnt == 0) continue;
    bool fresh = seen.insert(h).second;
    if (!fresh) continue;
    ++n_distinct;

    ids.clear();
    for (long k = 0; k < W; ++k) {
      uint64_t m = range_word(pxle, pxle, pyle, pyle, W, cx1, cx0, cy1, cy0, k);
      while (m) {
        const long p = (k << 6) + __builtin_ctzll(m);
        m &= m - 1;
        loc[p] = (int64_t)ids.size();
        ids.push_back(p);
      }
    }
    const long nw = (long)ids.size();

    bool accept = true;
    double mnx = 0, mny = 0, mxx = 0, mxy = 0;
    if (accept) {
      mnx = mxx = pos[2 * ids[0]];
      mny = mxy = pos[2 * ids[0] + 1];
      for (long k = 1; k < nw; ++k) {
        const double px = pos[2 * ids[k]], py = pos[2 * ids[k] + 1];
        if (px < mnx) mnx = px;
        if (px > mxx) mxx = px;
        if (py < mny) mny = py;
        if (py > mxy) mxy = py;
      }
      if (mxx - mnx < min_extent || mxy - mny < min_extent) accept = false;
    }

    long n_we = 0;
    double dsum = 0.0, dsumsq = 0.0;
    if (accept) {
      // induced shape edges: both endpoints members (4 int compares each);
      // endpoint rows are CC-local (total_ids = this window's member start)
      if ((long)nbr.size() < nw) nbr.resize(nw);
      for (long k = 0; k < nw; ++k) nbr[k].clear();
      const long cap_e = max_total_eids - total_eids;
      for (long k = 0; k < We; ++k) {
        uint64_t m = range_word(exle, exnle, eyle, eynle, We,
                                cx1, cx0, cy1, cy0, k);
        while (m) {
          const long e = (k << 6) + __builtin_ctzll(m);
          m &= m - 1;
          const int64_t la = loc[eu[e]], lb = loc[ev[e]];
          if (n_we >= cap_e) counting = true;
          if (!counting) {
            const long row = total_eids + n_we;
            out_eids[row] = e;
            out_eloc[2 * row] = total_ids + la;
            out_eloc[2 * row + 1] = total_ids + lb;
            for (int c = 0; c < 6; ++c)
              out_eattr[6 * row + c] = attr_e[6 * e + c];
          }
          nbr[la].push_back(lb);
          nbr[lb].push_back(la);
          const double d = attr_e[6 * e + 5];
          dsum += d;
          dsumsq += d * d;
          ++n_we;
        }
      }
      if (total_eids + n_we > peak_eids) peak_eids = total_eids + n_we;
      if (n_we == 0) accept = false;
    }

    double feats[13];
    if (accept) {
      // node-angle statistics over the induced subgraph (dedup'd neighbours)
      long n90 = 0, nless = 0, nmore = 0, count = 0;
      double asum = 0.0, asumsq = 0.0, amx = -1e300, amn = 1e300;
      for (long k = 0; k < nw; ++k) {
        auto& ns = nbr[k];
        if (ns.size() < 2) continue;
        std::sort(ns.begin(), ns.end());
        ns.erase(std::unique(ns.begin(), ns.end()), ns.end());
        const double ax = pos[2 * ids[k]], ay = pos[2 * ids[k] + 1];
        for (size_t i = 0; i < ns.size(); ++i) {
          const double v0x = pos[2 * ids[ns[i]]] - ax;
          const double v0y = pos[2 * ids[ns[i]] + 1] - ay;
          for (size_t j = i + 1; j < ns.size(); ++j) {
            const double v1x = pos[2 * ids[ns[j]]] - ax;
            const double v1y = pos[2 * ids[ns[j]] + 1] - ay;
            const double dot = v0x * v1x + v0y * v1y;
            if (dot <= -angle_th) ++nmore;
            else if (dot >= angle_th) ++nless;
            else if (std::fabs(dot) < angle_th) ++n90;
            asum += dot;
            asumsq += dot * dot;
            if (dot > amx) amx = dot;
            if (dot < amn) amn = dot;
            ++count;
          }
        }
      }
      if (count == 0) {
        accept = false;
      } else {
        const double amean = asum / count;
        double avar = asumsq / count - amean * amean;
        if (avar < 0) avar = 0;
        const double dmean = dsum / n_we;
        double dvar = dsumsq / n_we - dmean * dmean;
        if (dvar < 0) dvar = 0;
        feats[0] = (double)nw;
        feats[1] = (double)n_we;
        feats[2] = (double)n90;
        feats[3] = (double)nless;
        feats[4] = (double)nmore;
        feats[5] = mxx - mnx;
        feats[6] = mxy - mny;
        feats[7] = amean;
        feats[8] = amx;
        feats[9] = amn;
        feats[10] = std::sqrt(avar);
        feats[11] = dmean;
        feats[12] = std::sqrt(dvar);
      }
    }

    if (accept) {
      if (n_sets >= max_sets || total_ids + nw > max_total_ids)
        counting = true;
      long n_ws = 0;
      const long cap_s = max_total_sids - total_sids;
      for (long k = 0; k < Ws; ++k) {
        uint64_t m = range_word(sxle, sxnle, syle, synle, Ws,
                                cx1, cx0, cy1, cy0, k);
        while (m) {
          const long e = (k << 6) + __builtin_ctzll(m);
          m &= m - 1;
          if (n_ws >= cap_s) counting = true;
          if (!counting) {
            const long row = total_sids + n_ws;
            out_sids[row] = e;
            out_sloc[2 * row] = total_ids + loc[su[e]];
            out_sloc[2 * row + 1] = total_ids + loc[sv[e]];
            for (int c = 0; c < 6; ++c)
              out_sattr[6 * row + c] = attr_s[6 * e + c];
          }
          ++n_ws;
        }
      }
      // per-window positions, optionally normalised to the window box
      // (graph_dict3.py:707-714) — replaces the Python epilogue's
      // gather + repeat-divide over every (window, member) row
      const double bw = (mxx - mnx) != 0.0 ? (mxx - mnx) : 1.0;
      const double bh = (mxy - mny) != 0.0 ? (mxy - mny) : 1.0;
      if (!counting) {
        for (int64_t v : ids) {
          if (normalize) {
            out_pos[2 * total_ids] = (pos[2 * v] - mnx) / bw;
            out_pos[2 * total_ids + 1] = (pos[2 * v + 1] - mny) / bh;
          } else {
            out_pos[2 * total_ids] = pos[2 * v];
            out_pos[2 * total_ids + 1] = pos[2 * v + 1];
          }
          out_issuper[total_ids] = issuper[v];
          out_ids[total_ids++] = v;
        }
      } else {
        total_ids += nw;
      }
      total_eids += n_we;
      total_sids += n_ws;
      if (!counting) {
        double* f = out_feats + 17 * n_sets;
        f[0] = mnx; f[1] = mny; f[2] = mxx; f[3] = mxy;
        for (int k = 0; k < 13; ++k) f[4 + k] = feats[k];
      }

      // GT labelling (graph_dict3.py:625-641; float order matches the
      // numpy epilogue _iou_ios_many: first IoU argmax wins ties)
      long best = -1;
      double best_iou = -1.0, best_ios = 0.0;
      for (long g = 0; !counting && g < n_gt; ++g) {
        const double gx0 = gtb[4 * g], gy0 = gtb[4 * g + 1];
        const double gx1 = gtb[4 * g + 2], gy1 = gtb[4 * g + 3];
        const double ix0 = mnx > gx0 ? mnx : gx0;
        const double iy0 = mny > gy0 ? mny : gy0;
        const double ix1 = mxx < gx1 ? mxx : gx1;
        const double iy1 = mxy < gy1 ? mxy : gy1;
        const double iw = ix1 - ix0 > 0.0 ? ix1 - ix0 : 0.0;
        const double ih = iy1 - iy0 > 0.0 ? iy1 - iy0 : 0.0;
        const double inter = iw * ih;
        const double a1 = (mxx - mnx) * (mxy - mny);
        const double a2 = (gx1 - gx0) * (gy1 - gy0);
        const double iou = inter / (a1 + a2 - inter + 1e-16);
        if (iou > best_iou) {
          best_iou = iou;
          best_ios = inter / a2;
          best = g;
        }
      }
      if (!counting) {
        if (best >= 0 && best_iou > iou_th) {
          out_labels[n_sets] = gt_lab[best];
          for (int c = 0; c < 4; ++c)
            out_targets[4 * n_sets + c] = gtb[4 * best + c];
        } else {
          out_labels[n_sets] = bg_label;
          for (int c = 0; c < 4; ++c) out_targets[4 * n_sets + c] = 0.0;
        }
        out_hasobj[n_sets] = (best >= 0 && best_ios > ios_th) ? 1 : 0;
      }
      ++n_sets;
      if (!counting) {
        out_id_off[n_sets] = total_ids;
        out_eid_off[n_sets] = total_eids;
        out_sid_off[n_sets] = total_sids;
      }
    }

    for (long p : ids) loc[p] = -1;
  }
  *n_distinct_out = n_distinct;
  if (counting) {
    req_out[0] = total_ids;
    req_out[1] = peak_eids;
    req_out[2] = total_sids;
    return -2;
  }
  return n_sets;
}

// Full mergeCC (graph_build.merge_connected_components; reference
// build_graph_bbox.py:87-213): connected components over shape edges
// (control nodes excluded), intra-CC clique "super" edges, cross-CC
// containment edges (>=90% bbox inclusion incl. the degenerate zero-extent
// conventions), transitive CC merging, and the 6-dim super-edge attrs.
//
// Outputs:
//   out_clique [*,2] + out_clique_attr [*,6]   lexicographically sorted,
//   out_cross  [*,2] + out_cross_attr  [*,6]   deduped (np.unique order)
//   out_cc_ids / out_cc_off (CSR)              merged CCs, each sorted,
//                                              ordered by smallest member
//   counts_out [3] = n_clique, n_cross, n_cc
// Returns 0, or -1 if any capacity was exhausted (caller falls back).
long merge_cc(const double* pos, long n_nodes,
              const int64_t* edges, long n_edges,
              const uint8_t* is_control, double contain_th,
              int64_t* out_clique, long cap_clique,
              int64_t* out_cross, long cap_cross,
              double* out_clique_attr, double* out_cross_attr,
              int64_t* out_cc_ids, long cap_cc_ids,
              int64_t* out_cc_off, long cap_ccs,
              int64_t* counts_out) {
  UnionFind uf(n_nodes);
  for (long e = 0; e < n_edges; ++e) uf.unite(edges[2 * e], edges[2 * e + 1]);

  // CCs over non-control nodes, ordered by smallest member (ascending node
  // scan groups members in ascending order automatically)
  std::vector<int64_t> root_to_cc(n_nodes, -1);
  std::vector<std::vector<int64_t>> ccs;
  for (long i = 0; i < n_nodes; ++i) {
    if (is_control[i]) continue;
    const int64_t r = uf.find(i);
    if (root_to_cc[r] < 0) {
      root_to_cc[r] = (int64_t)ccs.size();
      ccs.emplace_back();
    }
    ccs[root_to_cc[r]].push_back(i);
  }
  const long n_cc = (long)ccs.size();

  // intra-CC cliques; member lists are ascending so pairs are (min, max)
  // and per-CC blocks are lexicographic — but blocks can interleave across
  // CCs, so a global sort reproduces np.unique's row order
  long n_clique = 0;
  for (long c = 0; c < n_cc; ++c) {
    const auto& m = ccs[c];
    const long k = (long)m.size();
    if (n_clique + k * (k - 1) / 2 > cap_clique) return -1;
    for (long i = 0; i < k; ++i)
      for (long j = i + 1; j < k; ++j) {
        out_clique[2 * n_clique] = m[i];
        out_clique[2 * n_clique + 1] = m[j];
        ++n_clique;
      }
  }
  {
    std::vector<std::pair<int64_t, int64_t>> p(n_clique);
    for (long i = 0; i < n_clique; ++i)
      p[i] = {out_clique[2 * i], out_clique[2 * i + 1]};
    std::sort(p.begin(), p.end());
    p.erase(std::unique(p.begin(), p.end()), p.end());
    n_clique = (long)p.size();
    for (long i = 0; i < n_clique; ++i) {
      out_clique[2 * i] = p[i].first;
      out_clique[2 * i + 1] = p[i].second;
    }
  }

  // CC bboxes + containment matrix (build_graph_bbox.py:130-160)
  std::vector<double> bx0(n_cc), by0(n_cc), bx1(n_cc), by1(n_cc);
  for (long c = 0; c < n_cc; ++c) {
    double x0 = 1e300, y0 = 1e300, x1 = -1e300, y1 = -1e300;
    for (int64_t i : ccs[c]) {
      const double px = pos[2 * i], py = pos[2 * i + 1];
      if (px < x0) x0 = px;
      if (px > x1) x1 = px;
      if (py < y0) y0 = py;
      if (py > y1) y1 = py;
    }
    bx0[c] = x0; by0[c] = y0; bx1[c] = x1; by1[c] = y1;
  }
  std::vector<uint8_t> contained(n_cc * n_cc, 0);
  for (long i = 0; i < n_cc; ++i) {
    for (long j = 0; j < n_cc; ++j) {
      if (i == j) continue;
      const double ix0 = std::max(bx0[i], bx0[j]);
      const double iy0 = std::max(by0[i], by0[j]);
      const double ix1 = std::min(bx1[i], bx1[j]);
      const double iy1 = std::min(by1[i], by1[j]);
      const double cw = bx1[j] - bx0[j], ch = by1[j] - by0[j];
      const double child_area = cw * ch;
      const double inter =
          std::max(ix1 - ix0, 0.0) * std::max(iy1 - iy0, 0.0);
      bool in = false;
      if (child_area > 0.0) in = inter / child_area > contain_th;
      if (cw == 0.0)
        in = in || (ix1 - ix0 == 0.0 &&
                    std::max(iy1 - iy0, 0.0) > contain_th * ch);
      if (ch == 0.0)
        in = in || (std::max(ix1 - ix0, 0.0) > contain_th * cw &&
                    iy1 - iy0 == 0.0);
      contained[i * n_cc + j] = in;
    }
  }

  // cross-CC edges for each contained (parent, child) pair: full bipartite
  // product, pair-sorted, globally deduped (np.unique order)
  {
    std::vector<std::pair<int64_t, int64_t>> p;
    for (long i = 0; i < n_cc; ++i)
      for (long j = 0; j < n_cc; ++j) {
        if (!contained[i * n_cc + j]) continue;
        for (int64_t a : ccs[i])
          for (int64_t b : ccs[j])
            p.emplace_back(std::min(a, b), std::max(a, b));
      }
    std::sort(p.begin(), p.end());
    p.erase(std::unique(p.begin(), p.end()), p.end());
    if ((long)p.size() > cap_cross) return -1;
    for (long i = 0; i < (long)p.size(); ++i) {
      out_cross[2 * i] = p[i].first;
      out_cross[2 * i + 1] = p[i].second;
    }
    counts_out[1] = (long)p.size();
  }

  for (long i = 0; i < n_clique; ++i)
    super_attr(pos, out_clique[2 * i], out_clique[2 * i + 1],
               out_clique_attr + 6 * i);
  for (long i = 0; i < counts_out[1]; ++i)
    super_attr(pos, out_cross[2 * i], out_cross[2 * i + 1],
               out_cross_attr + 6 * i);

  // transitively merge contained CCs (either direction)
  UnionFind cuf(n_cc);
  for (long i = 0; i < n_cc; ++i)
    for (long j = 0; j < n_cc; ++j)
      if (contained[i * n_cc + j]) cuf.unite(i, j);
  std::vector<int64_t> groot_to_g(n_cc, -1);
  std::vector<std::vector<int64_t>> merged;
  for (long c = 0; c < n_cc; ++c) {  // CC order = ascending min member
    const int64_t r = cuf.find(c);
    if (groot_to_g[r] < 0) {
      groot_to_g[r] = (int64_t)merged.size();
      merged.emplace_back();
    }
    auto& g = merged[groot_to_g[r]];
    g.insert(g.end(), ccs[c].begin(), ccs[c].end());
  }
  if ((long)merged.size() > cap_ccs) return -1;
  long total = 0;
  out_cc_off[0] = 0;
  for (long g = 0; g < (long)merged.size(); ++g) {
    auto& m = merged[g];
    std::sort(m.begin(), m.end());
    if (total + (long)m.size() > cap_cc_ids) return -1;
    for (int64_t v : m) out_cc_ids[total++] = v;
    out_cc_off[g + 1] = total;
  }

  counts_out[0] = n_clique;
  counts_out[2] = (long)merged.size();
  return 0;
}

// Grid-sweep rectangle enumeration (proposals._sweep_rects inner walks +
// the nested rect product; reference graph_dict3.py:472-523 walk order).
// x/y value lists are ascending-unique; grids are the boundary positions.
// Emits rects as (x0, x1, y0, y1) inclusive index bounds in the exact
// reference nesting: y_start > x_start > y_end > x_end.
// Returns rect count, or -1 if cap_rects was exhausted.
long sweep_rects(const double* xv, long nx, const double* yv, long ny,
                 const double* xg, long ngx, const double* yg, long ngy,
                 int32_t* out_rects, long cap_rects) {
  auto walk_starts = [](const double* v, long n, const double* g, long ng,
                        std::vector<std::pair<long, long>>& out) {
    long prev = -1;
    for (long gi = 0; gi < ng; ++gi) {
      long x = prev + 1;
      while (x < n && v[x] < g[gi]) ++x;
      if (x == prev) continue;
      prev = x;
      if (x < n) out.emplace_back(x, gi);
    }
  };
  auto walk_ends = [](const double* v, long n, const double* g, long ng,
                      long gi0, long start, std::vector<long>& out) {
    long prev = start;
    for (long k = gi0 + 1; k < ng; ++k) {
      long x = prev + 1;
      while (x < n && v[x] <= g[k]) ++x;
      const long e = x - 1;
      if (e == prev) continue;
      prev = e;
      out.push_back(e);
    }
  };

  std::vector<std::pair<long, long>> xs, ys;
  walk_starts(xv, nx, xg, ngx, xs);
  walk_starts(yv, ny, yg, ngy, ys);
  std::vector<std::vector<long>> xe(xs.size()), ye(ys.size());
  for (size_t i = 0; i < xs.size(); ++i)
    walk_ends(xv, nx, xg, ngx, xs[i].second, xs[i].first, xe[i]);
  for (size_t i = 0; i < ys.size(); ++i)
    walk_ends(yv, ny, yg, ngy, ys[i].second, ys[i].first, ye[i]);

  long n = 0;
  for (size_t yi = 0; yi < ys.size(); ++yi)
    for (size_t xi = 0; xi < xs.size(); ++xi)
      for (long y1 : ye[yi])
        for (long x1 : xe[xi]) {
          if (n >= cap_rects) return -1;
          out_rects[4 * n] = (int32_t)xs[xi].first;
          out_rects[4 * n + 1] = (int32_t)x1;
          out_rects[4 * n + 2] = (int32_t)ys[yi].first;
          out_rects[4 * n + 3] = (int32_t)y1;
          ++n;
        }
  return n;
}

// ---------------------------------------------------------------------------
// compact_sort_align: the CompactFile edge transform (data/packing.py) in one
// native pass — stable counting-sort of an edge family by ORIGINAL dst
// (old2new is strictly increasing, so this equals sorting by remapped dst),
// endpoint remap through old2new, and run alignment to `block` (pad rows
// carry the run's dst as src=dst, zero attrs, valid=false — the
// data/packing._align_runs semantics). block=1 = sort+remap only.
//
// Two-phase protocol: with out_edge == nullptr, returns the aligned row
// count only (histogram pass); with outputs, fills [s2, 2] int32 edges,
// [s2, 4] float attrs (first 4 input columns), [s2] uint8 valid and
// returns s2, or -1 if s2 > cap.
long compact_sort_align_stats(const int64_t* edge, const float* attr, long S,
                              long attr_in_dim, const int64_t* old2new,
                              long n_old, long block, int32_t* out_edge,
                              float* out_attr, uint8_t* out_valid, long cap,
                              long n_new, float* out_dst_count,
                              float* out_src_count, float* out_abar,
                              uint8_t* out_member) {
  if (block < 1) block = 1;
  std::vector<long> cnt((size_t)n_old, 0);
  for (long i = 0; i < S; ++i) ++cnt[(size_t)edge[2 * i + 1]];
  long s2 = 0;
  for (long d = 0; d < n_old; ++d)
    if (cnt[(size_t)d]) s2 += ((cnt[(size_t)d] + block - 1) / block) * block;
  if (out_edge == nullptr) return s2;
  if (s2 > cap) return -1;

  // per-REMAPPED-node segment populations over REAL rows — the pack-time
  // fields (data/packing.py) emitted in the same pass for free: in-degree,
  // out-degree, mean incoming attr (sup_abar) and edge-endpoint membership
  if (out_dst_count) for (long v = 0; v < n_new; ++v) out_dst_count[v] = 0.0f;
  if (out_src_count) for (long v = 0; v < n_new; ++v) out_src_count[v] = 0.0f;
  if (out_abar)
    for (long v = 0; v < 4 * n_new; ++v) out_abar[v] = 0.0f;
  if (out_member) for (long v = 0; v < n_new; ++v) out_member[v] = 0;

  // aligned start offset per ORIGINAL dst id, then fill forward (stable)
  std::vector<long> offs((size_t)n_old, 0);
  long acc = 0;
  for (long d = 0; d < n_old; ++d) {
    offs[(size_t)d] = acc;
    if (cnt[(size_t)d]) acc += ((cnt[(size_t)d] + block - 1) / block) * block;
  }
  std::vector<long> fill((size_t)n_old, 0);
  for (long i = 0; i < S; ++i) {
    const long d = edge[2 * i + 1];
    const long p = offs[(size_t)d] + fill[(size_t)d]++;
    const long ns = old2new[(size_t)edge[2 * i]];
    const long nd = old2new[(size_t)d];
    out_edge[2 * p] = (int32_t)ns;
    out_edge[2 * p + 1] = (int32_t)nd;
    const float* a = attr + attr_in_dim * i;
    float* o = out_attr + 4 * p;
    const long m = attr_in_dim < 4 ? attr_in_dim : 4;
    for (long c = 0; c < m; ++c) o[c] = a[c];
    for (long c = m; c < 4; ++c) o[c] = 0.0f;
    out_valid[p] = 1;
    if (out_dst_count) out_dst_count[nd] += 1.0f;
    if (out_src_count) out_src_count[ns] += 1.0f;
    if (out_abar) {
      float* ab = out_abar + 4 * nd;
      for (long c = 0; c < 4; ++c) ab[c] += o[c];
    }
    if (out_member) {
      out_member[ns] = 1;
      out_member[nd] = 1;
    }
  }
  if (out_abar && out_dst_count)
    for (long v = 0; v < n_new; ++v) {
      const float c = out_dst_count[v];
      if (c > 0.0f) {
        float* ab = out_abar + 4 * v;
        for (long k = 0; k < 4; ++k) ab[k] /= c;
      }
    }
  // pad rows: src = dst = the run's REMAPPED dst, zero attr, invalid
  for (long d = 0; d < n_old; ++d) {
    const long c = cnt[(size_t)d];
    if (!c) continue;
    const long a2 = ((c + block - 1) / block) * block;
    const int32_t nd = (int32_t)old2new[(size_t)d];
    for (long k = c; k < a2; ++k) {
      const long p = offs[(size_t)d] + k;
      out_edge[2 * p] = nd;
      out_edge[2 * p + 1] = nd;
      float* o = out_attr + 4 * p;
      o[0] = o[1] = o[2] = o[3] = 0.0f;
      out_valid[p] = 0;
    }
  }
  return s2;
}

long compact_sort_align(const int64_t* edge, const float* attr, long S,
                        long attr_in_dim, const int64_t* old2new, long n_old,
                        long block, int32_t* out_edge, float* out_attr,
                        uint8_t* out_valid, long cap) {
  return compact_sort_align_stats(edge, attr, S, attr_in_dim, old2new, n_old,
                                  block, out_edge, out_attr, out_valid, cap,
                                  0, nullptr, nullptr, nullptr, nullptr);
}

}  // extern "C"
