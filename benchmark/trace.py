"""Read a torch.profiler trace: the device's operations and the host's
spans in one traced window, their union and gaps.

The record parsing is a copy of the program's
yolat_tpu_torch/scripts/profiler_records.py (`_one`) at commit 8dc2b5b: the
kineto results' events, each with its name, device type, start and
duration in ns on the host's clock, device records told apart by
`DeviceType.CUDA`; the device's copies of the harness's own spans (user
annotations) are no operation and are left out.
"""

from __future__ import annotations

import bisect


def records(prof) -> tuple:
    """(device [(name, start_ns, end_ns)], host [(name, start_ns, end_ns)])
    of a finished `torch.profiler.profile`."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        t0 = ev.start_ns()
        rec = (ev.name(), t0, t0 + ev.duration_ns())
        if ev.device_type() != cuda:
            host.append(rec)
        elif not _annotation(ev):
            dev.append(rec)
    return dev, host


def _annotation(ev) -> bool:
    """A record_function span's copy on the device's timeline (kineto's
    gpu_user_annotation): no operation ran in it."""
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag and flag()) or ev.name().startswith("bench.")


def union(intervals, lo: int, hi: int) -> list:
    """The intervals clipped to [lo, hi] and merged: sorted, disjoint."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def busy_ns(intervals, lo: int, hi: int) -> int:
    """Time in [lo, hi] in which at least one interval runs."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals, lo: int, hi: int) -> list:
    """The idle stretches of [lo, hi] between the merged intervals."""
    out, at = [], lo
    for s, e in union(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def span(host, name: str) -> tuple:
    """(start, end) of the host span called `name` (the last one)."""
    found = [(s, e) for n, s, e in host if n == name]
    if not found:
        raise ValueError(f"no host span {name!r} in the trace")
    return found[-1]


def top_ops(dev, lo: int, hi: int, k: int = 10) -> list:
    """[[name, seconds]] of the k device operations that took most time in
    [lo, hi], summed by name."""
    tot: dict = {}
    for n, s, e in dev:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            tot[n] = tot.get(n, 0) + (e - s)
    return [[n[:120], t / 1e9]
            for n, t in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def named_gaps(dev, host, lo: int, hi: int, k: int = 10) -> list:
    """[[what the host was doing, seconds]] of the k longest device idle
    gaps in [lo, hi]. Each is named by the host events that cover the
    gap's middle: the innermost of the harness's own spans (`bench.*`)
    and the innermost event of all (the latest started), joined by ' > ',
    or 'host: none'."""
    longest = sorted(gaps([(s, e) for _, s, e in dev], lo, hi),
                     key=lambda g: g[0] - g[1])[:k]
    by_start = sorted(host, key=lambda r: r[1])
    starts = [r[1] for r in by_start]
    out = []
    for s, e in longest:
        mid = (s + e) // 2
        covering = [n for n, hs, he in by_start[:bisect.bisect_right(
            starts, mid)] if he >= mid]
        own = [n for n in covering if n.startswith("bench.")]
        names = ([own[-1]] if own else []) + covering[-1:]
        if len(names) == 2 and names[0] == names[1]:
            names = names[:1]
        out.append([" > ".join(names)[:120] or "host: none", (e - s) / 1e9])
    return out
