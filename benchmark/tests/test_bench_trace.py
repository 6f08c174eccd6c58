"""The trace reduction: interval union, gaps, the breakdown."""

from benchmark import trace


def test_union_merges_overlaps_and_clips():
    iv = [(5, 10), (0, 3), (2, 4), (9, 12), (20, 30)]
    assert trace.union(iv, 1, 25) == [(1, 4), (5, 12), (20, 25)]
    assert trace.busy_ns(iv, 1, 25) == 3 + 7 + 5


def test_union_counts_overlap_once():
    iv = [(0, 10), (0, 10), (2, 5)]
    assert trace.busy_ns(iv, 0, 10) == 10


def test_gaps_lead_trail_and_between():
    iv = [(2, 4), (6, 8)]
    assert trace.gaps(iv, 0, 10) == [(0, 2), (4, 6), (8, 10)]
    assert trace.gaps([], 0, 10) == [(0, 10)]
    assert trace.gaps([(0, 10)], 0, 10) == []


def test_top_ops_sums_by_name():
    dev = [("a", 0, 4), ("b", 4, 5), ("a", 6, 8), ("c", 100, 200)]
    assert trace.top_ops(dev, 0, 10) == [["a", 6e-9], ["b", 1e-9]]


def test_named_gaps_take_the_innermost_host_event():
    dev = [("k", 0, 10), ("k", 50, 60)]
    host = [("bench.traced", 0, 100), ("bench.loader_wait", 12, 48),
            ("aten::copy_", 60, 62)]
    got = trace.named_gaps(dev, host, 0, 100)
    # two gaps of 40 ns: (10, 50) under the loader wait, (60, 100) under
    # the traced span alone
    assert got == [["bench.loader_wait", 40e-9], ["bench.traced", 40e-9]]
    host.append(("aten::copy_", 25, 35))
    got = trace.named_gaps(dev, host, 0, 100)
    assert got[0] == ["bench.loader_wait > aten::copy_", 40e-9]
    assert trace.named_gaps(dev, [], 0, 100)[0] == ["host: none", 40e-9]
    assert trace.span(host, "bench.loader_wait") == (12, 48)
