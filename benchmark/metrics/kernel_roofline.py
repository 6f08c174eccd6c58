"""kernel_roofline: the port's own kernels in the traced window, as a share
of their roofline (%): the sum of each launch's least time
(`roofline.KERNELS`: bytes at 3.35 TB/s or products at 989 TFLOP/s, from
its batch's real node rows and the 8-row blocks that hold one, not the
padded rows the mask discards) over the sum of the profiler's device time
of their records. Every traced step launches each kernel alike, so a
kernel's launches are shared evenly over the traced steps' batches.
Nothing when none of them launched there."""

from benchmark.roofline import KERNELS, bound_s


def read(rec):
    t = rec["trace"]
    if t is None or not t["rows"]:
        return None
    bound = dev = 0.0
    for name, k in KERNELS.items():
        n = t["launches"].get(name, 0)
        if n <= 0:
            continue
        per_step = sum(bound_s(*k["work"](rows, blocks, rec["config"]))
                       for rows, blocks in t["rows"])
        bound += n / len(t["rows"]) * per_step
        dev += sum(e - s for nm, s, e in t["dev"]
                   if any(p in nm for p in k["names"])
                   and s >= t["lo"] and e <= t["hi"]) / 1e9
    if bound <= 0 or dev <= 0:
        return None
    return bound / dev * 100.0
