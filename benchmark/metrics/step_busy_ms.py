"""step_busy_ms: the time in the traced window in which some operation ran
on the device (the union of the profiler's device records), per step (ms)."""

from benchmark import trace


def read(rec):
    t = rec["trace"]
    if t is None or not t["steps"]:
        return None
    busy = trace.busy_ns([(s, e) for _, s, e in t["dev"]], t["lo"], t["hi"])
    if busy <= 0:
        return None
    return busy / t["steps"] / 1e6
