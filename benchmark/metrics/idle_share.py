"""idle_share: the share of the traced window in which no operation ran on
the device (1 - the union of the device records over the window), %."""

from benchmark import trace


def read(rec):
    t = rec["trace"]
    if t is None or t["hi"] <= t["lo"]:
        return None
    busy = trace.busy_ns([(s, e) for _, s, e in t["dev"]], t["lo"], t["hi"])
    if busy <= 0:
        return None
    return (1.0 - busy / (t["hi"] - t["lo"])) * 100.0
