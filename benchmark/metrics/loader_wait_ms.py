"""loader_wait_ms: the harness's clock around each `next()` on the
loader's `iter_buckets`, summed over the window, per step (ms)."""


def read(rec):
    if not rec["steps"]:
        return None
    return rec["wait_s"] / rec["steps"] * 1e3
