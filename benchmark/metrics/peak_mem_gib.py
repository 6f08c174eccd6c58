"""peak_mem_gib: the most device memory the process's allocator held over
the window, graph pools included (`torch.cuda.max_memory_reserved` after a
reset at the window's start), GiB."""


def read(rec):
    if rec["peak_reserved_bytes"] is None:
        return None
    return rec["peak_reserved_bytes"] / 2 ** 30
