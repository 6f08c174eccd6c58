"""Edited copies of the port's CUDA sources, built and timed: what the
decomposition probes (`pool_head_decomp`, `message_decomp`,
`ew_kernel_decomp`) share; `call_us` also times kernels 7-10b and their
library calls for `chip_smoke.py` (`profiled_calls`), warm and L2-flushed.

An edit list is `((variant, source, ((file, statement, replacement), ...)),
...)`: `source` is the file under `csrc/` that nvcc compiles, and each
statement is replaced in `file` (`source` or one of the headers,
`_build.HEADERS`). A statement must
occur exactly once, so an edit of a kernel that moves it fails here first; a
statement that is a pair is a span, from its first part up to, not
including, its second. A variant with no statements is the source as it is.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import time

from yolat_tpu_torch.ops import _build


def variant_sources(edits) -> dict:
    """{variant: (source, {file name: text})}: the source and the headers
    with the variant's statements replaced; raises unless each occurs
    once."""
    out = {}
    for name, source, changes in edits:
        files = {}
        for fn in (source, *_build.HEADERS):
            with open(os.path.join(_build.CSRC, fn)) as f:
                files[fn] = f.read()
        for fn, old, new in changes:
            text = files[fn]
            if isinstance(old, tuple):
                if any(text.count(o) != 1 for o in old):
                    raise ValueError(f"{name}: {old} not found once in {fn}")
                i0, i1 = text.index(old[0]), text.index(old[1])
                files[fn] = text[:i0] + new + text[i1:]
            else:
                if text.count(old) != 1:
                    raise ValueError(f"{name}: {old!r} not found once in {fn}")
                files[fn] = text.replace(old, new)
        out[name] = (source, files)
    return out


def build(sources: dict, out: str, sigs: dict) -> dict:
    """{variant: ctypes library} of `variant_sources`' output, each built
    with the package's nvcc flags into out/<variant>/ (one nvcc per variant,
    all started together); `sigs` {source: {C function: argtypes}}, each
    function returning int. A failed build raises."""
    nvcc = _build._nvcc()
    procs = {}
    for name, (source, files) in sources.items():
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        for fn, text in files.items():
            with open(os.path.join(d, fn), "w") as f:
                f.write(text)
        so = os.path.join(d, "lib.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", so, os.path.join(d, source)]
        procs[name] = (so, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {name: p.communicate()[0] for name, (_, _, p) in procs.items()}
    libs = {}
    for name, (so, cmd, p) in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n"
                               f"{logs[name]}")
        lib = ctypes.CDLL(os.path.abspath(so))
        for fn, argtypes in sigs[sources[name][0]].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def check(rc: int, what: str) -> None:
    """Raises with the CUDA error's name (from the package's library)
    unless rc is 0."""
    if rc != 0:
        _build.check(_build.library(), rc, what)


# the profiler's name for a device-to-device copy (a flush's record)
COPY_RECORD = "Memcpy DtoD"
# Host seconds between a profile's start and its first call, and between
# its last call's end and its stop. The profiler keeps a device record only
# inside the profile's window on the host's clock, and a record's time,
# taken on the card and converted, can fall milliseconds off; without the
# margin a profile loses its first or its last records now and then
# (`scripts/profiler_records.py`; PERF.md §7).
MARGIN = 0.05


def kernel_name(key: str) -> str:
    """A profiler record's kernel: its `*_kernel` identifier (all its
    instantiations together), else the record's own name."""
    m = re.search(r"(\w+_kernel)\b", key)
    return m.group(1) if m else key


def _records(fn, calls: int, flush=None, margin: float = MARGIN) -> tuple:
    """({kernel: (device us, records)}, copy records, the profile) of one
    profile (torch.profiler, CUDA activity) of `calls` calls of fn, each
    after flush() where `flush` is given, `margin` host seconds before the
    first call and after the last one's end. Copies are counted, not
    timed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def call():
        flush()
        fn()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        for _ in range(calls):
            (fn if flush is None else call)()
        torch.cuda.synchronize()
        time.sleep(margin)
    got, copies = {}, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or not e.count:
            continue
        if e.key.startswith(COPY_RECORD):
            copies += e.count
        else:
            t, c = got.get(kernel_name(e.key), (0.0, 0))
            got[kernel_name(e.key)] = (t + e.device_time_total, c + e.count)
    return got, copies, prof


def _profile(fn, reps: int, flush=None) -> dict:
    """{kernel: (device us, launches)} over `reps` calls of fn after three
    that are not profiled (`_records`, with its margins); with `flush` (one
    device-to-device copy, as `profiled_calls.l2_flush`), flush() runs before
    every call and its copies are left out. fn must launch the same kernels
    on every call and no copy.

    The profile is held to a reference profile of one call: each kernel
    that the reference holds must have `reps` times its records, no other
    kernel may appear, and there must be one copy per flush. Any difference
    raises, naming both profiles' counts."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ref, ref_copies, _ = _records(fn, 1)
    got, copies, _ = _records(fn, reps, flush)
    if ref_copies:
        raise RuntimeError("fn launches a device-to-device copy")
    per_call = {k: c for k, (_, c) in ref.items()}
    have = {k: c for k, (_, c) in got.items()}
    want_copies = 0 if flush is None else reps
    if not per_call or have != {k: c * reps for k, c in per_call.items()} \
            or copies != want_copies:
        raise RuntimeError(
            f"the profile of {reps} calls held the kernel records {have} and "
            f"{copies} flush copies; a reference profile of one call holds "
            f"{per_call}, and {want_copies} flushes ran: the profiler "
            f"dropped records")
    return got


def device_us(fn, reps: int) -> dict:
    """{kernel: the profiler's device time (us) per launch} of the CUDA
    kernels that `reps` calls of fn launch (`_profile`: three unprofiled
    calls first; a profile that misses records raises)."""
    return {k: t / c for k, (t, c) in _profile(fn, reps).items()}


def call_us(fn, reps: int, flush=None) -> float:
    """The profiler's device time (us) per call of fn: every kernel it
    launches, summed (`_profile`; with `flush`, an L2 flush before every
    call, not counted)."""
    return sum(t for t, _ in _profile(fn, reps, flush).values()) / reps
