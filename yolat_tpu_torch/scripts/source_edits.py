"""Edited copies of the port's CUDA sources, built and timed: what the
decomposition probes (`pool_head_decomp`, `message_decomp`,
`ew_kernel_decomp`) share.

An edit list is `((variant, source, ((file, statement, replacement), ...)),
...)`: `source` is the file under `csrc/` that nvcc compiles, and each
statement is replaced in `file` (`source` or `common.cuh`). A statement must
occur exactly once, so an edit of a kernel that moves it fails here first; a
statement that is a pair is a span, from its first part up to, not
including, its second. A variant with no statements is the source as it is.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess

from yolat_tpu_torch.ops import _build


def variant_sources(edits) -> dict:
    """{variant: (source, {file name: text})}: the source and common.cuh with
    the variant's statements replaced; raises unless each occurs once."""
    out = {}
    for name, source, changes in edits:
        files = {}
        for fn in (source, "common.cuh"):
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


def device_us(fn, reps: int) -> dict:
    """{kernel: the profiler's device time (us) per launch} of the CUDA
    kernels that `reps` calls of fn launch (torch.profiler, CUDA activity),
    after three calls that are not profiled; a kernel is named by its
    `*_kernel` identifier, its instantiations together. Raises if the
    profile holds no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
            kern = re.search(r"(\w+_kernel)\b", e.key)
            kern = kern.group(1) if kern else e.key
            total[kern] = total.get(kern, 0.0) + e.device_time_total
            count[kern] = count.get(kern, 0) + e.count
    if not total:
        raise RuntimeError(f"the profile of {reps} calls holds no CUDA kernel")
    return {k: total[k] / count[k] for k in total}
