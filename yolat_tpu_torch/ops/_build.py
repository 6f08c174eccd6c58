"""Build, load and count the port's CUDA kernels.

`yolat_tpu_torch/csrc/*.cu` (plain C entry points, no PyTorch headers) are
compiled at first use by one nvcc per source, all started together,

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
       -fPIC -Xptxas -v -c <source>.cu -o <source>.o

and linked (`nvcc -shared`) into build/yolat_tpu_torch/<hash>/
libyolat_kernels.so, keyed on a hash of the sources and flags (`build/`
is git-ignored); ptxas's register and spill report is kept beside it in
ptxas.log. The library is loaded with ctypes. A build failure raises; nothing falls back. The
launch counters are plain integers the kernel wrappers bump where they
launch (and nowhere else), so a run can show its path went through them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "yolat_tpu_torch")
SOURCES = ("edge_window.cu", "block_max.cu", "fused_pool_train.cu",
           "edge_window_train.cu", "dense_message.cu", "banded_message.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# dynamic shared memory one block can opt into on sm_90 (bytes)
SMEM_LIMIT = 232448

launch_counts = {"edge_window_message_sum": 0, "folded_mlp_block_max2": 0,
                 "folded_mlp_block_max": 0, "fused_pool_train_bwd": 0,
                 "fused_dense_message": 0, "ew_pair_features": 0,
                 "ew_pair_features_bwd": 0, "ew_window_segment_sum": 0,
                 "ew_window_segment_sum_bwd": 0, "banded_message_sum": 0,
                 "banded_message_sum_both": 0}

_lock = threading.Lock()
_lib = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the yolat_tpu_torch kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], "libyolat_kernels.so")


def _compile(so: str) -> None:
    out = os.path.dirname(so)
    os.makedirs(out, exist_ok=True)
    tag = f"tmp.{os.getpid()}"
    nvcc = _nvcc()
    procs = []
    for src in SOURCES:
        obj = os.path.join(out, f"{src}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
               os.path.join(CSRC, src), "-o", obj]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    for cmd, _, p in procs:
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
        logs.append(log)
    tmp = f"{so}.{tag}"
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *[o for _, o, _ in procs]]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                           f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
    for _, obj, _ in procs:
        os.remove(obj)
    with open(os.path.join(out, "ptxas.log"), "w") as f:
        f.write("".join(logs))
    os.replace(tmp, so)


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiling it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            _compile(so)
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.yk_edge_window_message_sum.argtypes = [p] * 10 + [i] * 6 + [p]
        lib.yk_edge_window_message_sum.restype = i
        lib.yk_edge_window_smem_bytes.argtypes = [i] * 3
        lib.yk_edge_window_smem_bytes.restype = ctypes.c_long
        lib.yk_folded_mlp_block_max2.argtypes = [p] * 6 + [i] * 4 + [p]
        lib.yk_folded_mlp_block_max2.restype = i
        lib.yk_folded_mlp_block_max.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.yk_folded_mlp_block_max.restype = i
        lib.yk_fused_pool_train_bwd.argtypes = [p] * 11 + [i] * 5 + [p]
        lib.yk_fused_pool_train_bwd.restype = i
        lib.yk_fused_pool_train_smem_bytes.argtypes = [i]
        lib.yk_fused_pool_train_smem_bytes.restype = ctypes.c_long
        lib.yk_block_max_smem_bytes.argtypes = [i]
        lib.yk_block_max_smem_bytes.restype = ctypes.c_long
        lib.yk_ew_pair_fwd.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.yk_ew_pair_fwd.restype = i
        lib.yk_ew_pair_bwd.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.yk_ew_pair_bwd.restype = i
        lib.yk_ew_wsum_fwd.argtypes = [p] * 3 + [i] * 4 + [p]
        lib.yk_ew_wsum_fwd.restype = i
        lib.yk_ew_wsum_bwd.argtypes = [p] * 3 + [i] * 4 + [p]
        lib.yk_ew_wsum_bwd.restype = i
        lib.yk_fused_dense_message.argtypes = [p] * 11 + [i] * 6 + [p]
        lib.yk_fused_dense_message.restype = i
        lib.yk_dense_message_smem_bytes.argtypes = [i] * 2
        lib.yk_dense_message_smem_bytes.restype = ctypes.c_long
        lib.yk_banded_message_sum.argtypes = [p] * 18 + [i] * 6 + [p]
        lib.yk_banded_message_sum.restype = i
        lib.yk_banded_message_smem_bytes.argtypes = [i] * 2
        lib.yk_banded_message_smem_bytes.restype = ctypes.c_long
        lib.yk_error_string.argtypes = [i]
        lib.yk_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib, rc: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.yk_error_string(rc).decode()})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
