"""Hash-grid table-gradient scatter on the GPU (counterpart of
``ops/scatter_tpu.py``).

``scatter_add_weighted_leveled`` replaces the Pallas kernel of the same name
(``neural_radiance_caching_tpu/ops/scatter_tpu.py``). Its CUDA source is
``csrc/scatter_weighted.cu``; it is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface the first time a CUDA tensor
reaches it, and loaded with ``ctypes``.

Dispatch is by the device of the tensors and nothing else: CPU tensors take
``scatter_add_weighted_leveled_plain`` (the ``index_add_`` reference), CUDA
tensors launch the kernel, and anything else raises. A failed build or launch
raises; nothing falls back.

The JAX kernel's 128-lane packing of the cotangents and its tile padding are
TPU layout artifacts: here the cotangent is a plain ``[L, P, F]`` tensor and
no padding is needed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("scatter_weighted.cu",)
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# Build outputs live next to the sources, in a directory git ignores.
BUILD_DIR = _CSRC / "build"

_lib = None
_lib_lock = threading.Lock()

# Kernel launches made by scatter_add_weighted_leveled (CUDA path only).
launches = 0


def reset_launch_count():
    global launches
    launches = 0


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(home) / "bin" / "nvcc"
        nvcc = str(candidate) if candidate.exists() else None
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA scatter kernel cannot be built")
    return nvcc


def build_library(verbose=False):
    """Compile csrc/ into a shared library (cached by source hash); returns its path."""
    digest = hashlib.sha256()
    for name in _SOURCES:
        digest.update((_CSRC / name).read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libnrc_scatter_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    tmp_path = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *_NVCC_FLAGS, "-o", str(tmp_path),
           *(str(_CSRC / name) for name in _SOURCES)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    if verbose and (proc.stdout or proc.stderr):
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp_path, lib_path)
    return lib_path


def load_library():
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            fn = lib.nrc_scatter_add_weighted_leveled
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                           ctypes.c_int64, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.nrc_cuda_error_string.argtypes = [ctypes.c_int]
            lib.nrc_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def scatter_add_weighted_leveled_plain(idx, w, ct, *, num_rows, features, corners):
    """Plain PyTorch version: one index_add_ of w * ct gathered per update."""
    levels, n = idx.shape
    rows = w[..., None] * torch.repeat_interleave(ct, corners, dim=1)  # [L, N, F]
    offsets = torch.arange(levels, device=idx.device, dtype=torch.int64)[:, None] * num_rows
    out = torch.zeros(levels * num_rows, features, dtype=torch.float32, device=ct.device)
    out.index_add_(0, (idx.to(torch.int64) + offsets).reshape(-1), rows.reshape(-1, features))
    return out.reshape(levels, num_rows, features)


def _check_args(idx, w, ct, num_rows, features, corners):
    if idx.dim() != 2:
        raise ValueError(f"idx must be [L, N], got {tuple(idx.shape)}")
    levels, n = idx.shape
    if n % corners:
        raise ValueError(f"N={n} must be a multiple of corners={corners}")
    if tuple(w.shape) != (levels, n):
        raise ValueError(f"w must be {(levels, n)}, got {tuple(w.shape)}")
    if tuple(ct.shape) != (levels, n // corners, features):
        raise ValueError(f"ct must be {(levels, n // corners, features)}, got {tuple(ct.shape)}")
    if idx.dtype != torch.int32 or w.dtype != torch.float32 or ct.dtype != torch.float32:
        raise TypeError(f"expected int32/float32/float32, got {idx.dtype}/{w.dtype}/{ct.dtype}")
    if not (idx.device == w.device == ct.device):
        raise ValueError(f"tensors on different devices: {idx.device}, {w.device}, {ct.device}")
    if num_rows <= 0:
        raise ValueError(f"num_rows must be positive, got {num_rows}")


def scatter_add_weighted_leveled(idx, w, ct, *, num_rows, features, corners):
    """Per-level weighted scatter-add:
    grads[l, idx[l, j]] += w[l, j] * ct[l, j // corners].

    Args:
      idx: [L, N] int32 row indices in [0, num_rows), N = points * corners
        (corners fastest).
      w: [L, N] float32 per-update weights.
      ct: [L, points, features] float32 per-point cotangent rows.

    Returns [L, num_rows, features] float32. CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream. A row
    outside [0, num_rows) raises on both: an IndexError on the CPU, a device
    assert in the kernel that the next synchronising CUDA call raises as a
    RuntimeError.
    """
    global launches
    _check_args(idx, w, ct, num_rows, features, corners)
    if idx.device.type == "cpu":
        # index_add_ on the flat [L * num_rows] table would take a row past
        # one level's end as a row of the next, so the range is checked here.
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= num_rows):
            raise IndexError(f"scatter row outside [0, {num_rows})")
        return scatter_add_weighted_leveled_plain(
            idx, w, ct, num_rows=num_rows, features=features, corners=corners)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    idx, w, ct = idx.contiguous(), w.contiguous(), ct.contiguous()
    lib = load_library()
    levels, n = idx.shape
    out = torch.zeros(levels, num_rows, features, dtype=torch.float32, device=ct.device)
    with torch.cuda.device(ct.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.nrc_scatter_add_weighted_leveled(
            idx.data_ptr(), w.data_ptr(), ct.data_ptr(), out.data_ptr(),
            levels, n, corners, features, num_rows, stream)
    if rc != 0:
        raise RuntimeError(f"scatter kernel launch failed: {lib.nrc_cuda_error_string(rc).decode()}")
    launches += 1
    return out
