"""Hash-grid table-gradient scatters on the GPU (counterpart of
``ops/scatter_tpu.py``).

Two kernels, each replacing the Pallas kernel of the same name
(``neural_radiance_caching_tpu/ops/scatter_tpu.py``):

- ``scatter_add_weighted_leveled`` (``csrc/scatter_weighted.cu``): updates
  as ``[L, P*U]`` index/weight rows (taps fastest) and ``[L, P, F]``
  cotangents; the encoder backward at primary-ray point counts.
- ``scatter_add_weighted_planes`` (``csrc/scatter_weighted_planes.cu``):
  updates as ``[L, U, P]`` tap planes and ``[L, F, P]`` cotangent planes
  (point axis minor); the encoder backward at secondary-ray fan-outs.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface the first time a CUDA tensor reaches a kernel (the
sources build in parallel), and loaded with ``ctypes``.

Dispatch is by the device of the tensors and nothing else: CPU tensors take
the ``*_plain`` version (an ``index_add_`` reference), CUDA tensors launch
the kernel, and anything else raises. A failed build or launch raises;
nothing falls back.

The JAX kernels' 128-lane packing of the cotangents, their banked
accumulators and their tile padding are TPU layout artifacts: here the
cotangents are plain tensors and no padding is needed.
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
# Kernel name -> its CUDA source; one shared library per source.
_SOURCES = {"leveled": "scatter_weighted.cu", "planes": "scatter_weighted_planes.cu"}
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# Build outputs live next to the sources, in a directory git ignores.
BUILD_DIR = _CSRC / "build"

_libs = None
_lib_lock = threading.Lock()

# Kernel launches per kernel (CUDA path only); the plain versions count nothing.
launches = {name: 0 for name in _SOURCES}


def reset_launch_count():
    for name in launches:
        launches[name] = 0


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(home) / "bin" / "nvcc"
        nvcc = str(candidate) if candidate.exists() else None
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA scatter kernels cannot be built")
    return nvcc


def _lib_path(source):
    digest = hashlib.sha256((_CSRC / source).read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build_library(verbose=False):
    """Compile each csrc/ source into its own shared library (cached by
    source hash), all sources at once; returns {kernel name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(src) for name, src in _SOURCES.items()}
    procs = {}
    for name, src in _SOURCES.items():
        if paths[name].exists():
            continue
        tmp_path = paths[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_find_nvcc(), *_NVCC_FLAGS, "-o", str(tmp_path), str(_CSRC / src)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (tmp_path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (tmp_path, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {_SOURCES[name]} ({proc.returncode}):\n{out}\n{err}")
            continue
        if verbose and (out or err):
            print(out + err, flush=True)
        os.replace(tmp_path, paths[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
             ctypes.c_int64, ctypes.c_void_p]


def load_library():
    """Build (if needed) and load the kernel libraries; raises on failure.
    Returns {kernel name: the C launch function}."""
    global _libs
    with _lib_lock:
        if _libs is None:
            paths = build_library()
            libs = {name: ctypes.CDLL(str(path)) for name, path in paths.items()}
            fns = {}
            for name, lib in libs.items():
                fn = getattr(lib, f"nrc_scatter_add_weighted_{name}")
                fn.argtypes = _ARGTYPES
                fn.restype = ctypes.c_int
                fns[name] = fn
            error_string = libs["leveled"].nrc_cuda_error_string
            error_string.argtypes = [ctypes.c_int]
            error_string.restype = ctypes.c_char_p
            fns["error_string"] = error_string
            _libs = fns
        return _libs


def _launch(name, out, idx, w, ct, levels, n, corners, features, num_rows):
    """Run kernel `name` on the current stream of out's device; count it."""
    fns = load_library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fns[name](idx.data_ptr(), w.data_ptr(), ct.data_ptr(), out.data_ptr(),
                       levels, n, corners, features, num_rows, stream)
    if rc != 0:
        raise RuntimeError(f"{name} scatter kernel launch failed: "
                           f"{fns['error_string'](rc).decode()}")
    launches[name] += 1
    return out


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
    _check_args(idx, w, ct, num_rows, features, corners)
    if idx.device.type == "cpu":
        # index_add_ on the flat [L * num_rows] table would take a row past
        # one level's end as a row of the next, so the range is checked here.
        _check_rows_cpu(idx, num_rows)
        return scatter_add_weighted_leveled_plain(
            idx, w, ct, num_rows=num_rows, features=features, corners=corners)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    levels, n = idx.shape
    out = torch.zeros(levels, num_rows, features, dtype=torch.float32, device=ct.device)
    return _launch("leveled", out, idx.contiguous(), w.contiguous(), ct.contiguous(),
                   levels, n, corners, features, num_rows)


def _check_rows_cpu(idx, num_rows):
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= num_rows):
        raise IndexError(f"scatter row outside [0, {num_rows})")


def scatter_add_weighted_planes_plain(idx, w, ct, *, num_rows, features, corners):
    """Plain PyTorch version: one index_add_ of w * ct gathered per update."""
    del corners
    levels = idx.shape[0]
    rows = w[..., None] * ct.transpose(1, 2)[:, None]  # [L, U, P, F]
    offsets = torch.arange(levels, device=idx.device, dtype=torch.int64)[:, None, None] * num_rows
    out = torch.zeros(levels * num_rows, features, dtype=torch.float32, device=ct.device)
    out.index_add_(0, (idx.to(torch.int64) + offsets).reshape(-1), rows.reshape(-1, features))
    return out.reshape(levels, num_rows, features)


def _check_planes_args(idx, w, ct, num_rows, features, corners):
    if idx.dim() != 3:
        raise ValueError(f"idx must be [L, U, P], got {tuple(idx.shape)}")
    levels, taps, points = idx.shape
    if taps != corners:
        raise ValueError(f"idx has {taps} taps, corners={corners}")
    if tuple(w.shape) != (levels, taps, points):
        raise ValueError(f"w must be {(levels, taps, points)}, got {tuple(w.shape)}")
    if tuple(ct.shape) != (levels, features, points):
        raise ValueError(f"ct must be {(levels, features, points)}, got {tuple(ct.shape)}")
    if not 1 <= features <= 8:
        raise ValueError(f"features must lie in [1, 8], got {features}")
    if idx.dtype != torch.int32 or w.dtype != torch.float32 or ct.dtype != torch.float32:
        raise TypeError(f"expected int32/float32/float32, got {idx.dtype}/{w.dtype}/{ct.dtype}")
    if not (idx.device == w.device == ct.device):
        raise ValueError(f"tensors on different devices: {idx.device}, {w.device}, {ct.device}")
    if num_rows <= 0:
        raise ValueError(f"num_rows must be positive, got {num_rows}")


def scatter_add_weighted_planes(idx, w, ct, *, num_rows, features, corners):
    """Per-level weighted scatter-add from tap planes:
    grads[l, idx[l, u, p]] += w[l, u, p] * ct[l, :, p].

    Args:
      idx: [L, U, P] int32 row indices in [0, num_rows), point axis minor.
      w: [L, U, P] float32 per-update weights.
      ct: [L, F, P] float32 per-point cotangent planes (1 <= F <= 8).

    Returns [L, num_rows, F] float32. CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream. A row outside
    [0, num_rows) raises on both, as in scatter_add_weighted_leveled.
    """
    _check_planes_args(idx, w, ct, num_rows, features, corners)
    if idx.device.type == "cpu":
        _check_rows_cpu(idx, num_rows)
        return scatter_add_weighted_planes_plain(
            idx, w, ct, num_rows=num_rows, features=features, corners=corners)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    levels, _, points = idx.shape
    out = torch.zeros(levels, num_rows, features, dtype=torch.float32, device=ct.device)
    return _launch("planes", out, idx.contiguous(), w.contiguous(), ct.contiguous(),
                   levels, points, corners, features, num_rows)
