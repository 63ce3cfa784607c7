"""Hash-grid table-gradient scatters on the GPU (counterpart of
``ops/scatter_tpu.py``).

Each kernel replaces the Pallas kernel of the same name
(``neural_radiance_caching_tpu/ops/scatter_tpu.py``); all are instances of
one kernel body in ``csrc/scatter_weighted.cu``, templated on the update
layout:

- ``scatter_add_weighted_leveled``: updates as ``[L, P*U]`` index/weight
  rows (taps fastest) and ``[L, P, F]`` cotangents; the encoder backward at
  primary-ray point counts. With ``skip_zero_w=True`` it launches the
  instance that skips updates of weight 0, which the run-deduplicated stream
  (``hashgrid._dedup_weighted_scatter``) feeds; its launches count under
  ``"leveled_skip"``.
- ``scatter_add_weighted_planes``: updates as ``[L, U, P]`` tap planes and
  ``[L, F, P]`` cotangent planes (point axis minor); the encoder backward at
  secondary-ray fan-outs.
- ``scatter_add_rows_leveled``: the unweighted row scatter
  ``out[l, idx[l, j]] += g[l, j]`` (one tap, no weight, any row width), with
  ``scatter_add_rows_padded`` for one table.

Each source of ``_SOURCES`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface the first time a CUDA tensor reaches
a kernel (all sources at once, in parallel), and loaded with ``ctypes``. A
library is named by a hash of its source, of every ``csrc/*.cuh`` header a
source may include, and of the flags.

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
_SOURCES = ("scatter_weighted.cu",)
_WEIGHTED_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                  ctypes.c_int64, ctypes.c_void_p)
_ROWS_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p)
# Kernel name -> (source, C entry point, its argument types).
_KERNELS = {
    "leveled": ("scatter_weighted.cu", "nrc_scatter_add_weighted_leveled", _WEIGHTED_ARGS),
    "leveled_skip": ("scatter_weighted.cu", "nrc_scatter_add_weighted_leveled_skip_zero_w",
                     _WEIGHTED_ARGS),
    "planes": ("scatter_weighted.cu", "nrc_scatter_add_weighted_planes", _WEIGHTED_ARGS),
    "rows": ("scatter_weighted.cu", "nrc_scatter_add_rows_leveled", _ROWS_ARGS),
}
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# Build outputs live next to the sources, in a directory git ignores.
BUILD_DIR = _CSRC / "build"

_libs = None
_lib_lock = threading.Lock()

# Kernel launches per kernel (CUDA path only); the plain versions count nothing.
launches = {name: 0 for name in _KERNELS}


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
    digest = hashlib.sha256()
    for path in [_CSRC / source, *sorted(_CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build_library(verbose=False):
    """Compile each csrc/ source into its own shared library (cached by the
    hash of the source and the headers), all sources at once; returns
    {source: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {src: _lib_path(src) for src in _SOURCES}
    procs = {}
    for src in _SOURCES:
        if paths[src].exists():
            continue
        tmp_path = paths[src].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_find_nvcc(), *_NVCC_FLAGS, "-o", str(tmp_path), str(_CSRC / src)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[src] = (tmp_path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for src, (tmp_path, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} ({proc.returncode}):\n{out}\n{err}")
            continue
        if verbose and (out or err):
            print(out + err, flush=True)
        os.replace(tmp_path, paths[src])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load_library():
    """Build (if needed) and load the kernel libraries; raises on failure.
    Returns {kernel name: the C launch function}."""
    global _libs
    with _lib_lock:
        if _libs is None:
            libs = {src: ctypes.CDLL(str(path)) for src, path in build_library().items()}
            fns = {}
            for name, (src, entry, argtypes) in _KERNELS.items():
                fn = getattr(libs[src], entry)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                fns[name] = fn
            error_string = libs["scatter_weighted.cu"].nrc_cuda_error_string
            error_string.argtypes = [ctypes.c_int]
            error_string.restype = ctypes.c_char_p
            fns["error_string"] = error_string
            _libs = fns
        return _libs


def _launch(name, out, *args):
    """Run kernel `name` with `args` (tensors by address, then the sizes) on
    the current stream of out's device; count it."""
    fns = load_library()
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fns[name](*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} scatter kernel launch failed: "
                           f"{fns['error_string'](rc).decode()}")
    launches[name] += 1
    return out


def _index_add_rows(idx, rows, num_rows, features, keep=None):
    """[L, num_rows, F] sums of `rows` [L, N, F] at per-level rows `idx` [L, N]
    by one index_add_ on the flat table; `keep` [L, N] drops updates."""
    levels = idx.shape[0]
    offsets = torch.arange(levels, device=idx.device, dtype=torch.int64)[:, None] * num_rows
    flat_idx = (idx.to(torch.int64) + offsets).reshape(-1)
    flat_rows = rows.reshape(-1, features)
    if keep is not None:
        keep = keep.reshape(-1)
        flat_idx, flat_rows = flat_idx[keep], flat_rows[keep]
    out = torch.zeros(levels * num_rows, features, dtype=torch.float32, device=rows.device)
    out.index_add_(0, flat_idx, flat_rows)
    return out.reshape(levels, num_rows, features)


def scatter_add_weighted_leveled_plain(idx, w, ct, *, num_rows, features, corners,
                                       skip_zero_w=False):
    """Plain PyTorch version: one index_add_ of w * ct gathered per update;
    with skip_zero_w the updates of weight 0 are dropped first, so a row
    that is not finite under a weight of 0 adds nothing."""
    rows = w[..., None] * torch.repeat_interleave(ct, corners, dim=1)  # [L, N, F]
    return _index_add_rows(idx, rows, num_rows, features, keep=(w != 0) if skip_zero_w else None)


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
    _check_features(features)
    if idx.dtype != torch.int32 or w.dtype != torch.float32 or ct.dtype != torch.float32:
        raise TypeError(f"expected int32/float32/float32, got {idx.dtype}/{w.dtype}/{ct.dtype}")
    _check_devices(idx, w, ct)
    if num_rows <= 0:
        raise ValueError(f"num_rows must be positive, got {num_rows}")


def _check_features(features):
    # The kernel body holds a point's cotangent row in registers.
    if not 1 <= features <= 8:
        raise ValueError(f"features must lie in [1, 8], got {features}")


def _check_devices(*tensors):
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in tensors]}")
    if tensors[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tensors[0].device}")


def scatter_add_weighted_leveled(idx, w, ct, *, num_rows, features, corners, skip_zero_w=False):
    """Per-level weighted scatter-add:
    grads[l, idx[l, j]] += w[l, j] * ct[l, j // corners].

    Args:
      idx: [L, N] int32 row indices in [0, num_rows), N = points * corners
        (corners fastest).
      w: [L, N] float32 per-update weights.
      ct: [L, points, features] float32 per-point cotangent rows
        (1 <= features <= 8).
      skip_zero_w: skip the updates whose weight is 0 (the dedup'd stream,
        where most are).

    Returns [L, num_rows, features] float32. CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream. A row
    outside [0, num_rows) raises on both: an IndexError on the CPU, a device
    assert in the kernel that the next synchronising CUDA call raises as a
    RuntimeError.
    """
    _check_args(idx, w, ct, num_rows, features, corners)
    kw = dict(num_rows=num_rows, features=features, corners=corners, skip_zero_w=skip_zero_w)
    if idx.device.type == "cpu":
        # index_add_ on the flat [L * num_rows] table would take a row past
        # one level's end as a row of the next, so the range is checked here.
        _check_rows_cpu(idx, num_rows)
        return scatter_add_weighted_leveled_plain(idx, w, ct, **kw)
    levels, n = idx.shape
    out = torch.zeros(levels, num_rows, features, dtype=torch.float32, device=ct.device)
    return _launch("leveled_skip" if skip_zero_w else "leveled", out, idx.contiguous(),
                   w.contiguous(), ct.contiguous(), out, levels, n, corners, features, num_rows)


def _check_rows_cpu(idx, num_rows):
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= num_rows):
        raise IndexError(f"scatter row outside [0, {num_rows})")


def scatter_add_weighted_planes_plain(idx, w, ct, *, num_rows, features, corners):
    """Plain PyTorch version: one index_add_ of w * ct gathered per update."""
    del corners
    rows = w[..., None] * ct.transpose(1, 2)[:, None]  # [L, U, P, F]
    return _index_add_rows(idx.reshape(idx.shape[0], -1), rows, num_rows, features)


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
    _check_features(features)
    if idx.dtype != torch.int32 or w.dtype != torch.float32 or ct.dtype != torch.float32:
        raise TypeError(f"expected int32/float32/float32, got {idx.dtype}/{w.dtype}/{ct.dtype}")
    _check_devices(idx, w, ct)
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
    levels, _, points = idx.shape
    out = torch.zeros(levels, num_rows, features, dtype=torch.float32, device=ct.device)
    return _launch("planes", out, idx.contiguous(), w.contiguous(), ct.contiguous(), out,
                   levels, points, corners, features, num_rows)


def scatter_add_rows_leveled_plain(idx, g, *, num_rows, features):
    """Plain PyTorch version: one index_add_ of the rows."""
    return _index_add_rows(idx, g, num_rows, features)


def scatter_add_rows_leveled(idx, g, *, num_rows, features):
    """Per-level row scatter-add: out[l, idx[l, j]] += g[l, j].

    Args:
      idx: [L, N] int32 row indices in [0, num_rows); any N.
      g: [L, N, features] float32 update rows, any features >= 1 (the
        kernel takes wide rows in chunks of 8 columns; the TPU kernel's
        128-lane packing is not needed).

    Returns [L, num_rows, features] float32, for any num_rows. CPU tensors
    take the plain version; CUDA tensors launch the kernel on the current
    stream. A row outside [0, num_rows) raises on both, as in
    scatter_add_weighted_leveled.
    """
    if idx.dim() != 2:
        raise ValueError(f"idx must be [L, N], got {tuple(idx.shape)}")
    levels, n = idx.shape
    if tuple(g.shape) != (levels, n, features):
        raise ValueError(f"g must be {(levels, n, features)}, got {tuple(g.shape)}")
    if idx.dtype != torch.int32 or g.dtype != torch.float32:
        raise TypeError(f"expected int32/float32, got {idx.dtype}/{g.dtype}")
    _check_devices(idx, g)
    if num_rows <= 0:
        raise ValueError(f"num_rows must be positive, got {num_rows}")
    if idx.device.type == "cpu":
        _check_rows_cpu(idx, num_rows)
        return scatter_add_rows_leveled_plain(idx, g, num_rows=num_rows, features=features)
    out = torch.zeros(levels, num_rows, features, dtype=torch.float32, device=g.device)
    return _launch("rows", out, idx.contiguous(), g.contiguous(), out, levels, n, features,
                   num_rows)


def scatter_add_rows_padded(idx, g, *, num_rows, features):
    """Single-table row scatter-add from a contiguous [N, F] g: [num_rows, F].
    The JAX wrapper's padding of N and num_rows is TPU layout; none is
    needed here."""
    return scatter_add_rows_leveled(idx[None], g[None], num_rows=num_rows, features=features)[0]
