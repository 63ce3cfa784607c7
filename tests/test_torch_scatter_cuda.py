"""The table-gradient scatter wrapper (``ops/scatter_cuda.py``): its plain
version against a numpy one-hot sum, its argument checks, and, on a CUDA
device, the hand-written kernel against the plain version.

This file imports no JAX, so the GPU-marked tests also run on a machine
without it: ``python -m pytest --noconftest tests/test_torch_scatter_cuda.py``.

Tolerance: the same float32 terms summed in another order (atomics vs a
matrix product or index_add_): atol 1e-5 on sums of O(10) terms of size
~1; 1e-4 for the GPU cases, whose rows sum up to a few hundred terms.
"""

import numpy as np
import pytest
import torch

from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda


def _scatter_case(seed, levels=2, points=64, corners=4, rows=256, features=4):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, rows, (levels, points * corners)).astype(np.int32)
    w = rng.rand(levels, points * corners).astype(np.float32)
    ct = rng.randn(levels, points, features).astype(np.float32)
    return idx, w, ct


def _numpy_scatter(idx, w, ct, rows, corners):
    levels, n = idx.shape
    out = np.zeros((levels, rows, ct.shape[-1]), np.float32)
    for lv in range(levels):
        onehot = np.zeros((n, rows), np.float32)
        onehot[np.arange(n), idx[lv]] = w[lv]
        out[lv] = onehot.T @ np.repeat(ct[lv], corners, axis=0)
    return out


@pytest.mark.parametrize("corners,features", [(4, 4), (8, 2), (4, 1)])
def test_plain_scatter_matches_numpy_one_hot(corners, features):
    idx, w, ct = _scatter_case(6, corners=corners, features=features)
    before = scatter_cuda.launches
    out = scatter_cuda.scatter_add_weighted_leveled(
        torch.as_tensor(idx), torch.as_tensor(w), torch.as_tensor(ct), num_rows=256,
        features=features, corners=corners)
    np.testing.assert_allclose(out.numpy(), _numpy_scatter(idx, w, ct, 256, corners), atol=1e-5)
    # CPU tensors take the plain version: no kernel launch is counted.
    assert scatter_cuda.launches == before


def test_scatter_wrapper_rejects_bad_arguments():
    idx, w, ct = (torch.as_tensor(a) for a in _scatter_case(7))
    call = scatter_cuda.scatter_add_weighted_leveled
    with pytest.raises(TypeError):
        call(idx.long(), w, ct, num_rows=256, features=4, corners=4)
    with pytest.raises(ValueError):
        call(idx, w[:, :-4], ct, num_rows=256, features=4, corners=4)
    with pytest.raises(ValueError):
        call(idx, w, ct, num_rows=256, features=2, corners=4)
    with pytest.raises(ValueError):
        call(idx.to("meta"), w.to("meta"), ct.to("meta"), num_rows=256, features=4, corners=4)


@pytest.mark.parametrize("level,bad_row", [(0, 256), (1, -1), (1, 256)])
def test_plain_scatter_raises_on_out_of_range_row(level, bad_row):
    # Rows are per level: 256 on level 0 and -1 on level 1 would land in the
    # neighbouring level of the flat index_add_, so the wrapper checks.
    idx, w, ct = (torch.as_tensor(a) for a in _scatter_case(9))
    idx[level, 17] = bad_row
    with pytest.raises(IndexError):
        scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, num_rows=256, features=4, corners=4)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("corners,features", [(4, 4), (8, 2), (4, 1)])
def test_cuda_kernel_matches_plain_version(corners, features):
    _need_cuda()
    idx, w, ct = (torch.as_tensor(a).cuda() for a in _scatter_case(
        8, levels=3, points=4096, corners=corners, rows=128, features=features))
    kw = dict(num_rows=128, features=features, corners=corners)
    before = scatter_cuda.launches
    got = scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, **kw)
    torch.cuda.synchronize()
    assert scatter_cuda.launches == before + 1
    want = scatter_cuda.scatter_add_weighted_leveled_plain(idx, w, ct, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


_BAD_ROW_ON_CUDA = """
import torch
from neural_radiance_caching_tpu_torch.ops import scatter_cuda
idx = torch.zeros(2, 64, dtype=torch.int32, device="cuda")
idx[1, 5] = 300
w, ct = torch.ones(2, 64, device="cuda"), torch.ones(2, 16, 4, device="cuda")
scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, num_rows=256, features=4, corners=4)
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
"""


@pytest.mark.gpu
def test_cuda_kernel_asserts_on_out_of_range_row():
    # A device assert leaves the CUDA context unusable, so it runs in a
    # process of its own.
    import subprocess
    import sys
    from pathlib import Path

    _need_cuda()
    scatter_cuda.build_library()
    proc = subprocess.run([sys.executable, "-c", _BAD_ROW_ON_CUDA], capture_output=True,
                          text=True, timeout=300, cwd=Path(__file__).resolve().parent.parent)
    assert "raised:" in proc.stdout, (proc.stdout, proc.stderr)
    # The device prints the failed assertion (to stdout or stderr, by driver).
    assert "row out of range" in proc.stdout + proc.stderr, (proc.stdout, proc.stderr)


@pytest.mark.gpu
def test_cuda_encoder_backward_matches_plain_backward():
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    grid_sizes, table_size, dense_offsets = (8, 16, 32, 64), 4096, (0, 512)
    dense = torch.randn(512 + 4096, 4, device="cuda", generator=gen).requires_grad_()
    tables = torch.randn(2, table_size, 4, device="cuda", generator=gen).requires_grad_()
    x = torch.rand(2048, 1, 3, device="cuda", generator=gen) * 1.2 - 0.1
    ct = torch.randn(2048, 16, device="cuda", generator=gen)
    grads = []
    for scatter_fn in (None, scatter_cuda.scatter_add_weighted_leveled_plain):
        f = hashgrid.multires_grid_encode(
            x, tables, dense, grid_sizes=grid_sizes, table_size=table_size,
            dense_offsets=dense_offsets, interpolation="simplex", scatter_fn=scatter_fn)
        grads.append(torch.autograd.grad(f, (tables, dense), ct))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
