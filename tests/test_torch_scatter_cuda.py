"""The table-gradient scatter wrappers (``ops/scatter_cuda.py``): the
leveled and row plain versions against a numpy one-hot sum, their argument
checks, the skip-zero-weight plain version, the kernel source and its build
key, and, on a CUDA device, every hand-written kernel (leveled, its skip
instance, planes, rows; all one body) against its plain version, on warp
patterns that reach the warp combine and the vector and scalar paths, and
the row layout at widths that take column chunks and the stride check.

This file imports no JAX, so the GPU-marked tests also run on a machine
without it: ``python -m pytest --noconftest tests/test_torch_scatter_cuda.py``.

Tolerance: the same float32 terms summed in another order (atomics vs a
matrix product or index_add_): atol 1e-5 on sums of O(10) terms of size
~1; 1e-4 for the GPU cases, whose rows sum up to a few hundred terms.
"""

import re
import shutil

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
    before = dict(scatter_cuda.launches)
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
    with pytest.raises(ValueError):  # the kernel holds at most 8 features in registers
        call(idx, w, torch.zeros(2, 64, 9), num_rows=256, features=9, corners=4)


@pytest.mark.parametrize("level,bad_row", [(0, 256), (1, -1), (1, 256)])
def test_plain_scatter_raises_on_out_of_range_row(level, bad_row):
    # Rows are per level: 256 on level 0 and -1 on level 1 would land in the
    # neighbouring level of the flat index_add_, so the wrapper checks.
    idx, w, ct = (torch.as_tensor(a) for a in _scatter_case(9))
    idx[level, 17] = bad_row
    with pytest.raises(IndexError):
        scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, num_rows=256, features=4, corners=4)


def _numpy_row_scatter(idx, g, rows):
    out = np.zeros((idx.shape[0], rows, g.shape[-1]), np.float32)
    for lv in range(idx.shape[0]):
        onehot = np.zeros((idx.shape[1], rows), np.float32)
        onehot[np.arange(idx.shape[1]), idx[lv]] = 1.0
        out[lv] = onehot.T @ g[lv]
    return out


@pytest.mark.parametrize("n,rows,features", [(1000, 77, 4), (512, 256, 1), (333, 5, 2),
                                              (500, 33, 12), (256, 16, 16)])
def test_plain_row_scatter_matches_numpy_one_hot(n, rows, features):
    # Any update count and any table height: no tile padding.
    rng = np.random.RandomState(n)
    idx = rng.randint(0, rows, (3, n)).astype(np.int32)
    g = rng.randn(3, n, features).astype(np.float32)
    before = dict(scatter_cuda.launches)
    out = scatter_cuda.scatter_add_rows_leveled(
        torch.as_tensor(idx), torch.as_tensor(g), num_rows=rows, features=features)
    np.testing.assert_allclose(out.numpy(), _numpy_row_scatter(idx, g, rows), atol=1e-5)
    single = scatter_cuda.scatter_add_rows_padded(
        torch.as_tensor(idx[1]), torch.as_tensor(g[1]), num_rows=rows, features=features)
    np.testing.assert_allclose(single.numpy(), out[1].numpy(), atol=0)
    assert scatter_cuda.launches == before


def test_row_scatter_rejects_bad_arguments():
    idx = torch.zeros(2, 16, dtype=torch.int32)
    g = torch.zeros(2, 16, 4)
    call = scatter_cuda.scatter_add_rows_leveled
    with pytest.raises(TypeError):
        call(idx.long(), g, num_rows=8, features=4)
    with pytest.raises(ValueError):
        call(idx, g[:, :-1], num_rows=8, features=4)
    with pytest.raises(ValueError):
        call(idx, g, num_rows=8, features=2)
    with pytest.raises(IndexError):
        call(idx + 8, g, num_rows=8, features=4)


def test_plain_skip_zero_w_drops_zero_weight_updates():
    # Rows that are not finite under a weight of 0 add nothing when skipped
    # (0 * nan is nan in the direct sum); the kept sum is unchanged.
    idx, w, ct = (torch.as_tensor(a) for a in _scatter_case(10, corners=1))
    w[:, ::3] = 0.0
    ct[:, ::3] = float("nan")
    kw = dict(num_rows=256, features=4, corners=1)
    skipped = scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, skip_zero_w=True, **kw)
    assert torch.isfinite(skipped).all()
    keep = (w != 0)[..., None]
    want = scatter_cuda.scatter_add_weighted_leveled(
        idx, w, torch.where(keep, ct, torch.zeros_like(ct)), **kw)
    torch.testing.assert_close(skipped, want, rtol=1e-6, atol=1e-6)
    assert not torch.isfinite(scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, **kw)).all()


def test_sources_kernels_and_entry_points_agree():
    # One source holds the body of all four kernels; each entry point is
    # defined in the source that _KERNELS names.
    assert scatter_cuda._SOURCES == ("scatter_weighted.cu",)
    assert {name: entry for name, (src, entry, _) in scatter_cuda._KERNELS.items()} == {
        "leveled": "nrc_scatter_add_weighted_leveled",
        "leveled_skip": "nrc_scatter_add_weighted_leveled_skip_zero_w",
        "planes": "nrc_scatter_add_weighted_planes",
        "rows": "nrc_scatter_add_rows_leveled"}
    assert {src for src, _, _ in scatter_cuda._KERNELS.values()} == set(scatter_cuda._SOURCES)
    for name, (src, entry, _) in scatter_cuda._KERNELS.items():
        assert re.search(rf"^int {entry}\(", (scatter_cuda._CSRC / src).read_text(), re.M), name
    assert sorted(p.name for p in scatter_cuda._CSRC.glob("*.cu")) == sorted(
        scatter_cuda._SOURCES)
    assert set(scatter_cuda.launches) == set(scatter_cuda._KERNELS)


def test_library_key_follows_headers(tmp_path, monkeypatch):
    # A second source beside the kernels' one, so that the key of each can
    # be told apart.
    csrc = tmp_path / "csrc"
    shutil.copytree(scatter_cuda._CSRC, csrc, ignore=shutil.ignore_patterns("build"))
    (csrc / "other.cu").write_text("// another source\n")
    monkeypatch.setattr(scatter_cuda, "_CSRC", csrc)
    monkeypatch.setattr(scatter_cuda, "_SOURCES", (*scatter_cuda._SOURCES, "other.cu"))

    def keys():
        return {src: scatter_cuda._lib_path(src) for src in scatter_cuda._SOURCES}

    before = keys()
    assert keys() == before
    assert len(set(before.values())) == 2
    # A header that a source may include changes every library's key.
    (csrc / "shared.cuh").write_text("// v1\n")
    v1 = keys()
    (csrc / "shared.cuh").write_text("// v2\n")
    v2 = keys()
    for src in scatter_cuda._SOURCES:
        assert len({before[src], v1[src], v2[src]}) == 3
    # A source's own edit changes its key alone.
    other = csrc / "other.cu"
    other.write_text(other.read_text() + "// changed\n")
    after = keys()
    assert after["other.cu"] != v2["other.cu"]
    assert after["scatter_weighted.cu"] == v2["scatter_weighted.cu"]


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
    before = scatter_cuda.launches["leveled"]
    got = scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, **kw)
    torch.cuda.synchronize()
    assert scatter_cuda.launches["leveled"] == before + 1
    want = scatter_cuda.scatter_add_weighted_leveled_plain(idx, w, ct, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("corners,features", [(4, 4), (8, 2), (4, 1)])
def test_cuda_planes_kernel_matches_plain_version(corners, features):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    idx = torch.randint(0, 128, (3, corners, 4096), generator=gen, device="cuda",
                        dtype=torch.int32)
    w = torch.rand(3, corners, 4096, generator=gen, device="cuda")
    ct = torch.randn(3, features, 4096, generator=gen, device="cuda")
    kw = dict(num_rows=128, features=features, corners=corners)
    before = scatter_cuda.launches["planes"]
    got = scatter_cuda.scatter_add_weighted_planes(idx, w, ct, **kw)
    torch.cuda.synchronize()
    assert scatter_cuda.launches["planes"] == before + 1
    want = scatter_cuda.scatter_add_weighted_planes_plain(idx, w, ct, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_cuda_skip_zero_w_kernel_matches_plain_version():
    _need_cuda()
    idx, w, ct = (torch.as_tensor(a).cuda() for a in _scatter_case(
        11, levels=3, points=16384, corners=1, rows=128, features=4))
    w[:, ::3] = 0.0
    ct[:, ::3] = float("nan")  # must never reach the table
    kw = dict(num_rows=128, features=4, corners=1, skip_zero_w=True)
    before = dict(scatter_cuda.launches)
    got = scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, **kw)
    torch.cuda.synchronize()
    assert scatter_cuda.launches["leveled_skip"] == before["leveled_skip"] + 1
    assert scatter_cuda.launches["leveled"] == before["leveled"]
    want = scatter_cuda.scatter_add_weighted_leveled_plain(idx, w, ct, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("n,rows,features", [(40000, 128, 4), (12345, 77, 2),
                                              (100_003, 77, 12)])
def test_cuda_row_kernel_matches_plain_version(n, rows, features):
    # Ragged update counts, through both wrappers; F = 12 in column chunks.
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    idx = torch.randint(0, rows, (3, n), generator=gen, device="cuda", dtype=torch.int32)
    g = torch.randn(3, n, features, generator=gen, device="cuda")
    before = scatter_cuda.launches["rows"]
    got = scatter_cuda.scatter_add_rows_leveled(idx, g, num_rows=rows, features=features)
    single = scatter_cuda.scatter_add_rows_padded(idx[2], g[2], num_rows=rows, features=features)
    torch.cuda.synchronize()
    assert scatter_cuda.launches["rows"] == before + 2
    want = scatter_cuda.scatter_add_rows_leveled_plain(idx, g, num_rows=rows, features=features)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(single, want[2], rtol=1e-5, atol=1e-4)


_WARP_PATTERNS = ("one_row", "alternating", "across_warps", "random")


def _pattern_rows(pattern, points, rows, gen):
    """[points] rows following a warp pattern (warps are 32 consecutive
    points): "one_row" puts all 32 lanes of a warp on one row, "alternating"
    gives lanes rows a, b, a, b, ..., "across_warps" makes runs of 48 points,
    half of which cross a warp boundary, "random" draws rows."""
    p = torch.arange(points)
    return {"one_row": p // 32, "alternating": (p % 2) * 7, "across_warps": p // 48,
            "random": torch.randint(0, rows, (points,), generator=gen)}[pattern] % rows


def _warp_pattern_case(pattern, levels, points, corners, rows, features, seed):
    """Leveled and planes inputs of the same updates, whose rows follow a
    warp pattern (_pattern_rows) per tap slot."""
    gen = torch.Generator().manual_seed(seed)
    base = _pattern_rows(pattern, points, rows, gen)
    taps = torch.arange(corners)[:, None] * 5 + torch.arange(levels)[:, None, None]
    planes_idx = ((base[None, None] + taps) % rows).to(torch.int32)  # [L, U, P]
    planes_w = torch.rand(levels, corners, points, generator=gen)
    planes_ct = torch.randn(levels, features, points, generator=gen)
    leveled = (planes_idx.permute(0, 2, 1).reshape(levels, -1),
               planes_w.permute(0, 2, 1).reshape(levels, -1), planes_ct.permute(0, 2, 1))
    return ([t.contiguous().cuda() for t in leveled],
            [t.cuda() for t in (planes_idx, planes_w, planes_ct)])


@pytest.mark.gpu
@pytest.mark.parametrize("kind,corners,features", [
    ("leveled", 4, 1), ("leveled", 4, 2), ("leveled", 4, 4), ("leveled", 8, 4),
    ("planes", 4, 1), ("planes", 4, 2), ("planes", 4, 3), ("planes", 4, 4), ("planes", 4, 8),
    ("planes", 8, 4)])
def test_cuda_weighted_body_on_warp_patterns(kind, corners, features):
    # Each pattern reaches the warp combine (groups of equal rows in a warp;
    # "random" mostly singletons), F = 2, 4, 8 the vector atomics and F = 1,
    # 3 the scalar ones; 1000 points leave a warp with lanes past the end.
    _need_cuda()
    kernel = getattr(scatter_cuda, f"scatter_add_weighted_{kind}")
    plain = getattr(scatter_cuda, f"scatter_add_weighted_{kind}_plain")
    kw = dict(num_rows=64, features=features, corners=corners)
    for points in (4096, 1000):
        for pattern in _WARP_PATTERNS:
            leveled, planes = _warp_pattern_case(pattern, 3, points, corners, 64, features, points)
            idx, w, ct = leveled if kind == "leveled" else planes
            before = scatter_cuda.launches[kind]
            got = kernel(idx, w, ct, **kw)
            torch.cuda.synchronize()
            assert scatter_cuda.launches[kind] == before + 1
            torch.testing.assert_close(got, plain(idx, w, ct, **kw), rtol=1e-5, atol=1e-4,
                                       msg=f"{pattern}, {points} points")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["leveled", "planes"])
def test_cuda_weighted_body_on_unaligned_views(kind):
    # Contiguous views 4 bytes past an aligned start: the kernel reads them
    # with scalar loads (the output, which the wrapper allocates, stays
    # aligned for the vector atomics).
    _need_cuda()
    leveled, planes = _warp_pattern_case("across_warps", 3, 4096, 4, 64, 4, 5)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view

    idx, w, ct = (shifted(t) for t in (leveled if kind == "leveled" else planes))
    kw = dict(num_rows=64, features=4, corners=4)
    got = getattr(scatter_cuda, f"scatter_add_weighted_{kind}")(idx, w, ct, **kw)
    want = getattr(scatter_cuda, f"scatter_add_weighted_{kind}_plain")(idx, w, ct, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["one_row", "across_warps", "alternating"])
def test_cuda_skip_zero_w_with_nan_rows_inside_runs(pattern):
    # The dedup'd stream's shape (one row per update, corners 1) with every
    # third update of weight 0 and a NaN row under it, inside runs of equal
    # rows: those lanes add nothing to their run's sum.
    _need_cuda()
    (idx, w, ct), _ = _warp_pattern_case(pattern, 3, 4000, 1, 64, 4, 6)
    w[:, ::3] = 0.0
    ct[:, ::3] = float("nan")
    kw = dict(num_rows=64, features=4, corners=1, skip_zero_w=True)
    got = scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, **kw)
    want = scatter_cuda.scatter_add_weighted_leveled_plain(idx, w, ct, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def _rows_pattern_case(pattern, levels, n, rows, features, seed):
    """Row-scatter inputs idx [L, n], g [L, n, features] whose rows follow a
    warp pattern (_pattern_rows), shifted per level."""
    gen = torch.Generator().manual_seed(seed)
    base = _pattern_rows(pattern, n, rows, gen)
    idx = ((base[None] + 5 * torch.arange(levels)[:, None]) % rows).to(torch.int32)
    g = torch.randn(levels, n, features, generator=gen)
    return idx.cuda(), g.cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("features", [1, 2, 3, 4, 6, 8, 10, 12, 16])
def test_cuda_row_kernel_on_warp_patterns(features):
    # The row layout of the shared body: the warp combine on each pattern,
    # F = 2, 4, 6, 8 the vector paths, 1, 3 the scalar ones; 10, 12, 16 go in
    # column chunks of 8 (16: two full chunks; 12: a masked chunk of 4; 10:
    # a row stride that leaves odd rows unaligned for float4, so the stride
    # check must keep them scalar). 1000 updates leave a warp with lanes
    # past the end.
    _need_cuda()
    kw = dict(num_rows=64, features=features)
    for n in (4096, 1000):
        for pattern in _WARP_PATTERNS:
            idx, g = _rows_pattern_case(pattern, 3, n, 64, features, n + features)
            before = scatter_cuda.launches["rows"]
            got = scatter_cuda.scatter_add_rows_leveled(idx, g, **kw)
            torch.cuda.synchronize()
            assert scatter_cuda.launches["rows"] == before + 1
            torch.testing.assert_close(got, scatter_cuda.scatter_add_rows_leveled_plain(
                idx, g, **kw), rtol=1e-5, atol=1e-4, msg=f"{pattern}, {n} updates")


@pytest.mark.gpu
@pytest.mark.parametrize("features", [4, 6])
def test_cuda_row_kernel_on_unaligned_views(features):
    # Contiguous views 4 bytes past an aligned start: the kernel reads the
    # rows with scalar loads; the output stays aligned for the vector atomics.
    _need_cuda()
    idx, g = _rows_pattern_case("across_warps", 3, 4096, 64, features, 7)
    flat = torch.empty(g.numel() + 1, device="cuda")
    view = flat[1:].view(g.shape)
    view.copy_(g)
    assert view.is_contiguous() and view.data_ptr() % 8 != 0
    kw = dict(num_rows=64, features=features)
    torch.testing.assert_close(scatter_cuda.scatter_add_rows_leveled(idx, view, **kw),
                               scatter_cuda.scatter_add_rows_leveled_plain(idx, g, **kw),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["one_row", "across_warps", "random"])
def test_cuda_row_kernel_adds_nan_rows_as_given(pattern):
    # A row update has no weight: a NaN or inf row reaches its table row, as
    # under index_add_, and only that row, even inside a warp's combined run.
    _need_cuda()
    idx, g = _rows_pattern_case(pattern, 3, 4000, 64, 4, 8)
    g[:, 37] = float("nan")
    g[1, 1001, 2] = float("inf")
    kw = dict(num_rows=64, features=4)
    got = scatter_cuda.scatter_add_rows_leveled(idx, g, **kw)
    want = scatter_cuda.scatter_add_rows_leveled_plain(idx, g, **kw)
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and torch.isnan(want).any()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4, equal_nan=True)


_BAD_ROW_ON_CUDA = {
    "leveled": """
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
""",
    "rows": """
import torch
from neural_radiance_caching_tpu_torch.ops import scatter_cuda
idx = torch.zeros(2, 64, dtype=torch.int32, device="cuda")
idx[1, 5] = 300
scatter_cuda.scatter_add_rows_leveled(idx, torch.ones(2, 64, 4, device="cuda"), num_rows=256,
                                      features=4)
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
""",
    "planes": """
import torch
from neural_radiance_caching_tpu_torch.ops import scatter_cuda
idx = torch.zeros(2, 4, 16, dtype=torch.int32, device="cuda")
idx[1, 2, 5] = 300
w, ct = torch.ones(2, 4, 16, device="cuda"), torch.ones(2, 4, 16, device="cuda")
scatter_cuda.scatter_add_weighted_planes(idx, w, ct, num_rows=256, features=4, corners=4)
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
""",
}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(_BAD_ROW_ON_CUDA))
def test_cuda_kernel_asserts_on_out_of_range_row(kernel):
    # A device assert leaves the CUDA context unusable, so it runs in a
    # process of its own.
    import subprocess
    import sys
    from pathlib import Path

    _need_cuda()
    scatter_cuda.build_library()
    proc = subprocess.run([sys.executable, "-c", _BAD_ROW_ON_CUDA[kernel]], capture_output=True,
                          text=True, timeout=300, cwd=Path(__file__).resolve().parent.parent)
    assert "raised:" in proc.stdout, (proc.stdout, proc.stderr)
    # The device prints the failed assertion (to stdout or stderr, by driver).
    assert "row out of range" in proc.stdout + proc.stderr, (proc.stdout, proc.stderr)


@pytest.mark.gpu
def test_cuda_encoder_backward_matches_plain_backward(monkeypatch):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    grid_sizes, table_size, dense_offsets = (8, 16, 32, 64), 4096, (0, 512)
    dense = torch.randn(512 + 4096, 4, device="cuda", generator=gen).requires_grad_()
    tables = torch.randn(2, table_size, 4, device="cuda", generator=gen).requires_grad_()
    x = torch.rand(2048, 1, 3, device="cuda", generator=gen) * 1.2 - 0.1
    ct = torch.randn(2048, 16, device="cuda", generator=gen)
    threshold = hashgrid.PLANES_MIN_POINTS
    for layout in ("leveled", "planes"):
        # The planes layout is taken from PLANES_MIN_POINTS sampled points on.
        monkeypatch.setattr(hashgrid, "PLANES_MIN_POINTS", 1 if layout == "planes" else threshold)
        grads = []
        before = scatter_cuda.launches[layout]
        for fns in ((None, None), (scatter_cuda.scatter_add_weighted_leveled_plain,
                                   scatter_cuda.scatter_add_weighted_planes_plain)):
            f = hashgrid.multires_grid_encode(
                x, tables, dense, grid_sizes=grid_sizes, table_size=table_size,
                dense_offsets=dense_offsets, interpolation="simplex", scatter_fn=fns[0],
                planes_scatter_fn=fns[1])
            grads.append(torch.autograd.grad(f, (tables, dense), ct))
        assert scatter_cuda.launches[layout] == before + 1
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_cuda_dedup_encoder_backward_matches_plain_backward():
    # Ray-like points (consecutive samples close together) so runs occur; the
    # dedup'd backward launches the skip instance once and agrees with the
    # direct kernel backward and with the plain dedup backward.
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    grid_sizes, table_size, dense_offsets = (8, 16, 32, 64), 4096, (0, 512)
    dense = torch.randn(512 + 4096, 4, device="cuda", generator=gen).requires_grad_()
    tables = torch.randn(2, table_size, 4, device="cuda", generator=gen).requires_grad_()
    base = torch.rand(256, 1, 3, device="cuda", generator=gen)
    steps = torch.cumsum(torch.rand(256, 32, 3, device="cuda", generator=gen) * 0.01, dim=1)
    x = (base + steps).reshape(-1, 1, 3)
    ct = torch.randn(x.shape[0], 16, device="cuda", generator=gen)
    kw = dict(grid_sizes=grid_sizes, table_size=table_size, dense_offsets=dense_offsets,
              interpolation="simplex")
    grads = {}
    for name, dedup, fn in (("direct", False, None), ("dedup", True, None),
                            ("plain dedup", True, scatter_cuda.scatter_add_weighted_leveled_plain)):
        before = dict(scatter_cuda.launches)
        f = hashgrid.multires_grid_encode(x, tables, dense, scatter_dedup=dedup, scatter_fn=fn, **kw)
        grads[name] = torch.autograd.grad(f, (tables, dense), ct)
        launched = {k: scatter_cuda.launches[k] - before[k] for k in before}
        if fn is None:
            key = "leveled_skip" if dedup else "leveled"
            assert launched == {k: int(k == key) for k in launched}, launched
    for name in ("dedup", "plain dedup"):
        for a, b in zip(grads[name], grads["direct"]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
