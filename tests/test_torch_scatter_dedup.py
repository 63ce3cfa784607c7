"""The run-dedup of the leveled table-gradient backward and the unweighted
row scatter, held against the JAX package on the CPU.

- ``hashgrid._dedup_weighted_scatter`` (plain skip-zero-weight scatter)
  against the JAX function of the same name with the Pallas skip kernel in
  interpret mode (set with ``monkeypatch``, as ``tests/test_hashgrid.py``
  runs it), on an index stream with long runs.
- The encoder backward with ``scatter_dedup=True`` against the JAX
  package's XLA autodiff table gradients (trilinear and simplex, dense and
  hash levels), on ray-like points so that runs occur.
- The plain row scatter against ``scatter_add_rows_leveled(interpret=True)``,
  at F = 4 and at F = 16.

Tolerances: the same float32 terms summed in another order (a run's
segmented scan, index_add_ or the Pallas banks): rtol/atol 1e-5 on sums of
at most a few dozen terms of size ~1; the encoder gradients rtol 1e-4 with
an atol of 1e-5 x the gradient's largest entry, as in
``tests/test_torch_hashgrid.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.ops import scatter_tpu
from neural_radiance_caching_tpu_torch.ops import hashgrid as thash
from neural_radiance_caching_tpu_torch.ops import scatter_cuda


def _runs_case(seed, levels=2, points=256, corners=4, rows=512, features=4):
    """Index columns made of runs: each base index repeated 1-9 times along
    the point axis (consecutive samples in one cell)."""
    rng = np.random.RandomState(seed)
    idx = np.empty((levels, points, corners), np.int32)
    for lv in range(levels):
        for u in range(corners):
            col = []
            while len(col) < points:
                col += [rng.randint(0, rows)] * rng.randint(1, 10)
            idx[lv, :, u] = col[:points]
    w = rng.rand(levels, points * corners).astype(np.float32)
    ct = rng.randn(levels, points, features).astype(np.float32)
    return idx.reshape(levels, points * corners), w, ct


def test_dedup_scatter_matches_jax_interpret(monkeypatch):
    idx, w, ct = _runs_case(7)
    monkeypatch.setattr(scatter_tpu, "scatter_add_weighted_leveled", functools.partial(
        scatter_tpu.scatter_add_weighted_leveled, interpret=True))
    want = jhash._dedup_weighted_scatter(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(ct),
                                         num_rows=512, f=4, corners=4, tile=128)
    calls = []

    def recording(*args, **kw):
        calls.append(kw)
        return scatter_cuda.scatter_add_weighted_leveled(*args, **kw)

    got = thash._dedup_weighted_scatter(torch.as_tensor(idx), torch.as_tensor(w),
                                        torch.as_tensor(ct), num_rows=512, features=4, corners=4,
                                        scatter_fn=recording)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert calls == [dict(num_rows=512, features=4, corners=1, skip_zero_w=True)]
    direct = scatter_cuda.scatter_add_weighted_leveled(
        *map(torch.as_tensor, (idx, w, ct)), num_rows=512, features=4, corners=4)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-5, atol=1e-5)


def test_dedup_keeps_run_ends_only():
    # Runs longer than the scan window are broken every 2**DEDUP_SCAN_STEPS
    # points; the kept updates are the run ends, and their count matches.
    points = 3 * (1 << thash.DEDUP_SCAN_STEPS) + 5
    idx = torch.zeros(1, points, dtype=torch.int32)  # one run over every point
    w = torch.ones(1, points)
    ct = torch.ones(1, points, 1)
    seen = {}

    def recording(i, keep, rows, **kw):
        seen["keep"], seen["rows"] = keep, rows
        return scatter_cuda.scatter_add_weighted_leveled(i, keep, rows, **kw)

    # corners must exceed 1 for the encoder to dedup; the function itself
    # takes any tap count, so two taps with the same single run each.
    out = thash._dedup_weighted_scatter(idx.repeat_interleave(2, dim=1),
                                        w.repeat_interleave(2, dim=1), ct, num_rows=1,
                                        features=1, corners=2, scatter_fn=recording)
    kept = torch.nonzero(seen["keep"][0]).flatten() // 2
    window = 1 << thash.DEDUP_SCAN_STEPS
    assert kept.tolist() == sorted([window - 1, 2 * window - 1, 3 * window - 1, points - 1] * 2)
    np.testing.assert_allclose(seen["rows"][0, 2 * (window - 1), 0].item(), window)
    np.testing.assert_allclose(out.item(), 2 * points)


def _encoder_case(interpolation):
    key = np.random.RandomState(31)
    grid_sizes, table_size, features = (8, 16, 32, 64), 4096, 4
    dense_offsets = (0, 512)
    dense_pool = key.randn(512 + 4096, features).astype(np.float32)
    hash_tables = key.randn(2, table_size, features).astype(np.float32)
    # Ray-like points: consecutive entries close together so runs occur.
    base = key.uniform(-0.1, 1.1, (6, 1, 3))
    steps = np.cumsum(key.uniform(0, 0.01, (6, 16, 3)), axis=1)
    x = (base + steps).reshape(96, 1, 3).astype(np.float32)
    probe = np.cos(np.arange(96 * len(grid_sizes) * features)).reshape(96, -1).astype(np.float32)
    statics = dict(grid_sizes=grid_sizes, table_size=table_size, dense_offsets=dense_offsets,
                   interpolation=interpolation)
    return x, hash_tables, dense_pool, probe, statics


@pytest.mark.parametrize("interpolation", ["trilinear", "simplex"])
def test_dedup_encoder_backward_matches_jax_autodiff(interpolation):
    x, ht, dp, probe, statics = _encoder_case(interpolation)

    def loss(ht_, dp_):
        out = jhash._multires_grid_encode_xla(jnp.asarray(x), ht_, dp_, multisample_reduce="mean",
                                              **statics)
        return (out * probe).sum()

    want_h, want_d = jax.grad(loss, argnums=(0, 1))(jnp.asarray(ht), jnp.asarray(dp))
    tht = torch.as_tensor(ht).requires_grad_()
    tdp = torch.as_tensor(dp).requires_grad_()
    calls = []

    def recording(*args, **kw):
        calls.append(kw)
        return scatter_cuda.scatter_add_weighted_leveled(*args, **kw)

    f = thash.multires_grid_encode(torch.as_tensor(x), tht, tdp, scatter_dedup=True,
                                   scatter_fn=recording, **statics)
    (f * torch.as_tensor(probe)).sum().backward()
    assert len(calls) == 1 and calls[0]["skip_zero_w"] and calls[0]["corners"] == 1
    for got, want in ((tht.grad, want_h), (tdp.grad, want_d)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_dedup_applies_to_the_leveled_backward_only(monkeypatch):
    # Like the JAX encoder: the planes layout (from PLANES_MIN_POINTS on)
    # never dedups.
    x, ht, dp, probe, statics = _encoder_case("simplex")
    seen = []

    def leveled(*args, **kw):
        seen.append("leveled" + ("_skip" if kw.get("skip_zero_w") else ""))
        return scatter_cuda.scatter_add_weighted_leveled(*args, **kw)

    def planes(*args, **kw):
        seen.append("planes")
        return scatter_cuda.scatter_add_weighted_planes(*args, **kw)

    for threshold in (thash.PLANES_MIN_POINTS, 1):
        monkeypatch.setattr(thash, "PLANES_MIN_POINTS", threshold)
        tht = torch.as_tensor(ht).requires_grad_()
        f = thash.multires_grid_encode(torch.as_tensor(x), tht, torch.as_tensor(dp),
                                       scatter_dedup=True, scatter_fn=leveled,
                                       planes_scatter_fn=planes, **statics)
        (f * torch.as_tensor(probe)).sum().backward()
    assert seen == ["leveled_skip", "planes"]


def test_plain_row_scatter_matches_jax_interpret(monkeypatch):
    key = jax.random.PRNGKey(0)
    rows, features, levels, n = 512, 4, 3, 8192
    idx = jax.random.randint(key, (levels, n), 0, rows, jnp.int32)
    g = jax.random.normal(key, (levels, n, features))
    want = scatter_tpu.scatter_add_rows_leveled(
        idx, g.reshape(levels, n * features // scatter_tpu.LANES, scatter_tpu.LANES),
        num_rows=rows, features=features, tile=1024, interpret=True)
    got = scatter_cuda.scatter_add_rows_leveled(
        torch.as_tensor(np.asarray(idx)), torch.as_tensor(np.asarray(g)), num_rows=rows,
        features=features)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    # The padded wrapper at an update count and table height that are
    # neither a tile nor a 128 / F multiple: the JAX one pads, the port's
    # needs no padding.
    monkeypatch.setattr(scatter_tpu, "scatter_add_rows_leveled", functools.partial(
        scatter_tpu.scatter_add_rows_leveled, interpret=True))
    sub_idx, sub_g = idx[0, :1000] % 77, g[0, :1000]
    want1 = scatter_tpu.scatter_add_rows_padded(sub_idx, sub_g, num_rows=77, features=features,
                                                tile=1024)
    got1 = scatter_cuda.scatter_add_rows_padded(
        torch.as_tensor(np.asarray(sub_idx)), torch.as_tensor(np.asarray(sub_g)), num_rows=77,
        features=features)
    assert tuple(got1.shape) == (77, features)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), rtol=1e-5, atol=1e-5)


def test_plain_row_scatter_matches_jax_interpret_wide_rows():
    # F = 16 divides 128 (eight rows to a 128-lane row on the TPU, so a
    # tile that is a multiple of 8; column chunks of 8 in the CUDA kernel).
    rng = np.random.RandomState(16)
    rows, features, levels, n = 64, 16, 2, 1024
    idx = rng.randint(0, rows, (levels, n)).astype(np.int32)
    g = rng.randn(levels, n, features).astype(np.float32)
    want = scatter_tpu.scatter_add_rows_leveled(
        jnp.asarray(idx), jnp.asarray(g).reshape(levels, n * features // scatter_tpu.LANES,
                                                 scatter_tpu.LANES),
        num_rows=rows, features=features, tile=256, interpret=True)
    got = scatter_cuda.scatter_add_rows_leveled(torch.as_tensor(idx), torch.as_tensor(g),
                                                num_rows=rows, features=features)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
