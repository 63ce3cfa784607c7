"""The plane-layout table-gradient scatter: its plain version against the
Pallas kernel in interpret mode and a numpy one-hot sum, the encoder's
plane-layout backward against XLA autodiff, and the layout chooser.

Tolerances: the plain version and the kernel sum the same float32 terms in
another order (atol 1e-5 on sums of O(10) terms of size ~1). Encoder table
gradients are scatter sums in another order than XLA's autodiff, as in
test_torch_hashgrid.py: rtol 1e-4 with an atol of 1e-5 x the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.ops import scatter_tpu
from neural_radiance_caching_tpu_torch.ops import hashgrid as thash
from neural_radiance_caching_tpu_torch.ops import scatter_cuda


def _planes_case(seed, levels=2, corners=4, points=256, rows=128, features=4):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, rows, (levels, corners, points)).astype(np.int32)
    w = rng.randn(levels, corners, points).astype(np.float32)
    ct = rng.randn(levels, features, points).astype(np.float32)
    return idx, w, ct


def _numpy_planes(idx, w, ct, rows):
    levels, corners, points = idx.shape
    out = np.zeros((levels, rows, ct.shape[1]), np.float32)
    for lv in range(levels):
        for u in range(corners):
            onehot = np.zeros((points, rows), np.float32)
            onehot[np.arange(points), idx[lv, u]] = w[lv, u]
            out[lv] += onehot.T @ ct[lv].T
    return out


def test_plain_planes_matches_pallas_interpret():
    idx, w, ct = _planes_case(0)
    want = scatter_tpu.scatter_add_weighted_planes(
        jnp.asarray(idx), jnp.asarray(w), jhash._pack_ct_planes(jnp.asarray(ct)), num_rows=128,
        features=4, corners=4, tile_points=256, interpret=True)
    got = scatter_cuda.scatter_add_weighted_planes(
        torch.as_tensor(idx), torch.as_tensor(w), torch.as_tensor(ct), num_rows=128, features=4,
        corners=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("corners,features", [(4, 4), (8, 2), (4, 1)])
def test_plain_planes_matches_numpy_one_hot(corners, features):
    idx, w, ct = _planes_case(1, corners=corners, features=features, points=96)
    before = dict(scatter_cuda.launches)
    out = scatter_cuda.scatter_add_weighted_planes(
        torch.as_tensor(idx), torch.as_tensor(w), torch.as_tensor(ct), num_rows=128,
        features=features, corners=corners)
    np.testing.assert_allclose(out.numpy(), _numpy_planes(idx, w, ct, 128), atol=1e-5)
    # CPU tensors take the plain version: no kernel launch is counted.
    assert scatter_cuda.launches == before


def test_planes_wrapper_rejects_bad_arguments():
    idx, w, ct = (torch.as_tensor(a) for a in _planes_case(2))
    call = scatter_cuda.scatter_add_weighted_planes
    kw = dict(num_rows=128, features=4, corners=4)
    with pytest.raises(TypeError):
        call(idx.long(), w, ct, **kw)
    with pytest.raises(ValueError):
        call(idx, w[..., :-1], ct, **kw)
    with pytest.raises(ValueError):
        call(idx, w, ct, num_rows=128, features=4, corners=8)
    with pytest.raises(ValueError):
        call(idx, w, ct.repeat(1, 3, 1), num_rows=128, features=12, corners=4)
    with pytest.raises(ValueError):
        call(idx.to("meta"), w.to("meta"), ct.to("meta"), **kw)


@pytest.mark.parametrize("level,bad_row", [(0, 128), (1, -1), (1, 128)])
def test_plain_planes_raises_on_out_of_range_row(level, bad_row):
    idx, w, ct = (torch.as_tensor(a) for a in _planes_case(3))
    idx[level, 2, 17] = bad_row
    with pytest.raises(IndexError):
        scatter_cuda.scatter_add_weighted_planes(idx, w, ct, num_rows=128, features=4, corners=4)


def test_layout_chooser_switches_at_threshold():
    assert thash.PLANES_MIN_POINTS == 1 << 20 == jhash._PLANES_MIN_POINTS
    assert not thash.use_planes_layout((1 << 20) - 1, "mean")
    assert thash.use_planes_layout(1 << 20, "mean")
    assert thash.use_planes_layout(1536 * 32 * 32, "mean")
    assert not thash.use_planes_layout(1 << 22, "concat")


def _encoder_inputs(seed, m, interpolation, features=4, n=40):
    rng = np.random.RandomState(seed)
    grid_sizes, table_size = (8, 16, 32, 64), 4096  # two dense levels, two hashed
    dense_pool = rng.randn(8**3 + 16**3, features).astype(np.float32)
    hash_tables = rng.randn(2, table_size, features).astype(np.float32)
    x = rng.uniform(-0.1, 1.1, (n, m, 3)).astype(np.float32)
    x_scale = rng.uniform(0.005, 0.05, (n, m, 1)).astype(np.float32)
    statics = dict(grid_sizes=grid_sizes, table_size=table_size, dense_offsets=(0, 8**3),
                   multisample_reduce="mean", interpolation=interpolation)
    r = rng.randn(n, len(grid_sizes) * features).astype(np.float32)
    return x, x_scale, hash_tables, dense_pool, statics, r


@pytest.mark.parametrize("interpolation", ["trilinear", "simplex"])
@pytest.mark.parametrize("m", [1, 3])
def test_planes_backward_matches_xla_grads(monkeypatch, interpolation, m):
    x, xs, ht, dp, statics, r = _encoder_inputs(4, m, interpolation)

    def jloss(ht_, dp_):
        f = jhash._multires_grid_encode_xla(
            jnp.asarray(x), ht_, dp_, x_scale=jnp.asarray(xs), **statics)
        return jnp.sum(f * r)

    with jhash.xla_encoder_scope():
        want_h, want_d = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(ht), jnp.asarray(dp))

    calls = []

    def counting(kind, fn):
        def wrapped(*args, **kwargs):
            calls.append((kind, tuple(args[0].shape), kwargs["num_rows"]))
            return fn(*args, **kwargs)
        return wrapped

    # Every (point, multisample) of this small batch takes the planes layout.
    monkeypatch.setattr(thash, "PLANES_MIN_POINTS", x.shape[0] * m)
    tht = torch.tensor(ht, requires_grad=True)
    tdp = torch.tensor(dp, requires_grad=True)
    f = thash.multires_grid_encode(
        torch.as_tensor(x), tht, tdp, x_scale=torch.as_tensor(xs),
        scatter_fn=counting("leveled", scatter_cuda.scatter_add_weighted_leveled),
        planes_scatter_fn=counting("planes", scatter_cuda.scatter_add_weighted_planes),
        **statics)
    (f * torch.as_tensor(r)).sum().backward()
    corners = 8 if interpolation == "trilinear" else 4
    assert calls == [("planes", (4, corners, x.shape[0] * m), 4096)]
    for got, want in ((tht.grad, want_h), (tdp.grad, want_d)):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * scale)


def test_planes_and_leveled_backwards_agree_at_threshold(monkeypatch):
    # One point short of the threshold the leveled layout runs; at it, the
    # planes layout; the two table gradients agree.
    x, xs, ht, dp, statics, r = _encoder_inputs(5, 2, "simplex")
    grads = []
    for threshold in (x.shape[0] * 2 + 1, x.shape[0] * 2):
        monkeypatch.setattr(thash, "PLANES_MIN_POINTS", threshold)
        tht = torch.tensor(ht, requires_grad=True)
        tdp = torch.tensor(dp, requires_grad=True)
        f = thash.multires_grid_encode(torch.as_tensor(x), tht, tdp, **statics)
        (f * torch.as_tensor(r)).sum().backward()
        grads.append((tht.grad, tdp.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
