"""The PyTorch hash-grid encoder and its table-gradient scatter, held against
the JAX package on the same numpy-seeded inputs.

Tolerances: forward features are f32 sums of at most 8 products, so they
agree to ~1e-6 (rtol 1e-5); gradients are scatter sums taken in another
order, so they agree to 1e-4 relative (atol scaled by the gradient's size).
Integer outputs (hash rows, simplex corners) must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_radiance_caching_tpu.models import grids as jgrids
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.ops import math as jmath
from neural_radiance_caching_tpu_torch.models import grids as tgrids
from neural_radiance_caching_tpu_torch.ops import hashgrid as thash
from neural_radiance_caching_tpu_torch.ops import math as tmath
from neural_radiance_caching_tpu_torch.ops import scatter_cuda
from neural_radiance_caching_tpu_torch.utils import weights

FWD = dict(rtol=1e-5, atol=1e-6)


def _grad_close(actual, desired):
    desired = np.asarray(desired)
    scale = max(float(np.abs(desired).max()), 1e-30)
    np.testing.assert_allclose(actual, desired, rtol=1e-4, atol=1e-5 * scale)


# (grid_sizes, table_size): levels 8^3 and 16^3 fit T=4096 (dense), 32 and
# 64 are hashed; the other two layouts hold one kind of level only.
LAYOUTS = {
    "dense+hash": ((8, 16, 32, 64), 4096),
    "dense-only": ((8, 16), 4096),
    "hash-only": ((32, 64), 512),
}


def _tables(rng, grid_sizes, table_size, features):
    sizes = np.asarray(grid_sizes, np.int64)
    dense = sizes**3 <= table_size
    dense_offsets = tuple(int(o) for o in np.concatenate([[0], np.cumsum(sizes[dense] ** 3)[:-1]])) \
        if dense.any() else ()
    dense_pool = rng.randn(int((sizes[dense] ** 3).sum()), features).astype(np.float32) \
        if dense.any() else None
    hash_tables = rng.randn(int((~dense).sum()), table_size, features).astype(np.float32) \
        if (~dense).any() else None
    return dense_pool, hash_tables, dense_offsets


def _inputs(seed, layout, interpolation, with_scale, m=1, features=4, n=64):
    rng = np.random.RandomState(seed)
    grid_sizes, table_size = LAYOUTS[layout]
    dense_pool, hash_tables, dense_offsets = _tables(rng, grid_sizes, table_size, features)
    # Points slightly outside [0, 1]^3 exercise out-of-range dense corners
    # (zeroed) and negative hash corners (uint32 wraparound).
    x = rng.uniform(-0.1, 1.1, (n, m, 3)).astype(np.float32)
    x_scale = rng.uniform(0.005, 0.05, (n, m, 1)).astype(np.float32) if with_scale else None
    statics = dict(grid_sizes=grid_sizes, table_size=table_size, dense_offsets=dense_offsets,
                   multisample_reduce="mean", interpolation=interpolation)
    return x, x_scale, hash_tables, dense_pool, statics


def _t(a, grad=False):
    return None if a is None else torch.tensor(a, requires_grad=grad)


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_hash_bit_exact_with_negative_corners():
    rng = np.random.RandomState(0)
    corners = rng.randint(-(2**31), 2**31 - 1, (512, 4, 3), dtype=np.int64).astype(np.int32)
    corners[0] = [[-1, -2, -3], [0, 0, 0], [1, -1, 1], [-5, 7, 2**30]]
    corners[8:16] = rng.randint(-70, 70, (8, 4, 3))
    for table_size in (4096, 524288, 12345):
        want = np.asarray(jhash._hash_indices(jnp.asarray(corners), table_size))
        got = thash._hash_indices(torch.as_tensor(corners), table_size).numpy()
        np.testing.assert_array_equal(got, want)


def test_simplex_ties_match_exactly():
    # Fractions with every tie pattern: fx == fy, fy == fz, fx == fz, all equal.
    fr = [(0.25, 0.25, 0.5), (0.5, 0.25, 0.25), (0.25, 0.5, 0.25), (0.4, 0.4, 0.4),
          (0.0, 0.0, 0.0), (0.75, 0.5, 0.75), (0.125, 0.875, 0.125)]
    grid_sizes = (16, 32)
    x = np.array([[(c + f) / 16.0 + 0.5 / 16.0 for f, c in zip(t, (3, 5, 7))] for t in fr],
                 np.float32)
    jc, jw = jhash._corner_coords_and_weights(jnp.asarray(x), grid_sizes, "simplex")
    tc, tw = thash._corner_coords_and_weights(torch.as_tensor(x), grid_sizes, "simplex")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("interpolation", ["trilinear", "simplex"])
@pytest.mark.parametrize("with_scale", [False, True])
def test_forward_matches_xla_encoder(layout, interpolation, with_scale):
    x, xs, ht, dp, statics = _inputs(1, layout, interpolation, with_scale, m=2)
    want = jhash._multires_grid_encode_xla(
        _j(x), _j(ht), _j(dp), x_scale=_j(xs), **statics)
    got = thash.multires_grid_encode(_t(x), _t(ht), _t(dp), x_scale=_t(xs), **statics)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("interpolation", ["trilinear", "simplex"])
@pytest.mark.parametrize("with_scale", [False, True])
def test_gradients_match_jax_autodiff(layout, interpolation, with_scale):
    x, xs, ht, dp, statics = _inputs(2, layout, interpolation, with_scale, m=2)
    r = np.random.RandomState(3).randn(x.shape[0], len(statics["grid_sizes"]) * 4).astype(
        np.float32)

    def jloss(ht_, dp_, x_, xs_):
        f = jhash._multires_grid_encode_xla(x_, ht_, dp_, x_scale=xs_, **statics)
        return jnp.sum(f * r)

    argnums = tuple(i for i, a in enumerate((ht, dp, x, xs)) if a is not None)
    jgrads = jax.grad(jloss, argnums=argnums)(_j(ht), _j(dp), _j(x), _j(xs))
    tin = [_t(a, grad=True) for a in (ht, dp, x, xs)]
    f = thash.multires_grid_encode(tin[2], tin[0], tin[1], x_scale=tin[3], **statics)
    (f * torch.as_tensor(r)).sum().backward()
    for i, g in zip(argnums, jgrads):
        _grad_close(tin[i].grad.numpy(), g)


def _scatter_calls(layout):
    """(idx shape, num_rows) of every scatter made by one encoder backward."""
    calls = []

    def counting(*args, **kwargs):
        calls.append((args[0].shape, kwargs["num_rows"]))
        return scatter_cuda.scatter_add_weighted_leveled_plain(*args, **kwargs)

    x, _, ht, dp, statics = _inputs(4, layout, "simplex", False)
    tin = [_t(ht, True), _t(dp, True)]
    f = thash.multires_grid_encode(_t(x), *tin, scatter_fn=counting, **statics)
    f.sum().backward()
    for t in tin:
        if t is not None:
            assert t.grad.shape == t.shape
    return calls, len(statics["grid_sizes"]), x.shape[0] * 4


def test_kernel_backward_runs_once_per_encode():
    calls, levels, updates = _scatter_calls("dense+hash")
    # One launch over the 2 dense + 2 hash levels, 4 taps per point; the
    # 16^3 dense level is as tall as the 4096-row hash tables.
    assert calls == [(torch.Size([levels, updates]), 4096)]


@pytest.mark.parametrize("layout,num_rows", [("dense-only", 4096), ("hash-only", 512)])
def test_single_kind_layouts_scatter_once(layout, num_rows):
    # The same single launch when every level is dense (rows: the tallest
    # level) or every level is hashed (rows: T).
    calls, levels, updates = _scatter_calls(layout)
    assert calls == [(torch.Size([levels, updates]), num_rows)]


def _hash_encoding_pair(rng, **kw):
    jmod = jgrids.HashEncoding(**kw)
    tmod = tgrids.HashEncoding(**kw)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((2, 1, 3)),
                                              per_level_fn=jmath.average_across_multisamples))
    variables = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32) * 0.1, shapes)
    tmod.load_state_dict(weights.state_dict_from_jax(variables, tmod))
    return jmod, tmod, variables


@pytest.mark.parametrize("max_levels", [None, 3, 2])
def test_hash_encoding_module_with_level_clamp(max_levels):
    rng = np.random.RandomState(5)
    kw = dict(hash_map_size=4096, max_grid_size=64, min_grid_size=8, num_features=4,
              scale_supersample=1.0, interpolation="simplex", bbox_scaling=2.0)
    jmod, tmod, variables = _hash_encoding_pair(rng, **kw)
    x = rng.uniform(-2.2, 2.2, (48, 1, 3)).astype(np.float32)
    r = rng.randn(48, 16).astype(np.float32)

    def jloss(params):
        f = jmod.apply(params, jnp.asarray(x), per_level_fn=jmath.average_across_multisamples,
                       max_levels=max_levels)
        return jnp.sum(f * r), f

    (_, jf), jg = jax.value_and_grad(jloss, has_aux=True)(variables)
    tf = tmod(torch.as_tensor(x), per_level_fn=tmath.average_across_multisamples,
              max_levels=max_levels)
    np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf), **FWD)
    (tf * torch.as_tensor(r)).sum().backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in tmod.named_parameters()}
    _grad_close(grads["dense_levels"].numpy(), jg["params"]["dense_levels"])
    _grad_close(grads["hash_levels"].numpy(), jg["params"]["hash_levels"])
    if max_levels is not None:
        # Hash levels past the clamp (2 dense levels come first) get exactly
        # zero gradient.
        assert not grads["hash_levels"][max_levels - 2:].abs().sum()


@pytest.mark.slow
def test_plain_scatter_matches_pallas_interpret():
    from neural_radiance_caching_tpu.ops import scatter_tpu

    rng = np.random.RandomState(0)
    levels, points, corners, rows = 2, 64, 4, 256
    idx = rng.randint(0, rows, (levels, points * corners)).astype(np.int32)
    w = rng.rand(levels, points * corners).astype(np.float32)
    ct = rng.randn(levels, points, 4).astype(np.float32)
    tile = 4 * (128 // 4) * 2
    want = scatter_tpu.scatter_add_weighted_leveled(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(ct).reshape(2, 64 * 4 // 128, 128),
        num_rows=rows, features=4, corners=corners, tile=tile, interpret=True)
    got = scatter_cuda.scatter_add_weighted_leveled(
        torch.as_tensor(idx), torch.as_tensor(w), torch.as_tensor(ct), num_rows=rows,
        features=4, corners=corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
