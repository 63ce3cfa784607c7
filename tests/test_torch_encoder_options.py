"""The sampling and encoding options of the port's ops and grids against the
JAX package on the same numpy-seeded inputs: the 3x3 Cholesky and power
iteration, every basis of the unscented transform under both square roots,
the hexagonal multisample pattern, the ray warps, Gaussian tracking through
warps, the concat and unreduced multisample reductions of the hash-grid
encoder (concat's table gradient on the leveled scatter at any point
count), HashEncoding's scale feature, feature filter and summed levels, the
triplane and factored (TensoRF) grids, and Dense's named initializers.

Tolerances (float32):
- Closed-form values (Cholesky, sqrtm, sigma points, hexify, warps,
  isotropize, tracked covariances): rtol 1e-5, atol 1e-6; sqrtm's
  eigendecomposition reorders its sums, so its sigma points are held to
  rtol 1e-4, atol 1e-5.
- Gradients: rtol 1e-4 with an atol of 1e-5 x the largest entry (sums in
  another order); the eigendecomposition's gradient at rtol 1e-3, atol
  1e-4 x, and only where JAX's is finite (repeated eigenvalues give
  neither package a finite one).
- Encoder features: rtol 1e-5, atol 1e-6 (sums of at most 8 products);
  table and grid gradients as gradients above.
- Initializers: the empirical standard deviation of a 512 x 512 kernel
  within 3% of JAX's own draw of the same shape, and every entry within
  the bound (uniform) or two deviations (truncated normal).
"""

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_radiance_caching_tpu.models import grids as jgrids
from neural_radiance_caching_tpu.ops import coord as jcoord
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.ops import math as jmath
from neural_radiance_caching_tpu_torch.models import grids as tgrids
from neural_radiance_caching_tpu_torch.models import layers as tlayers
from neural_radiance_caching_tpu_torch.ops import coord as tcoord
from neural_radiance_caching_tpu_torch.ops import hashgrid as thash
from neural_radiance_caching_tpu_torch.ops import math as tmath
from neural_radiance_caching_tpu_torch.ops import scatter_cuda
from neural_radiance_caching_tpu_torch.utils import torchutil, weights

VAL = dict(rtol=1e-5, atol=1e-6)
EIG = dict(rtol=1e-4, atol=1e-5)


def _grad_close(actual, desired, rtol=1e-4, atol_frac=1e-5, err_msg=""):
    desired = np.asarray(desired)
    scale = max(float(np.abs(desired).max()), 1e-30)
    np.testing.assert_allclose(actual, desired, rtol=rtol, atol=atol_frac * scale,
                               err_msg=err_msg)


def _t(a, grad=False):
    return None if a is None else torch.tensor(np.asarray(a), requires_grad=grad)


def _covs(rng, n, iso=False):
    """[n, 3, 3] covariances: random SPD, or exactly isotropic."""
    if iso:
        return (np.eye(3) * rng.uniform(0.01, 0.1, (n, 1, 1))).astype(np.float32)
    a = rng.normal(size=(n, 3, 3)) * 0.2
    return (a @ np.swapaxes(a, -1, -2) + 0.01 * np.eye(3)).astype(np.float32)


class Draws:
    """One numpy stream feeding both packages' draws."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)

    def uniform(self, shape):
        return self.rng.random_sample(tuple(shape)).astype(np.float32)

    def normal(self, shape):
        return self.rng.standard_normal(tuple(shape)).astype(np.float32)


@contextlib.contextmanager
def injected(seed):
    """jax.random's uniform, normal, categorical, bernoulli and
    multivariate_normal and the port's torchutil.uniform and normal drawn
    from one numpy stream each (the same seed): categorical as Gumbel-max
    over uniform noise [..., K], bernoulli as uniform < p,
    multivariate_normal as its Cholesky factor times a normal draw, as both
    packages compute them."""
    jd, td = Draws(seed), Draws(seed)

    def initializer():
        # Flax re-traces a parameter's initializer to check its shape when
        # the model is applied; that is no draw of the model's.
        return sys._getframe(2).f_code.co_filename.endswith(os.path.join("models", "grids.py"))

    def j_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if initializer():
            return jnp.zeros(shape, dtype)
        return jnp.asarray(jd.uniform(shape) * (maxval - minval) + minval)

    def j_normal(key, shape=(), dtype=jnp.float32):
        if initializer():
            return jnp.zeros(shape, dtype)
        return jnp.asarray(jd.normal(shape))

    def j_categorical(key, logits, axis=-1, shape=None):
        lg = jnp.moveaxis(logits, axis, -1)
        shape = lg.shape[:-1] if shape is None else tuple(shape)
        u = jd.uniform(shape + (lg.shape[-1],))
        return jnp.argmax(lg + jnp.asarray(-np.log(-np.log(u))), axis=-1)

    def j_bernoulli(key, p=0.5, shape=None):
        return jnp.asarray(jd.uniform(shape) < p)

    def j_mvn(key, mean, cov, shape=None, dtype=None, method="cholesky"):
        z = jnp.asarray(jd.normal(tuple(shape) + mean.shape[-1:]))
        return mean + jnp.einsum("...ij,...j->...i", jnp.linalg.cholesky(cov), z)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", j_uniform)
        mp.setattr(jax.random, "normal", j_normal)
        mp.setattr(jax.random, "categorical", j_categorical)
        mp.setattr(jax.random, "bernoulli", j_bernoulli)
        mp.setattr(jax.random, "multivariate_normal", j_mvn)
        mp.setattr(torchutil, "uniform",
                   lambda rng, shape, device, dtype=torch.float32:
                   torch.as_tensor(td.uniform(shape), device=device).to(dtype))
        mp.setattr(torchutil, "normal",
                   lambda rng, shape, device, dtype=torch.float32:
                   torch.as_tensor(td.normal(shape), device=device).to(dtype))
        yield


# --- ops/math ------------------------------------------------------------------------------


@pytest.mark.parametrize("symmetrize", [True, False])
def test_cholesky3_and_safe_cholesky_match_jax(symmetrize):
    """Values and gradients of the closed-form 3x3 factor; a singular and a
    negative-definite input give finite, equal values in both."""
    rng = np.random.RandomState(0)
    a = _covs(rng, 16)
    a[0] = 0.0
    a[1] = -np.eye(3)
    r = rng.normal(size=a.shape).astype(np.float32)

    def jloss(x):
        return jnp.sum(jmath.safe_cholesky(x, symmetrize_input=symmetrize) * r)

    want = jmath.safe_cholesky(jnp.asarray(a), symmetrize_input=symmetrize)
    jg = jax.grad(jloss)(jnp.asarray(a))
    x = _t(a, True)
    got = tmath.safe_cholesky(x, symmetrize_input=symmetrize)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL)
    assert np.isfinite(got.detach().numpy()).all()
    (got * torch.as_tensor(r)).sum().backward()
    _grad_close(x.grad.numpy(), jg)
    np.testing.assert_allclose(tmath.cholesky3(_t(a[2:])).numpy(),
                               np.asarray(jmath.cholesky3(jnp.asarray(a[2:]))), **VAL)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_power_iteration_and_concat_match_jax(n):
    rng = np.random.RandomState(n)
    a = _covs(rng, 12)
    jval, jvec = jmath.power_iteration(jnp.asarray(a), n)
    tval, tvec = tmath.power_iteration(_t(a), n)
    np.testing.assert_allclose(tval.numpy(), np.asarray(jval), **VAL)
    np.testing.assert_allclose(tvec.numpy(), np.asarray(jvec), **VAL)
    x = rng.normal(size=(2, 5, n, 4)).astype(np.float32)
    np.testing.assert_array_equal(tmath.concat_across_multisamples(_t(x)).numpy(),
                                  np.asarray(jmath.concat_across_multisamples(jnp.asarray(x))))


# --- ops/coord: the unscented transform ------------------------------------------------------

BASES = ["mean", "random_3", "poweriter_4", "tetrahedron_1", "icosahedron_1", "octahedron_1",
         "octahedron_2", "julier", "menegaz"]


@pytest.mark.parametrize("sqrt_fn", ["sqrtm", "cholesky"])
@pytest.mark.parametrize("basis", BASES)
def test_unscented_transform_matches_jax(basis, sqrt_fn):
    """Sigma points of every basis under both square roots on [4, 5] Gaussians
    (axis -2, as the density MLPs ask), and the gradients to means and
    covariances; random_N draws the same fixed noise on every call."""
    rng = np.random.RandomState(1)
    mean = rng.normal(size=(4, 5, 3)).astype(np.float32)
    cov = _covs(rng, 20).reshape(4, 5, 3, 3)
    r = None

    def jfn(m, c):
        return jcoord.unscented_transform(m, c, basis, sqrt_fn=sqrt_fn, axis=-2)

    with injected(3):
        want = jfn(jnp.asarray(mean), jnp.asarray(cov))
    r = rng.normal(size=want.shape).astype(np.float32)
    with injected(3):
        jgm, jgc = jax.grad(lambda m, c: jnp.sum(jfn(m, c) * r), argnums=(0, 1))(
            jnp.asarray(mean), jnp.asarray(cov))
    tm, tc = _t(mean, True), _t(cov, True)
    with injected(3):
        got = tcoord.unscented_transform(tm, tc, basis, sqrt_fn=sqrt_fn, axis=-2)
    tol = EIG if sqrt_fn == "sqrtm" else VAL
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    (got * torch.as_tensor(r)).sum().backward()
    _grad_close(tm.grad.numpy(), jgm)
    if basis not in ("mean",):
        # A covariance enters as a symmetric matrix, so only the symmetric
        # part of its gradient reaches anything; JAX's eigh (and the
        # non-symmetrizing closed form) leave the rest of it asymmetric.
        rtol, atol = (1e-3, 1e-4) if sqrt_fn == "sqrtm" else (1e-4, 1e-5)
        sym = lambda g: (np.asarray(g) + np.swapaxes(np.asarray(g), -1, -2)) / 2  # noqa: E731
        _grad_close(sym(tc.grad.numpy()), sym(jgc), rtol, atol)
    if basis.startswith("random_"):
        # Without the injected stream: the same noise on every call.
        first, again = (tcoord.unscented_transform(_t(mean), _t(cov), basis, axis=-2)
                        for _ in range(2))
        np.testing.assert_array_equal(again.numpy(), first.numpy())


def test_sqrtm_on_isotropic_covariances_matches_values():
    """Exactly isotropic covariances (isotropize's) have a repeated
    eigenvalue: sqrtm's values agree, and its gradient is compared only
    where JAX's is finite."""
    rng = np.random.RandomState(2)
    cov = _covs(rng, 8, iso=True)
    want = jcoord.sqrtm(jnp.asarray(cov))
    jg = np.asarray(jax.grad(lambda c: jnp.sum(jcoord.sqrtm(c)))(jnp.asarray(cov)))
    tc = _t(cov, True)
    got = tcoord.sqrtm(tc)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **EIG)
    got.sum().backward()
    sym = lambda g: (g + np.swapaxes(g, -1, -2)) / 2  # noqa: E731
    tg, jg = sym(tc.grad.numpy()), sym(jg)
    finite = np.isfinite(jg) & np.isfinite(tg)
    if finite.any():
        np.testing.assert_allclose(tg[finite], jg[finite], rtol=1e-3, atol=1e-3)


def _hex_rays(rng, n=6, s=5):
    origins = rng.normal(size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[0] = [0.0, 0.0, 2.0]  # parallel to +z: the other perpendicular basis
    radii = rng.uniform(0.001, 0.01, (n, 1)).astype(np.float32)
    tdist = np.sort(rng.uniform(0.0, 4.0, (n, s + 1)), axis=-1).astype(np.float32)
    return origins, dirs, radii, tdist


@pytest.mark.parametrize("with_rng", [False, True])
def test_hexify_matches_jax(with_rng):
    """The hexagonal control points and their perpendicular magnitude, with
    the fair-coin flips and uniform turns of a generator (JAX's bernoulli,
    then uniform) and with the alternating flips without one."""
    rng = np.random.RandomState(4)
    o, d, r, t = _hex_rays(rng)
    with injected(8):
        jc, jp = jcoord.hexify(jax.random.PRNGKey(0) if with_rng else None,
                               origins=jnp.asarray(o), directions=jnp.asarray(d),
                               radii=jnp.asarray(r), tdist=jnp.asarray(t))
    with injected(8):
        tc, tp = tcoord.hexify(torch.Generator() if with_rng else None, origins=_t(o),
                               directions=_t(d), radii=_t(r), tdist=_t(t))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **VAL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **VAL)
    assert tuple(tc.shape) == (6, 5, 6, 3)
    b1, b2 = tcoord.construct_perp_basis(_t(d))
    j1, j2 = jcoord.construct_perp_basis(jnp.asarray(d))
    np.testing.assert_allclose(b1.numpy(), np.asarray(j1), **VAL)
    np.testing.assert_allclose(b2.numpy(), np.asarray(j2), **VAL)


@pytest.mark.parametrize("basis", ["hexify", "julier", "icosahedron_1"])
def test_compute_control_points_matches_jax(basis):
    """The control points and the scale's perpendicular magnitude
    (unscented_scale_mult > 0) of a ray batch."""
    from neural_radiance_caching_tpu.utils import pytrees as jpytrees
    from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees

    rng = np.random.RandomState(6)
    o, d, r, t = _hex_rays(rng)
    means = (o[:, None] + d[:, None] * ((t[:, :-1] + t[:, 1:]) / 2)[..., None]).astype(np.float32)
    covs = _covs(rng, 30).reshape(6, 5, 3, 3) * 0.01
    rays = dict(origins=o, directions=d, radii=r)
    jrays = jpytrees.dummy_rays(6).replace(**{k: jnp.asarray(v) for k, v in rays.items()})
    trays = tpytrees.Rays(**{f: (_t(rays[f]) if f in rays else None)
                             for f in ("origins", "directions", "radii", "viewdirs", "lights",
                                       "imageplane", "look", "up", "cam_origins", "vcam_look",
                                       "vcam_up", "vcam_origins", "lossmult", "near", "far",
                                       "cam_idx", "light_idx")})
    with injected(9):
        jc, jp = jcoord.compute_control_points(jnp.asarray(means), jnp.asarray(covs), jrays,
                                               jnp.asarray(t), jax.random.PRNGKey(0), basis,
                                               "cholesky", 0.5)
    with injected(9):
        tc, tp = tcoord.compute_control_points(_t(means), _t(covs), trays, _t(t),
                                               torch.Generator(), basis, "cholesky", 0.5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **VAL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)


# --- ops/coord: warps and tracking ---------------------------------------------------------

WARPS = {
    "piecewise": ("piecewise", "piecewise"),
    "reciprocal": (jnp.reciprocal, torch.reciprocal),
    "log": (jnp.log, torch.log),
    "sqrt": (jnp.sqrt, torch.sqrt),
    "exp": (jnp.exp, torch.exp),
}


@pytest.mark.parametrize("name", sorted(WARPS))
def test_ray_warps_without_an_inverse_match_jax(name):
    """'piecewise' and named functions whose inverse both packages pick by
    the function's name: t -> s and s -> t on the same rays."""
    rng = np.random.RandomState(7)
    near = rng.uniform(0.05, 0.5, (9, 1)).astype(np.float32)
    far = rng.uniform(1.5, 3.0, (9, 1)).astype(np.float32)
    t = rng.uniform(0.05, 1.5, (9, 4)).astype(np.float32)
    s = rng.uniform(0.0, 1.0, (9, 4)).astype(np.float32)
    jfn, tfn = WARPS[name]
    jt2s, js2t = jcoord.construct_ray_warps(jfn, jnp.asarray(near), jnp.asarray(far))
    tt2s, ts2t = tcoord.construct_ray_warps(tfn, _t(near), _t(far))
    np.testing.assert_allclose(tt2s(_t(t)).numpy(), np.asarray(jt2s(jnp.asarray(t))), **VAL)
    np.testing.assert_allclose(ts2t(_t(s)).numpy(), np.asarray(js2t(jnp.asarray(s))),
                               rtol=2e-5, atol=1e-6)


WARP_FNS = {
    "contract": (jcoord.contract, tcoord.contract),
    "contract_radius_2": (jcoord.contract_radius_2, tcoord.contract_radius_2),
    "contract_cube_2": (jcoord.contract_cube_2, tcoord.contract_cube_2),
    "contract_projective": (jcoord.contract_projective, tcoord.contract_projective),
    "power_ladder": (lambda x: jmath.power_ladder(x, -1.5, premult=2.0),
                     lambda x: tmath.power_ladder(x, -1.5, premult=2.0)),
}


@pytest.mark.parametrize("warp", sorted(WARP_FNS))
def test_track_linearize_and_isotropic_match_jax(warp):
    """Gaussians pushed through the contractions (the written-out
    Jacobians) and through warps differentiated by autograd: the means,
    the tracked covariances and isotropic scales, and the gradient of the
    tracked quantities to the means."""
    rng = np.random.RandomState(8)
    mean = rng.uniform(-4.0, 4.0, (3, 7, 3)).astype(np.float32)
    cov = _covs(rng, 21).reshape(3, 7, 3, 3)
    scale = rng.uniform(0.01, 0.1, (3, 7)).astype(np.float32)
    jfn, tfn = WARP_FNS[warp]
    jm, jc = jcoord.track_linearize(jfn, jnp.asarray(mean), jnp.asarray(cov))
    tm, tc = tcoord.track_linearize(tfn, _t(mean), _t(cov))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **VAL)
    _grad_close(tc.numpy(), jc, 1e-5, 1e-6)
    jm2, js = jcoord.track_isotropic(jfn, jnp.asarray(mean), jnp.asarray(scale))
    tm2, ts = tcoord.track_isotropic(tfn, _t(mean), _t(scale))
    np.testing.assert_allclose(tm2.numpy(), np.asarray(jm2), **VAL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-7)
    r = rng.normal(size=scale.shape).astype(np.float32)
    jg = jax.grad(lambda m: jnp.sum(jcoord.track_isotropic(jfn, m, jnp.asarray(scale))[1] * r))(
        jnp.asarray(mean))
    tmean = _t(mean, True)
    (tcoord.track_isotropic(tfn, tmean, _t(scale))[1] * torch.as_tensor(r)).sum().backward()
    _grad_close(tmean.grad.numpy(), jg, 1e-3, 1e-4)


@pytest.mark.parametrize("mode", ["accurate", "fast"])
def test_isotropize_and_isoscale_match_jax(mode):
    rng = np.random.RandomState(9)
    cov = _covs(rng, 10)
    cov[0] = 0.0  # singular: zero in both
    np.testing.assert_allclose(tcoord.isotropize(_t(cov), mode).numpy(),
                               np.asarray(jcoord.isotropize(jnp.asarray(cov), mode)), **VAL)
    x = rng.uniform(-3, 3, (10, 3)).astype(np.float32)
    np.testing.assert_allclose(tcoord.contract3_isoscale(_t(x)).numpy(),
                               np.asarray(jcoord.contract3_isoscale(jnp.asarray(x))), **VAL)


# --- ops/hashgrid: concat and no reduction -------------------------------------------------

GRID = dict(grid_sizes=(8, 16, 32, 64), table_size=4096, dense_offsets=(0, 512),
            interpolation="simplex")


def _grid_inputs(seed, m, with_scale=False, n=40):
    rng = np.random.RandomState(seed)
    dp = rng.randn(512 + 4096, 4).astype(np.float32)
    ht = rng.randn(2, 4096, 4).astype(np.float32)
    x = rng.uniform(-0.1, 1.1, (n, m, 3)).astype(np.float32)
    xs = rng.uniform(0.005, 0.05, (n, m, 1)).astype(np.float32) if with_scale else None
    return x, xs, ht, dp


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("m", [1, 3])
def test_concat_reduction_and_table_gradient_match_jax(m, with_scale):
    """Concat's [..., L, M*F] features and its table gradient, which runs
    the leveled scatter once even above the planes threshold (lowered here
    to 8 points), with the cotangent of each (point, multisample)."""
    x, xs, ht, dp = _grid_inputs(10 + m, m, with_scale)
    r = np.random.RandomState(1).randn(x.shape[0], 4, m * 4).astype(np.float32)

    def jloss(ht_, dp_, x_):
        f = jhash._multires_grid_encode_xla(x_, ht_, dp_, x_scale=None if xs is None else
                                            jnp.asarray(xs), multisample_reduce="concat",
                                            **GRID)
        return jnp.sum(f * r), f

    with jhash.xla_encoder_scope():
        (_, jf), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(ht), jnp.asarray(dp), jnp.asarray(x))
    calls = []

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return scatter_cuda.scatter_add_weighted_leveled_plain(*args, **kwargs)

    tht, tdp, tx = _t(ht, True), _t(dp, True), _t(x, True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(thash, "PLANES_MIN_POINTS", 8)
        tf = thash.multires_grid_encode(tx, tht, tdp, x_scale=_t(xs), multisample_reduce="concat",
                                        scatter_fn=counting, planes_scatter_fn=None, **GRID)
        assert tuple(tf.shape) == (x.shape[0], 4, m * 4)
        np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf), **VAL)
        (tf * torch.as_tensor(r)).sum().backward()
    assert calls == [torch.Size([4, x.shape[0] * m * 4])]
    for got, want, name in ((tht, jg[0], "hash"), (tdp, jg[1], "dense"), (tx, jg[2], "x")):
        _grad_close(got.grad.numpy(), want, err_msg=name)
    plain = thash.multires_grid_encode(_t(x), _t(ht), _t(dp), x_scale=_t(xs),
                                       multisample_reduce="concat", plain=True, **GRID)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jf), **VAL)


def test_no_reduction_forward_matches_jax_and_its_backward_raises():
    """multisample_reduce=None: [..., M, L*F] in both; JAX's custom VJP
    raises for it, and so does the port's backward, naming it."""
    x, _, ht, dp = _grid_inputs(20, 3)
    want = jhash._multires_grid_encode_xla(jnp.asarray(x), jnp.asarray(ht), jnp.asarray(dp),
                                           multisample_reduce=None, **GRID)
    tht = _t(ht, True)
    got = thash.multires_grid_encode(_t(x), tht, _t(dp), multisample_reduce=None, **GRID)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL)
    assert tuple(got.shape) == (x.shape[0], 3, 16)
    with pytest.raises(NotImplementedError, match="multisample_reduce=None"):
        got.sum().backward()


# --- models/grids --------------------------------------------------------------------------

HASH = dict(hash_map_size=4096, max_grid_size=64, min_grid_size=8, num_features=4,
            scale_supersample=1.0, interpolation="simplex", bbox_scaling=2.0)
PER_LEVEL = {"mean": (jmath.average_across_multisamples, tmath.average_across_multisamples),
             "concat": (jmath.concat_across_multisamples, tmath.concat_across_multisamples),
             "none": (None, None),
             "identity": (lambda v: v, lambda v: v)}


def _module_pair(jcls, tcls, rng, x, kw, call_kw=None):
    jmod = jcls(**kw)
    tmod = tcls(**kw)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                              **(call_kw or {})))
    variables = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32) * 0.1, shapes)
    tmod.load_state_dict(weights.state_dict_from_jax(variables, tmod))
    return jmod, tmod, variables


def _module_grads(jmod, tmod, variables, x, r, jkw, tkw):
    def jloss(params, x_):
        f = jmod.apply(params, x_, **jkw)
        return jnp.sum(f * r), f

    (_, jf), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        variables, jnp.asarray(x))
    tx = _t(x, True)
    tf = tmod(tx, **tkw)
    np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf), **VAL)
    (tf * torch.as_tensor(r)).sum().backward()
    for k, p in tmod.named_parameters():
        _grad_close(p.grad.numpy(), jg["params"][k], err_msg=k)
    return tx.grad.numpy(), np.asarray(jgx)


@pytest.mark.parametrize("aggregator", ["concatenate", "sum"])
@pytest.mark.parametrize("per_level", sorted(PER_LEVEL))
@pytest.mark.parametrize("append_scale", [False, True])
def test_hash_encoding_options_match_jax(append_scale, per_level, aggregator):
    """HashEncoding under each multisample reduction (the concat's scale
    feature appended per multisample), the scale feature, the feature
    filter (gating levels finer than 16) and summed levels, with a level
    clamp on the summed case: features and table gradients."""
    rng = np.random.RandomState(30)
    kw = dict(HASH, append_scale=append_scale, feature_aggregator=aggregator)
    m = 3
    x = rng.uniform(-2.2, 2.2, (2, 6, m, 3)).astype(np.float32)
    xs = rng.uniform(0.002, 0.2, (2, 6, m, 1)).astype(np.float32)
    # One filter value per output row: per point under the mean and concat,
    # per (point, multisample) without a reduction.
    filt = (rng.uniform(size=(2, 6, 1 if per_level in ("mean", "concat") else m, 1)) < 0.5)
    jfn, tfn = PER_LEVEL[per_level]
    jkw = dict(per_level_fn=jfn, x_scale=jnp.asarray(xs), feature_filter=jnp.asarray(filt),
               feature_filter_size=16, max_levels=3 if aggregator == "sum" else None)
    tkw = dict(per_level_fn=tfn, x_scale=_t(xs), feature_filter=_t(filt),
               feature_filter_size=16, max_levels=jkw["max_levels"])
    jmod, tmod, variables = _module_pair(jgrids.HashEncoding, tgrids.HashEncoding, rng, x, kw,
                                         dict(per_level_fn=jfn, x_scale=jnp.asarray(xs)))
    with jhash.xla_encoder_scope():
        out_shape = jax.eval_shape(lambda: jmod.apply(variables, jnp.asarray(x), **jkw)).shape
        r = rng.randn(*out_shape).astype(np.float32)
        gx, jgx = _module_grads(jmod, tmod, variables, x, r, jkw, tkw)
    _grad_close(gx, jgx, err_msg="x")
    if per_level == "mean" and aggregator == "concatenate":
        assert out_shape[-1] == tmod.output_dim


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_triplane_matches_jax(reduction):
    """The three planes bilinear with clamped edges (points beyond the box
    included), summed or averaged, under the mean over multisamples: the
    features, the planes' gradient and the points' gradient."""
    rng = np.random.RandomState(31)
    kw = dict(grid_size=16, num_features=6, bbox_scaling=2.0, reduction=reduction)
    x = rng.uniform(-2.6, 2.6, (5, 7, 2, 3)).astype(np.float32)
    jmod, tmod, variables = _module_pair(jgrids.Triplane, tgrids.Triplane, rng, x, kw)
    r = rng.randn(5, 7, 6).astype(np.float32)
    gx, jgx = _module_grads(jmod, tmod, variables, x, r,
                            dict(per_level_fn=jmath.average_across_multisamples),
                            dict(per_level_fn=tmath.average_across_multisamples))
    _grad_close(gx, jgx, err_msg="x")
    assert tmod.output_dim == 6


def test_factored_grid_matches_jax():
    """TensoRF's factors through map_coordinates(order=1) with corners
    outside the grid adding zero (points beyond the box included): the
    features, each factor's gradient and the points' gradient."""
    rng = np.random.RandomState(32)
    kw = dict(grid_size=12, num_features=5, num_components=4, bbox_scaling=2.0)
    x = rng.uniform(-2.5, 2.5, (6, 5, 3)).astype(np.float32)
    jmod, tmod, variables = _module_pair(jgrids.FactoredGrid, tgrids.FactoredGrid, rng, x, kw)
    r = rng.randn(6, 5, 5).astype(np.float32)
    gx, jgx = _module_grads(jmod, tmod, variables, x, r, {}, {})
    _grad_close(gx, jgx, err_msg="x")
    for cls in (tgrids.FactoredGrid, tgrids.Triplane):
        with pytest.raises(ValueError, match="x_scale"):
            cls(**({"grid_size": 4})).forward(_t(x), x_scale=_t(x[..., :1]))
    assert sorted(tgrids.GRID_REPRESENTATION_BY_NAME) == sorted(jgrids.GRID_REPRESENTATION_BY_NAME)


# --- models/layers -------------------------------------------------------------------------

INITS = ["he_uniform", "he_normal", "glorot_uniform", "glorot_normal", "lecun_uniform",
         "lecun_normal", "xavier_uniform", "xavier_normal", "kaiming_uniform", "kaiming_normal"]


@pytest.mark.parametrize("name", INITS)
def test_dense_initializers_match_jax(name):
    """Dense's kernel by each of JAX's argument-free initializers on a
    [in 384, out 512] kernel: the spread of JAX's own draw, the bound."""
    jk = np.asarray(getattr(jax.nn.initializers, name)()(jax.random.PRNGKey(0), (384, 512)))
    torch.manual_seed(0)
    tk = tlayers.Dense(384, 512, kernel_init=name).weight.detach().numpy().T
    assert tk.shape == jk.shape
    np.testing.assert_allclose(tk.std(), jk.std(), rtol=3e-2)
    assert np.abs(tk).max() <= np.abs(jk).max() * 1.03 + 1e-6
    assert abs(tk.mean()) < 0.05 * jk.std()
    with pytest.raises(ValueError, match="kernel_init"):
        tlayers.Dense(3, 4, kernel_init="orthogonal_ish")
