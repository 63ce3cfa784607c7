"""The PyTorch ops (math, coord, stepfun, linspline, ref_utils, render,
geopoly, image) held against the JAX package on numpy-seeded inputs,
values and gradients (including the custom gradients of the safe ops).

Tolerance: float32 elementwise math and short reductions agree to ~1e-6;
we use rtol 1e-5 / atol 1e-6 for values. Gradients run their reductions in
another order: rtol 1e-4 / atol 1e-5. Every atol is scaled by the largest
entry of the reference output (when above 1), since the spline integrals
reach values of ~10 and gradients of ~1e6 that cancel.

JAX splits the derivative of min/max/clip at an exact tie (0.5 to each
side) where torch gives it to one side; exact ties have measure zero on real
inputs, so gradient checks use untied inputs and ties are checked for values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_radiance_caching_tpu.ops import coord as jcoord
from neural_radiance_caching_tpu.ops import geopoly as jgeo
from neural_radiance_caching_tpu.ops import image as jimage
from neural_radiance_caching_tpu.ops import linspline as jlin
from neural_radiance_caching_tpu.ops import math as jmath
from neural_radiance_caching_tpu.ops import ref_utils as jref
from neural_radiance_caching_tpu.ops import render as jrender
from neural_radiance_caching_tpu.ops import stepfun as jstep
from neural_radiance_caching_tpu_torch.ops import coord as tcoord
from neural_radiance_caching_tpu_torch.ops import geopoly as tgeo
from neural_radiance_caching_tpu_torch.ops import image as timage
from neural_radiance_caching_tpu_torch.ops import linspline as tlin
from neural_radiance_caching_tpu_torch.ops import math as tmath
from neural_radiance_caching_tpu_torch.ops import ref_utils as tref
from neural_radiance_caching_tpu_torch.ops import render as trender
from neural_radiance_caching_tpu_torch.ops import stepfun as tstep

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)  # atol is relative to the gradient's max


def check(jfn, tfn, *arrays, grad=True, val=VAL, grad_tol=GRAD, seed=0):
    """Compare values of jfn/tfn on the same inputs and, with grad=True, the
    gradients of sum(out * r) w.r.t. every float input."""
    jout = jax.jit(jfn)(*[jnp.asarray(a) for a in arrays])
    touts = tfn(*[torch.tensor(a, requires_grad=grad and a.dtype == np.float32)
                  for a in arrays])
    jl = jout if isinstance(jout, (tuple, list)) else (jout,)
    tl = touts if isinstance(touts, (tuple, list)) else (touts,)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        j = np.asarray(j, np.float32)
        scale = max(float(np.abs(j).max()), 1.0)
        np.testing.assert_allclose(t.detach().float().numpy(), j, rtol=val["rtol"],
                                   atol=val["atol"] * scale)
    if not grad:
        return
    rng = np.random.RandomState(seed)
    rs = [rng.randn(*np.shape(j)).astype(np.float32) for j in jl]
    fidx = [i for i, a in enumerate(arrays) if a.dtype == np.float32]

    def jloss(*fl):
        args = list(jnp.asarray(a) for a in arrays)
        for i, f in zip(fidx, fl):
            args[i] = f
        out = jfn(*args)
        out = out if isinstance(out, (tuple, list)) else (out,)
        return sum(jnp.sum(o * r) for o, r in zip(out, rs))

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(len(fidx)))))(
        *[jnp.asarray(arrays[i]) for i in fidx])
    tin = [torch.tensor(a, requires_grad=a.dtype == np.float32) for a in arrays]
    tout = tfn(*tin)
    tout = tout if isinstance(tout, (tuple, list)) else (tout,)
    sum((o.float() * torch.as_tensor(r)).sum() for o, r in zip(tout, rs)).backward()
    for i, g in zip(fidx, jg):
        tg = tin[i].grad
        tg = torch.zeros_like(tin[i]) if tg is None else tg
        g = np.asarray(g)
        scale = max(float(np.abs(g).max()), 1.0)
        np.testing.assert_allclose(tg.numpy(), g, rtol=grad_tol["rtol"],
                                   atol=grad_tol["atol"] * scale)


R = np.random.RandomState(42)


def _u(shape, lo=-1.0, hi=1.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


# --- math ---------------------------------------------------------------------


def test_safe_div_value_and_custom_gradient():
    n = _u((64,), -3, 3)
    d = _u((64,), -2, 2)
    d[:8] = 0.0
    d[8:12] = 1e-39
    check(jmath.safe_div, tmath.safe_div, n, d)


@pytest.mark.parametrize("name,lo,hi", [
    ("safe_log", -1.0, 5.0), ("safe_exp", -5.0, 90.0), ("safe_sqrt", -1.0, 4.0),
    ("safe_log1p", -2.0, 3.0), ("safe_expm1", -3.0, 3.0),
])
def test_safe_fns_clip_in_forward_and_backward(name, lo, hi):
    x = _u((128,), lo, hi)
    x[:4] = 0.0
    check(getattr(jmath, name), getattr(tmath, name), x)


@pytest.mark.parametrize("name", ["plus_eps", "minus_eps", "clip_finite_nograd",
                                  "clip_pos_finite_nograd"])
def test_straight_through_ops(name):
    x = np.concatenate([_u((32,), -3, 3), np.array([0.0, 1e-40, -1e-40, 1.0], np.float32)])
    check(getattr(jmath, name), getattr(tmath, name), x)


@pytest.mark.parametrize("p", [-np.inf, -1.5, 0.0, 0.5, 1.0, 2.0, np.inf])
def test_power_ladder(p):
    x = _u((64,), -4, 4)
    check(lambda v: jmath.power_ladder(v, p), lambda v: tmath.power_ladder(v, p), x)


def test_approx_erf_and_lr_decay():
    check(jmath.approx_erf, tmath.approx_erf, _u((64,), -3, 3))
    kw = dict(lr_init=0.01, lr_final=0.001, max_steps=25000, lr_delay_steps=2500,
              lr_delay_mult=1e-8)
    for step in (0, 1, 2, 7, 100, 2499, 2500, 12345, 25000, 30000):
        want = float(jmath.learning_rate_decay(step, **kw))
        np.testing.assert_allclose(tmath.learning_rate_decay(step, **kw), want, rtol=2e-7)
    for step in (0, 10, 25000):
        kw0 = dict(kw, lr_delay_steps=0)
        np.testing.assert_allclose(tmath.learning_rate_decay(step, **kw0),
                                   float(jmath.learning_rate_decay(step, **kw0)), rtol=2e-7)


def test_sorted_lookup_searchsorted_interp():
    xp = np.sort(_u((4, 17), 0, 1), axis=-1)
    xp[:, 5] = xp[:, 4]  # repeated knots
    x = _u((4, 23), -0.2, 1.2)
    x[:, 0] = xp[:, 3]  # exact knot hits
    fp = _u((4, 17))
    (ji0, ji1), ((jf0, jf1),) = jmath.sorted_lookup(jnp.asarray(x), jnp.asarray(xp),
                                                    (jnp.asarray(fp),))
    (ti0, ti1), ((tf0, tf1),) = tmath.sorted_lookup(torch.as_tensor(x), torch.as_tensor(xp),
                                                    (torch.as_tensor(fp),))
    for a, b in ((ti0, ji0), (ti1, ji1), (tf0, jf0), (tf1, jf1)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    check(jmath.sorted_interp, tmath.sorted_interp, x, xp, fp, grad=False)
    check(jmath.interp, tmath.interp, x, xp, fp, grad=False)
    xp_untied = np.sort(_u((4, 17), 0, 1), axis=-1)
    check(jmath.sorted_interp, tmath.sorted_interp, x[:, 1:], xp_untied, fp)
    check(jmath.interp, tmath.interp, x[:, 1:], xp_untied, fp)
    v = _u((4, 9))
    idx = R.randint(0, 9, (4, 5)).astype(np.int64)
    check(lambda a, i: jmath.take_along_last(a, i), tmath.take_along_last, v, idx)


# --- coord --------------------------------------------------------------------


def _gaussians(n=24, s=5):
    means = _u((n, s, 3), -6, 6)
    means[:, 0] *= 0.1  # some inside the unit ball of contract_radius_2
    a = _u((n, s, 3, 3))
    covs = (a @ np.swapaxes(a, -1, -2) * 0.01).astype(np.float32)
    return means, covs


def test_contract_and_track_linearize():
    means, covs = _gaussians()
    check(jcoord.contract_radius_2, tcoord.contract_radius_2, means)
    check(jcoord.contract, tcoord.contract, means)
    check(lambda m, c: jcoord.track_linearize(jcoord.contract_radius_2, m, c),
          lambda m, c: tcoord.track_linearize(tcoord.contract_radius_2, m, c), means, covs)


def test_lift_ipe_and_pos_enc():
    means, covs = _gaussians()
    basis = np.ascontiguousarray(jgeo.generate_basis("icosahedron", 2).T).astype(np.float32)
    np.testing.assert_array_equal(tgeo.generate_basis("icosahedron", 2),
                                  jgeo.generate_basis("icosahedron", 2))
    check(lambda m, c, b: jcoord.lift_and_diagonalize(m, c, b), tcoord.lift_and_diagonalize,
          means, covs, basis)
    lm, lv = (np.asarray(v) for v in jcoord.lift_and_diagonalize(means, covs, basis))
    check(lambda m, v: jcoord.integrated_pos_enc(m, v, 0, 8),
          lambda m, v: tcoord.integrated_pos_enc(m, v, 0, 8), lm, lv)
    # bf16 IPE (the proposal trunks): held to bf16 resolution of the lifted
    # phase (|mean| * 2^7 ~ 1e3, whose bf16 ulp is ~4).
    jb = jcoord.integrated_pos_enc(jnp.asarray(lm), jnp.asarray(lv), 0, 8, dtype=jnp.bfloat16)
    tb = tcoord.integrated_pos_enc(torch.as_tensor(lm), torch.as_tensor(lv), 0, 8,
                                   dtype=torch.bfloat16)
    assert tb.dtype == torch.bfloat16
    np.testing.assert_allclose(tb.float().numpy(), np.asarray(jb, np.float32), atol=1e-2)
    check(lambda x: jcoord.pos_enc(x, 0, 4, True), lambda x: tcoord.pos_enc(x, 0, 4, True),
          _u((16, 3)))


def test_ray_warps_and_control_points():
    near, far = _u((8, 1), 0.5, 2), _u((8, 1), 4, 6)
    s = _u((8, 9), 0, 1)
    t2s_j, s2t_j = jcoord.construct_ray_warps(None, jnp.asarray(near), jnp.asarray(far))
    t2s_t, s2t_t = tcoord.construct_ray_warps(None, torch.as_tensor(near), torch.as_tensor(far))
    np.testing.assert_allclose(s2t_t(torch.as_tensor(s)).numpy(), np.asarray(s2t_j(s)), **VAL)
    np.testing.assert_allclose(t2s_t(torch.as_tensor(s)).numpy(), np.asarray(t2s_j(s)), **VAL)
    means, covs = _gaussians()
    jc, _ = jcoord.compute_control_points(jnp.asarray(means), jnp.asarray(covs), None, None,
                                          None, "mean", "sqrtm", 0.0)
    tc, _ = tcoord.compute_control_points(torch.as_tensor(means), torch.as_tensor(covs), None,
                                          None, None, "mean", "sqrtm", 0.0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# --- stepfun / linspline -------------------------------------------------------------


def _stepfun(n=6, k=17, pin_ends=True):
    t = np.sort(_u((n, k + 1), 0, 1), axis=-1)
    if pin_ends:
        t[:, 0], t[:, -1] = 0.0, 1.0
    w = R.rand(n, k).astype(np.float32)
    return t, (w / w.sum(-1, keepdims=True)).astype(np.float32)


def test_sampling_is_identical_without_rng():
    t, w = _stepfun()
    logits = np.log(w + 1e-5).astype(np.float32)
    check(lambda a, b: jstep.sample_intervals(None, a, b, 11, single_jitter=True,
                                              domain=(0.0, 1.0)),
          lambda a, b: tstep.sample_intervals(None, a, b, 11, single_jitter=True,
                                              domain=(0.0, 1.0)), t, logits, grad=False)
    check(jstep.integrate_weights, tstep.integrate_weights, w)
    u = np.sort(_u((6, 13), 0, 1), axis=-1)
    check(jstep.invert_cdf, tstep.invert_cdf, u, t, logits)


def test_distortion_dilation_percentiles():
    t, w = _stepfun(pin_ends=False)  # ends inside the clip domain: no ties
    check(jstep.lossfun_distortion, tstep.lossfun_distortion, t, w)
    check(lambda a, b: jstep.max_dilate_weights(a, b, 0.03, domain=(0.0, 1.0), renormalize=True),
          lambda a, b: tstep.max_dilate_weights(a, b, 0.03, domain=(0.0, 1.0), renormalize=True),
          t, w)
    check(lambda a, b: jstep.weighted_percentile(a, b, (5, 50, 95)),
          lambda a, b: tstep.weighted_percentile(a, b, (5, 50, 95)), t, w)


@pytest.mark.parametrize("blur", [0.03, 0.003])
def test_blur_and_resample_weights(blur):
    t, w = _stepfun()
    tq, _ = _stepfun(k=9)
    # The spline loss uses this under stop-gradient: values only. Its
    # pieces' gradients are checked below.
    # Its values are differences of running integrals of a distribution of
    # total mass 1, so f32 error is absolute in that unit: atol 1e-4.
    check(lambda a, b, c: jstep.blur_and_resample_weights(a, b, c, blur),
          lambda a, b, c: tstep.blur_and_resample_weights(a, b, c, blur), tq, t, w,
          val=dict(rtol=1e-4, atol=1e-4), grad=False)
    # The blurred spline is a running sum of ramp slopes ~1/blur in size:
    # its f32 error is ~1e-4 of its largest value.
    spline_tol = dict(rtol=1e-4, atol=1e-4)
    p = np.asarray(jstep.weight_to_pdf(t, w))
    check(lambda a, b: jlin.blur_stepfun(a, b, blur), lambda a, b: tlin.blur_stepfun(a, b, blur),
          t, p, val=spline_tol, grad_tol=spline_tol)
    tl, yl = (np.asarray(v) for v in jlin.blur_stepfun(t, p, blur))
    check(jlin.compute_integral, tlin.compute_integral, tl, yl, val=spline_tol,
          grad_tol=spline_tol)
    quad = [np.asarray(v) for v in jlin.compute_integral(tl, yl)]
    check(jlin.interpolate_integral, tlin.interpolate_integral, tq, tl, *quad)


# --- ref_utils / render / image ---------------------------------------------------


def test_reflect_normalize_and_ide():
    v = _u((32, 3))
    n = _u((32, 3))
    n[:2] = 0.0  # zero vectors map to zero
    check(jref.reflect, tref.reflect, v, n)
    check(jref.l2_normalize, tref.l2_normalize, n)
    d = np.asarray(jref.l2_normalize(_u((32, 5, 3))))
    kappa = _u((32, 5, 1), 0, 1)
    # deg 5 reaches z^16 and (x + iy)^16 with Legendre coefficients of size
    # ~1e4 that cancel to outputs of size ~1: f32 rounding leaves ~1e-4 with
    # the vMF attenuation and ~4e-3 without it (the plain directional
    # encoding), in both packages, measured against a float64 evaluation.
    for deg, ide_atol, enc_atol in ((2, 1e-6, 1e-6), (5, 1e-4, 1e-2)):
        check(jref.generate_ide_fn(deg), tref.generate_ide_fn(deg), d, kappa,
              val=dict(rtol=1e-5, atol=ide_atol), grad_tol=dict(rtol=1e-4, atol=ide_atol * 10))
        check(jref.generate_dir_enc_fn(deg), tref.generate_dir_enc_fn(deg), d,
              val=dict(rtol=1e-5, atol=enc_atol), grad_tol=dict(rtol=1e-4, atol=enc_atol * 10))


@pytest.mark.parametrize("ray_shape", ["cone", "cylinder"])
@pytest.mark.parametrize("diag", [True, False])
def test_cast_rays(ray_shape, diag):
    tdist = np.sort(_u((8, 7), 2, 6), axis=-1)
    origins, dirs, radii = _u((8, 3)), _u((8, 3)), _u((8, 1), 1e-3, 1e-2)
    check(lambda *a: jrender.cast_rays(*a, ray_shape, diag=diag),
          lambda *a: trender.cast_rays(*a, ray_shape, diag=diag), tdist, origins, dirs, radii)


def test_alpha_compositing_and_volumetric_rendering():
    tdist = np.sort(_u((8, 7), 2, 6), axis=-1)
    density = _u((8, 6), 0, 3)
    dirs = _u((8, 3))
    check(jrender.compute_alpha_weights, trender.compute_alpha_weights, density, tdist, dirs)
    w = np.asarray(jrender.compute_alpha_weights(density, tdist, dirs)[0])
    rgbs, extra = _u((8, 6, 3), 0, 1), _u((8, 6, 3))

    def run(mod, rgbs_, w_, t_, extra_):
        out = mod.volumetric_rendering(rgbs_, w_, w_, t_, 1.0, False, extras={"normals": extra_})
        return tuple(out[k] for k in sorted(out))

    check(lambda *a: run(jrender, *a), lambda *a: run(trender, *a), rgbs, w, tdist, extra,
          val=dict(rtol=1e-5, atol=1e-5))
    check(jimage.linear_to_srgb, timage.linear_to_srgb, _u((64,), -0.1, 1.5))
