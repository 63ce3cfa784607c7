"""The loss and train-step options of the port against the JAX package on the
same numpy-seeded inputs, with weights carried across by ``utils/weights.py``
and one numpy stream feeding both packages' random draws
(``test_torch_material_slice.injected``).

Function level: ``stepfun.inner_outer`` and ``lossfun_outer``, the Gaussian
pyramid ``render_utils.dtof_to_gauss``, every data loss type the port gained
(``mse_fwp``, ``rawnerf``, ``rawnerf_charb``, ``charb_clip``, the transient
RawNeRF ones with the pyramid) under each RawNeRF scaling (the rendering's,
``use_gt_rawnerf``, ``use_combined_rawnerf``, ``use_norm_rawnerf``) and the
loss clip of the debiased second estimate, the non-spline interlevel loss,
the eikonal loss, and the extra losses ``emission``, ``residual_albedo``,
``maximum_radiance``, ``normalize_weight`` and ``material_correlation`` (its
resample drawn from the shared stream). Then one narrow flagship cache step
under option set D (the rawnerf loss under the combined and norm scalings,
the non-spline interlevel loss, the eikonal loss on every level,
normalize_weight, debug_mode's statistics; one JAX step and one port step
shared by the two set-D tests) and four micro-steps of gradient
accumulation on four batches, two updates, against JAX's
``optax.MultiSteps`` (a checkpoint saved and restored after the first);
one narrow transient cache step under ``rawnerf_transient_unbiased`` with
two Gaussian scales; the material_surface_light_field_light model of the
spheres scene with the SLF variate (the pass that emits
``irradiance_cache``), whose shader results carry none in either package;
and the trainer's micro-step loop.

Tolerances (float32), as tests/test_torch_sampling_options.py states them:
- Function outputs: rtol 1e-5, atol 1e-6 (the same ops in the same order;
  the pyramid's convolution sums its taps in another order: atol 1e-5).
- Gradients: rtol 1e-3 with an atol of 1e-4 x the leaf's largest entry.
- The steps: every loss term to 1e-4 relative, every gradient leaf to a
  relative L2 of 1e-3; debug_mode's weight L2s to 1e-5 relative, its
  distance percentiles, outputs of the chain of sampler levels, as
  tests/test_torch_sampling_options.py holds those (rtol 1e-4, atol 1e-5),
  its gradient norms and maxima to 1e-3 (sums over a module in another
  order);
  the parameters after a first Adam update by exactly +-lr where the
  gradient's sign is determined (1e-6); the accumulator, the mean
  gradient of an update and Adam's first moment at the gradient
  tolerance, its second moment at twice it (a square); after a second
  update, the step within 2.5e-2 lr where both means are above 1e-2 of
  their leaf's largest entry (derived where the test makes it).
"""

import contextlib
import copy
import dataclasses
import functools
import io
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
import test_torch_cache_slice as cache_slice
import test_torch_material_slice as material_slice
import test_torch_material_trainer as material_trainer
import test_torch_sampling_options as sampling_options
import test_torch_slf_trainer as slf_trainer
import test_torch_transient_slice as transient_slice
import test_torch_trainer as trainer_test
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.models import nerf_model as jnerf
from neural_radiance_caching_tpu.models.nerf_model import NeRFModel as JNeRFModel
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.ops import render_utils as jru
from neural_radiance_caching_tpu.ops import stepfun as jstepfun
from neural_radiance_caching_tpu.parallel import extra_losses as jextra
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.parallel import mesh as jmesh
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch import flagship
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.engine import trainer as ttrainer
from neural_radiance_caching_tpu_torch.models import nerf_model as tnerf
from neural_radiance_caching_tpu_torch.ops import render_utils as tru
from neural_radiance_caching_tpu_torch.ops import stepfun as tstepfun
from neural_radiance_caching_tpu_torch.parallel import extra_losses as textra
from neural_radiance_caching_tpu_torch.parallel import losses as tlosses
from neural_radiance_caching_tpu_torch.parallel import train as ttrain
from neural_radiance_caching_tpu_torch.utils import checkpoints as tckpt
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees
from neural_radiance_caching_tpu_torch.utils import weights
from test_torch_material_slice import injected, jax_encoder_switch_restored  # noqa: F401

VAL = dict(rtol=1e-5, atol=1e-6)
TRAIN_FRAC = 0.5
_close_grad = sampling_options._close_grad


def _t(x, grad=False):
    t = torch.as_tensor(np.array(x))
    return t.requires_grad_() if grad else t


def _grads_match(jfn, tfn, arrays, r):
    """fn(*arrays) of both packages, and the gradient of sum(fn * r) to
    every array."""
    jout = jfn(*map(jnp.asarray, arrays))
    targs = [_t(a, grad=True) for a in arrays]
    tout = tfn(*targs)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **VAL)
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * r), argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    (tout * _t(r)).sum().backward()
    for i, (g, t) in enumerate(zip(jg, targs)):
        _close_grad(np.zeros_like(arrays[i]) if t.grad is None else t.grad.numpy(),
                    np.asarray(g), err_msg=str(i))


# --- ops/stepfun and ops/render_utils.dtof_to_gauss -----------------------------------------


def _stepfun(rng, lead, n, lo=0.0, hi=1.0):
    t = np.sort(rng.uniform(lo, hi, lead + (n + 1,)), axis=-1).astype(np.float32)
    w = rng.dirichlet(np.ones(n), lead).astype(np.float32)
    return t, w


def test_inner_outer_and_lossfun_outer_match_jax():
    rng = np.random.RandomState(1)
    t, w = _stepfun(rng, (6,), 9)
    t_env, w_env = _stepfun(rng, (6,), 13, -0.1, 1.1)
    for got, want in zip(tstepfun.inner_outer(_t(t), _t(t_env), _t(w_env)),
                         jstepfun.inner_outer(jnp.asarray(t), jnp.asarray(t_env),
                                              jnp.asarray(w_env))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)
    _grads_match(jstepfun.lossfun_outer, tstepfun.lossfun_outer, (t, w, t_env, w_env),
                 rng.normal(size=w.shape).astype(np.float32))


@pytest.mark.parametrize("scales", [((1.0, 1.0), (2.0, 0.5)), ((0.625, 2.0), (1.5, 1.0))])
def test_dtof_to_gauss_matches_jax(scales):
    """The pyramid at scales whose tap ranges round half to even (4 x 0.625
    = 2.5) and at integer ones, and its gradient."""
    rng = np.random.RandomState(2)
    x = rng.normal(size=(3, 4, 20, 3)).astype(np.float32)
    jfn = functools.partial(jru.dtof_to_gauss, sigma_scales=scales, constant_scale=0.5)
    tfn = functools.partial(tru.dtof_to_gauss, sigma_scales=scales, constant_scale=0.5)
    out = tfn(_t(x))
    assert tuple(out.shape) == (3, 4, 20 * len(scales) + 1, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(jfn(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-5)
    r = rng.normal(size=out.shape).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jfn(a) * r))(jnp.asarray(x))
    tx = _t(x, grad=True)
    (tfn(tx) * _t(r)).sum().backward()
    _close_grad(tx.grad.numpy(), np.asarray(jg))


def test_dtof_to_gauss_longer_than_the_bins_raises_as_in_jax():
    """A filter with more taps than the transient has bins: JAX's convolve
    refuses the shapes; the port names that."""
    x = np.ones((2, 12, 3), np.float32)
    with pytest.raises(ValueError, match="smaller than the other in every dimension"):
        jru.dtof_to_gauss(jnp.asarray(x), [(2.0, 1.0)], 1.0)
    with pytest.raises(NotImplementedError, match="reference gap.*every dimension"):
        tru.dtof_to_gauss(_t(x), [(2.0, 1.0)], 1.0)


# --- parallel/losses ------------------------------------------------------------------------

SCALINGS = ["rendering", "use_gt_rawnerf", "use_combined_rawnerf", "use_norm_rawnerf"]
STEADY_TYPES = ["mse_fwp", "rawnerf", "rawnerf_unbiased", "rawnerf_charb", "charb_clip"]
TRANSIENT_TYPES = ["rawnerf_transient", "rawnerf_transient_unbiased"]


def _configs(**fields):
    jcfg = dataclasses.replace(bench._cache_config(), **fields)
    return jcfg, flagship.cache_config(**fields)


@pytest.mark.parametrize("scaling", SCALINGS)
@pytest.mark.parametrize("loss_type", STEADY_TYPES + TRANSIENT_TYPES)
def test_data_loss_types_match_jax(loss_type, scaling):
    """select_data_loss_fn of each type under each scaling (the transient
    ones with the Gaussian pyramid), on a rendering with the cache's rgb,
    and its gradient to the rendered rgb."""
    transient = loss_type in TRANSIENT_TYPES
    fields = dict(data_loss_type=loss_type, charb_padding=0.01)
    if scaling != "rendering":
        fields[scaling] = True
    if transient:
        fields.update(transient_gauss_sigma_scales=[(1.0, 1.0), (2.0, 0.5)],
                      transient_gauss_constant_scale=0.5, data_loss_gauss_mult=0.3)
    jcfg, tcfg = _configs(**fields)
    rng = np.random.RandomState(3)
    shape = (5, 24, 3) if transient else (5, 3)
    arr = {k: rng.uniform(0, 1.5, shape).astype(np.float32)
           for k in ("rgb", "rgb_nocorr", "cache_rgb", "gt", "gt_nocorr")}

    def run(pkg, rgb):
        if pkg == "jax":
            rend = {k: jnp.asarray(arr[k]) for k in ("rgb_nocorr", "cache_rgb")}
            rend["rgb"] = rgb
            return jlosses.select_data_loss_fn(jcfg, rend, jnp.asarray(arr["gt"]),
                                               jnp.asarray(arr["gt_nocorr"]), 1e-3, 1.0,
                                               transient=transient)
        rend = {k: _t(arr[k]) for k in ("rgb_nocorr", "cache_rgb")}
        rend["rgb"] = rgb
        return tlosses.select_data_loss_fn(tcfg, rend, _t(arr["gt"]), _t(arr["gt_nocorr"]), 1e-3,
                                           1.0, transient=transient)

    want = run("jax", jnp.asarray(arr["rgb"]))
    trgb = _t(arr["rgb"], grad=True)
    got = run("torch", trgb)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    r = rng.normal(size=got.shape).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(run("jax", x) * r))(jnp.asarray(arr["rgb"]))
    (got * _t(r)).sum().backward()
    _close_grad(trgb.grad.numpy(), np.asarray(jg))


def test_loss_clip_clips_the_second_estimate_as_jax():
    """compute_data_loss under use_loss_clip on a rendering with its second
    estimate and its target: both clipped, as JAX clips them."""
    fields = dict(data_loss_type="rawnerf", use_loss_clip=True, loss_clip=0.8,
                  loss_clip_min=0.1)
    jcfg, tcfg = _configs(**fields)
    rng = np.random.RandomState(4)
    arr = {k: rng.uniform(0, 1.5, (6, 3)).astype(np.float32)
           for k in ("rgb", "rgb_nocorr", "gt_nocorr", "gt")}
    lossmult = rng.uniform(0.5, 1, (6, 1)).astype(np.float32)
    jrays = dataclasses.replace(jpytrees.dummy_rays(6), lossmult=lossmult)
    trays = tpytrees.Rays(*([None] * 12), lossmult=_t(lossmult), near=None, far=None,
                          cam_idx=None, light_idx=None)
    want, _ = jlosses.compute_data_loss(
        jpytrees.Batch(rays=jrays, rgb=jnp.asarray(arr["gt"])),
        {k: jnp.asarray(arr[k]) for k in ("rgb", "rgb_nocorr", "gt_nocorr")}, jrays, jcfg,
        main=True)
    got, _ = tlosses.compute_data_loss(
        tpytrees.Batch(rays=trays, rgb=_t(arr["gt"])),
        {k: _t(arr[k]) for k in ("rgb", "rgb_nocorr", "gt_nocorr")}, trays, tcfg, main=True)
    np.testing.assert_allclose(float(got), float(want), **VAL)


def _history(rng, levels=3, b=5, n=8, normals=True):
    hist = []
    for _ in range(levels):
        t, w = _stepfun(rng, (b,), n)
        level = dict(sdist=t, weights=w, lossmult=rng.uniform(0.5, 1, (b, 1)).astype(np.float32))
        if normals:
            level["normals"] = rng.normal(size=(b, n, 3)).astype(np.float32)
        hist.append(level)
    return hist


def test_interlevel_loss_matches_jax():
    """The non-spline (mip-NeRF 360) interlevel loss of each proposal level
    and its gradient to the proposal weights; the final level's is cut."""
    rng = np.random.RandomState(5)
    hist = _history(rng, normals=False)
    cfg = types.SimpleNamespace(use_spline_interlevel_loss=False)
    mults = (0.5, 2.0)

    def jfn(w0, w1, w2):
        h = [dict(l, weights=w) for l, w in zip(hist, (w0, w1, w2))]
        return jnp.stack(jlosses.compute_interlevel_loss(
            jax.tree_util.tree_map(jnp.asarray, h), mults, None, cfg))

    def tfn(w0, w1, w2):
        h = [{k: (w if k == "weights" else _t(v)) for k, v in l.items()}
             for l, w in zip(hist, (w0, w1, w2))]
        return torch.stack(tlosses.compute_interlevel_loss(h, mults, None, cfg))

    _grads_match(jfn, tfn, [l["weights"] for l in hist], np.float32([1.0, -0.5]))


def test_eikonal_loss_matches_jax():
    rng = np.random.RandomState(6)
    hist = _history(rng)
    cfg = types.SimpleNamespace(eikonal_loss_mult=0.3, eikonal_coarse_loss_mult=0.05)

    def jfn(*normals):
        return jlosses.eikonal_loss([dict(normals=n) for n in normals], cfg)

    def tfn(*normals):
        return tlosses.eikonal_loss([dict(normals=n) for n in normals], cfg)

    _grads_match(jfn, tfn, [l["normals"] for l in hist], np.float32(1.0))
    for loss in (jlosses.eikonal_loss, tlosses.eikonal_loss):
        with pytest.raises(ValueError, match="Gradient normals cannot be None"):
            loss([dict(normals=None)], cfg)


# --- parallel/extra_losses ------------------------------------------------------------------


def _extra_inputs(rng, b=6, s=4, geometry=True):
    shader = {k: rng.uniform(0.01, 1.0, (b, s, 3)).astype(np.float32)
              for k in ("rgb", "lighting_emission", "lighting_irradiance",
                        "lighting_irradiance_nocorr", "material_residual_albedo",
                        "irradiance_cache", "material_albedo")}
    for k in ("material_roughness", "material_metalness"):
        shader[k] = rng.uniform(size=(b, s, 1)).astype(np.float32)
    shader["weights"] = rng.uniform(0.05, 1.0, (b, s)).astype(np.float32)
    shader["tdist"] = np.sort(rng.uniform(0, 4, (b, s + 1)), -1).astype(np.float32)
    shader["sdist"] = np.sort(rng.uniform(0, 1, (b, s + 1)), -1).astype(np.float32)
    shader["points"] = rng.normal(size=(b, s, 3)).astype(np.float32)
    results = dict(shader=shader, integrator=dict(cache_rgb=rng.uniform(
        0.1, 1.0, (b, 3)).astype(np.float32)))
    results["geometry"] = (dict(weights=rng.uniform(0, 1, (b, s)).astype(np.float32))
                           if geometry else None)
    return results, rng.uniform(0.5, 1.0, (b, 1)).astype(np.float32), rng.uniform(
        0, 1, (b, 3)).astype(np.float32)


def _packages(results, lossmult, rgb):
    b = lossmult.shape[0]
    jrays = dataclasses.replace(jpytrees.dummy_rays(b), lossmult=lossmult)
    trays = tpytrees.Rays(*([None] * 12), lossmult=_t(lossmult), near=None, far=None,
                          cam_idx=None, light_idx=None)
    jres = jax.tree_util.tree_map(jnp.asarray, results)
    tres = {k: ({kk: _t(vv) for kk, vv in v.items()} if isinstance(v, dict) else v)
            for k, v in results.items()}
    return (jrays, jpytrees.Batch(rays=jrays, rgb=jnp.asarray(rgb)), jres), \
        (trays, tpytrees.Batch(rays=trays, rgb=_t(rgb)), tres)


EXTRA_CASES = {
    "emission": dict(emission_zero_loss_mult=0.3, emission_constant_loss_mult=1.0),
    "residual_albedo_rawnerf": dict(data_loss_type="rawnerf_unbiased"),
    "residual_albedo_mse": dict(data_loss_type="mse_unbiased"),
    "maximum_radiance": {},
    "normalize_weight": dict(normalize_weight_loss_weight=0.5),
    "material_correlation": dict(material_correlation_weight_albedo=0.2,
                                 material_correlation_weight_other=0.1,
                                 irradiance_cache_loss_weight=0.5, whitening_loss_weight=0.3,
                                 irradiance_cache_stopgrad_weight=0.5,
                                 data_loss_type="rawnerf_unbiased"),
}
GRAD_KEYS = {"emission": "lighting_emission", "residual_albedo_rawnerf":
             "material_residual_albedo", "residual_albedo_mse": "material_residual_albedo",
             "maximum_radiance": "rgb", "material_correlation": "lighting_irradiance"}


@pytest.mark.parametrize("case", sorted(EXTRA_CASES))
def test_extra_loss_functions_match_jax(case):
    """Each extra loss on the same results (with and without a geometry
    level), and its gradient to the shader output it trains;
    normalize_weight is 0 without the weights it ties (no model emits
    them) and the tether with them; material_correlation resamples one
    point per ray from the shared stream (the model's maybe_resample)."""
    name = case.split("_rawnerf")[0].split("_mse")[0]
    jcfg, tcfg = _configs(**EXTRA_CASES[case])
    jfn, tfn = getattr(jextra, f"{name}_loss"), getattr(textra, f"{name}_loss")
    jmodel = types.SimpleNamespace(maybe_resample=functools.partial(
        jnerf.Model.maybe_resample, types.SimpleNamespace(weights_bias=0.0,
                                                          resample_argmax=False)))
    tmodel = types.SimpleNamespace(maybe_resample=functools.partial(
        tnerf.Model.maybe_resample, types.SimpleNamespace(weights_bias=0.0,
                                                          resample_argmax=False)))
    for geometry in (True, False):
        rng = np.random.RandomState(7)
        results, lossmult, rgb = _extra_inputs(rng, geometry=geometry)
        if name == "normalize_weight" and geometry:
            results["geometry"].update(weights_original=results["shader"]["weights"],
                                       weights_new=results["geometry"]["weights"])
        (jrays, jbatch, jres), (trays, tbatch, tres) = _packages(results, lossmult, rgb)
        key = GRAD_KEYS.get(case)

        def jloss(x):
            res = dict(jres, shader=dict(jres["shader"], **({key: x} if key else {})))
            return jfn(jmodel, None, jax.random.PRNGKey(0), jrays, jcfg, jbatch, res, {})

        with injected(8):
            if key:
                want, jg = jax.value_and_grad(jloss)(jres["shader"][key])
            else:
                want = jloss(None)
        tx = None
        if key:
            tx = tres["shader"][key].clone().requires_grad_()
            tres["shader"][key] = tx
        with injected(8):
            got = tfn(tmodel, torch.Generator(), trays, tcfg, tbatch, tres, {})
        if name == "normalize_weight" and not geometry:
            assert got == want == 0.0
            continue
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7, err_msg=case)
        if key:
            got.backward()
            _close_grad(tx.grad.numpy(), np.asarray(jg), err_msg=case)


def test_extra_losses_by_weight_dispatch_as_jax():
    """The losses JAX turns on by their Config weight without a name: the
    maximum radiance and the material correlation on 'main' (the latter
    on a material config), the weight tether on every output, in JAX's
    order and names; a name in no table is skipped."""
    fields = dict(maximum_radiance_loss_weight=0.5, normalize_weight_loss_weight=0.5,
                  material_correlation_weight_albedo=0.2, is_material=True,
                  extra_losses={"not_a_loss": {"main": {"mult": 1.0}}})
    jcfg, tcfg = _configs(**fields)
    rng = np.random.RandomState(9)
    results, lossmult, rgb = _extra_inputs(rng)
    (jrays, jbatch, jres), (trays, tbatch, tres) = _packages(results, lossmult, rgb)
    jmodel = types.SimpleNamespace(maybe_resample=functools.partial(
        jnerf.Model.maybe_resample, types.SimpleNamespace(weights_bias=0.0,
                                                          resample_argmax=False)))
    tmodel = types.SimpleNamespace(maybe_resample=functools.partial(
        tnerf.Model.maybe_resample, types.SimpleNamespace(weights_bias=0.0,
                                                          resample_argmax=False)))
    for out_key in ("main", "cache_main"):
        with injected(10):
            want = jextra.compute_extra_losses(jmodel, None, jax.random.PRNGKey(0), jrays, jcfg,
                                               jbatch, {out_key: jres}, out_key, {}, TRAIN_FRAC)
        with injected(10):
            got = textra.compute_extra_losses(tcfg, tbatch, trays, {out_key: tres}, out_key, {},
                                              TRAIN_FRAC, model=tmodel, rng=torch.Generator())
        assert list(got) == list(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    assert list(got) == ["cache_normalize_weight"]


# --- the narrow cache steps -----------------------------------------------------------------


def set_d(params):
    """Option set D on the narrow flagship cache params: gradient normals on
    the proposal levels too, which the eikonal loss reads."""
    p = dict(params, sampler_params=dict(params["sampler_params"]))
    sp = p["sampler_params"]
    sp["mlp_params_per_level"] = tuple(dict(m, disable_density_normals=False,
                                            normals_for_filter_only=False)
                                       for m in sp["mlp_params_per_level"])
    return p


SET_D_CONFIG = dict(data_loss_type="rawnerf", use_combined_rawnerf=True, use_norm_rawnerf=True,
                    use_spline_interlevel_loss=False, eikonal_loss_mult=0.1,
                    eikonal_coarse_loss_mult=0.01, normalize_weight_loss_weight=0.1,
                    debug_mode=True)


def build_cache(config, edit=lambda p: p, seed=0):
    """The narrow flagship cache in both packages with the same weights, and
    each package's SyntheticSpheres train split (their batches agree)."""
    common = dict(batch_size=cache_slice.BATCH, lr_delay_steps=0, **config)
    jcfg = dataclasses.replace(bench._cache_config(), **common)
    tcfg = flagship.cache_config(**common)
    jmodel = JNeRFModel(config=jcfg, **edit(cache_slice.narrow(bench.flagship_cache_params(jcfg))))
    tmodel = flagship.build_flagship_cache_model(
        tcfg, edit(cache_slice.narrow(flagship.flagship_cache_params())), device="cpu")
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))
    variables = material_slice.random_variables(shapes, seed)
    tmodel.load_state_dict(weights.state_dict_from_jax(variables, tmodel))
    jdata = cache_slice.jdatasets.SyntheticSpheres("train", None, jcfg, num_images=3,
                                                   resolution=16)
    tdata = tdatasets.SyntheticSpheres("train", None, tcfg, num_images=3, resolution=16,
                                       device="cpu")
    return jcfg, tcfg, jmodel, tmodel, variables, jdata, tdata


def _jax_train_step(jmodel, jcfg, variables):
    """The JAX package's own train step (its mesh on the CPU) and state."""
    jstate, _ = jtrain.create_optimizer(jcfg, variables)
    return jtrain.create_train_step(jmodel, jcfg), jstate


def _adam(opt_state):
    """optax's Adam moments (mu, nu) inside a train state's opt_state (under
    MultiSteps, its inner state), as host trees."""
    state = opt_state.inner_opt_state if hasattr(opt_state, "inner_opt_state") else opt_state
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return jax.device_get(adam.mu), jax.device_get(adam.nu)


DEBUG_KEYS = ("ray_normalized_distance{}", "ray_normalized_distance{}_log_delta",
              "ray_metric_distance{}_log", "ray_metric_distance{}_log_delta")


def _assert_adam_update(model, jnew, before, lr):
    """Adam's first update moves a parameter by exactly +-lr where its
    gradient's sign is determined (above 1e-3 of the leaf's largest entry,
    the update's mean gradient in the port's .grad), and by at most lr
    elsewhere."""
    moved = False
    for key, p in model.named_parameters():
        want, got = material_slice._tr(key, jnew[key]), p.detach().numpy()
        g = np.abs(p.grad.numpy())
        determined = g > 1e-3 * g.max()
        moved |= bool(determined.any())
        np.testing.assert_allclose(got[determined], want[determined], rtol=0, atol=1e-6,
                                   err_msg=key)
        assert np.all(np.abs(got - before[key].numpy()) <= lr * (1 + 1e-5) + 1e-7), key
    assert moved


@functools.lru_cache(maxsize=None)
def _set_d_run():
    """Set D once through JAX's train step and once through the port's, for
    the file's two set-D tests: each package's stats, printed lines and
    state after the step, the port's model (its .grad the step's cleaned
    gradient) and its parameters before the step."""
    jcfg, tcfg, jmodel, tmodel, variables, jdata, tdata = build_cache(SET_D_CONFIG, set_d)
    jbatch, tbatch = jdata.next_train(), tdata.next_train()
    jstep, jstate = _jax_train_step(jmodel, jcfg, variables)
    jprinted, tprinted = io.StringIO(), io.StringIO()
    with injected(51), jhash.xla_encoder_scope(), contextlib.redirect_stdout(jprinted):
        jstate, jstats = jstep(jax.random.PRNGKey(0), jstate, jbatch, TRAIN_FRAC)
        jstats = jax.device_get(jstats)
        jax.effects_barrier()
    before = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    state, _ = ttrain.create_optimizer(tcfg, tmodel)
    step = ttrain.create_train_step(tmodel, tcfg)
    with injected(51), contextlib.redirect_stdout(tprinted):
        state, stats = step(torch.Generator().manual_seed(1), state, tbatch, TRAIN_FRAC)
    return types.SimpleNamespace(
        jcfg=jcfg, jstats=jstats, jparams=cache_slice._leaves(jax.device_get(
            jstate.params["params"])), jmu=_adam(jstate.opt_state)[0],
        jprinted=jprinted.getvalue(),
        tmodel=tmodel, state=state, stats=stats, tprinted=tprinted.getvalue(), before=before)


def test_set_d_cache_step_matches_jax(jax_encoder_switch_restored):  # noqa: F811
    """Set D through JAX's train step and the port's: every loss term (the
    eikonal and the zero weight tether among them), the parameters after
    Adam, debug_mode's weight L2s, distance percentiles, gradient norms and
    maxima, and the printed warnings of all-zero gradients."""
    run = _set_d_run()
    jstats, stats = run.jstats, run.stats
    assert sorted(stats["losses"]) == sorted(jstats["losses"])
    assert {"eikonal", "normalize_weight", "interlevel_0", "interlevel_1"} <= set(stats["losses"])
    for k, v in jstats["losses"].items():
        np.testing.assert_allclose(cache_slice._num(stats["losses"][k]), float(v), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    for group in ("weight_l2s", "grad_norms", "grad_maxes"):
        assert sorted(stats[group]) == sorted(jstats[group])
        for k, v in jstats[group].items():
            np.testing.assert_allclose(float(stats[group][k]), float(v),
                                       rtol=1e-5 if group == "weight_l2s" else 1e-3,
                                       err_msg=f"{group} {k}")
    for level in range(3):
        for name in DEBUG_KEYS:
            k = name.format(level)
            np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]), err_msg=k,
                                       **sampling_options.CHAIN)
    zero_warnings = sorted(line for line in run.jprinted.splitlines() if "all-zero" in line)
    assert sorted(line for line in run.tprinted.splitlines() if "all-zero" in line) == zero_warnings
    _assert_adam_update(run.tmodel, run.jparams, run.before, float(run.state.lr_fn(0)))


def test_set_d_gradients_match_jax(jax_encoder_switch_restored):  # noqa: F811
    """Set D's gradient leaves against JAX's (the eikonal's second-order
    terms in the proposal MLPs among them): JAX's cleaned gradient is its
    Adam's first moment after the step over 1 - b1, the port's the .grad
    its step leaves."""
    run = _set_d_run()
    b1 = run.jcfg.adam_beta1
    grad = jax.tree_util.tree_map(lambda m: m / (1 - b1), run.jmu)
    worst = sampling_options._compare_leaves(run.tmodel, grad, run.jcfg)
    assert any(k.startswith("sampler.mlps.0.") for k in worst)


def _module_norms(leaves):
    """The norm of each top-level module's leaves (the unit of clipping)."""
    norms = {}
    for k, v in leaves.items():
        norms[k.split(".")[0]] = norms.get(k.split(".")[0], 0.0) + float(np.sum(np.square(v)))
    return {k: np.sqrt(v) for k, v in norms.items()}


def test_grad_accumulation_matches_multisteps(jax_encoder_switch_restored, tmp_path):  # noqa: F811
    """Four micro-steps, two updates, against JAX's optax.MultiSteps
    (use_grad_mean=True): each micro-step reads a batch of its own, so the
    micro-gradients differ, and each is clipped to grad_max_norm before the
    mean (so the mean of each update is shorter than the limit, where
    clipping the mean would give it the limit's length). Every micro-step
    of both packages takes the same draws (JAX's step traced once). After
    each micro-step that does not update, the parameters stay put and the
    port's accumulator equals MultiSteps' acc_grads; at each update, the
    port's mean gradient (its .grad) equals JAX's (read from Adam's first
    moment), its Adam moments equal optax's, and its parameters JAX's: by
    exactly +-lr after the first update where the gradient's sign is
    determined, and after the second, where Adam's step depends on the two
    means' magnitudes, within what the gradient tolerance allows. The port
    checkpoints its state after the first micro-step and the rest run on a
    fresh model and optimizer restored from it."""
    config = dict(grad_accum_steps=2, grad_max_norm=0.01)
    jcfg, tcfg, jmodel, tmodel, variables, jdata, tdata = build_cache(config, seed=2)
    b1 = jcfg.adam_beta1
    batches = [(jdata.next_train(), tdata.next_train()) for _ in range(4)]
    for jb, tb in batches:
        np.testing.assert_array_equal(tb.rays.origins.numpy(), np.asarray(jb.rays.origins))
    assert not np.array_equal(np.asarray(batches[0][0].rgb), np.asarray(batches[1][0].rgb))

    jstep, jstate = _jax_train_step(jmodel, jcfg, variables)
    # The state replicated on the step's mesh, as the step returns it, so
    # that its one trace (which bakes in the draws) serves all four calls.
    jstate = jmesh.replicate(jstate, jmesh.create_mesh())
    jseen = []
    with injected(53), jhash.xla_encoder_scope():
        for jb, _ in batches:
            jstate, _ = jstep(jax.random.PRNGKey(0), jstate, jb, TRAIN_FRAC)
            # The step donates its state: read each before the next call.
            jseen.append(dict(
                params=cache_slice._leaves(jax.device_get(jstate.params["params"])),
                acc=cache_slice._leaves(jax.device_get(jstate.opt_state.acc_grads["params"])),
                moments=[cache_slice._leaves(m["params"]) for m in _adam(jstate.opt_state)]))
    assert int(jstate.step) == 4 and jstep._cache_size() == 1

    before = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    state, _ = ttrain.create_optimizer(tcfg, tmodel)
    model = tmodel
    means = []
    for i, (_, tb) in enumerate(batches):
        kept = {k: p.detach().clone() for k, p in model.named_parameters()}
        with injected(53):
            state, _ = ttrain.create_train_step(model, tcfg)(torch.Generator(), state, tb,
                                                             TRAIN_FRAC)
        seen = jseen[i]
        assert state.step == i + 1
        if i % 2 == 0:
            assert state.grad_accum is not None
            jprev = jseen[i - 1]["params"] if i else cache_slice._leaves(variables["params"])
            for key, p in model.named_parameters():
                np.testing.assert_array_equal(p.detach().numpy(), kept[key].numpy(), err_msg=key)
                np.testing.assert_array_equal(seen["params"][key], jprev[key], err_msg=key)
            _compare_leaves_of(state.grad_accum, seen["acc"])
        else:
            assert state.grad_accum is None
            mu, nu = seen["moments"]
            prev_mu = jseen[i - 2]["moments"][0] if i > 1 else {k: 0.0 for k in mu}
            mean = {k: (mu[k] - b1 * prev_mu[k]) / (1 - b1) for k in mu}
            means.append(mean)
            _compare_leaves_of({k: p.grad for k, p in model.named_parameters()}, mean)
            adam = {k: state.optimizer.state[p] for k, p in model.named_parameters()}
            _compare_leaves_of({k: s["exp_avg"] for k, s in adam.items()}, mu)
            _compare_leaves_of({k: s["exp_avg_sq"] for k, s in adam.items()}, nu, rtol=2e-3,
                               atol_frac=2e-4)
            assert all(s["step"] == (i + 1) // 2 for s in adam.values())
        if i == 0:
            tckpt.save_checkpoint(str(tmp_path), {
                "step": state.step, "model": model.state_dict(),
                "optimizer": state.optimizer.state_dict(), "grad_accum": state.grad_accum},
                state.step)
            tree = tckpt.load_params(str(tmp_path))
            model = flagship.build_flagship_cache_model(
                tcfg, cache_slice.narrow(flagship.flagship_cache_params()), device="cpu")
            model.load_state_dict(tree["model"])
            state, _ = ttrain.create_optimizer(tcfg, model)
            state.optimizer.load_state_dict(tree["optimizer"])
            state.step, state.grad_accum = tree["step"], tree["grad_accum"]
        if i == 1:
            _assert_adam_update(model, seen["params"], before, float(state.lr_fn(0)))
            after_first = {k: p.detach().clone() for k, p in model.named_parameters()}
    # Clipping acts on each micro-gradient: both of the first update's
    # micro-gradients reach the limit in a module whose mean falls short of
    # it by more than 5e-3 (clipping the mean would give it the limit's
    # length: a scaling five times the gradient tolerance).
    first = jseen[0]["acc"]
    second = {k: 2 * means[0][k] - first[k] for k in first}
    limit = config["grad_max_norm"]
    norms = [_module_norms(x) for x in (first, second, means[0])]
    assert [m for m in norms[2] if norms[2][m] < 0.995 * limit
            and min(norms[0][m], norms[1][m]) > 0.999 * limit]
    # The second update's step, lr * m / (sqrt(v) + eps) with bias
    # correction, moves with the ratio of the two means; where both are
    # above 1e-2 of their leaf's largest entry, the gradient tolerance
    # (rtol 1e-3, atol 1e-4 x the largest entry) bounds each mean's error by
    # 1.1e-2 of itself, and the step's by 2.5e-2 of lr. The step is at most
    # 1.0014 lr: with b1 = 0.9 and b2 = 0.999 the bias-corrected moments
    # weigh the two means 0.474 / 0.526 and 0.49975 / 0.50025, and
    # Cauchy-Schwarz bounds |m| / sqrt(v) by sqrt(0.474^2 / 0.49975 +
    # 0.526^2 / 0.50025).
    lr = float(state.lr_fn(1))
    for key, p in model.named_parameters():
        want = material_slice._tr(key, jseen[3]["params"][key])
        got = p.detach().numpy()
        g1, g2 = (np.abs(material_slice._tr(key, m[key])) for m in means)
        both = (g1 > 1e-2 * g1.max()) & (g2 > 1e-2 * g2.max())
        np.testing.assert_allclose(got[both] - after_first[key].numpy()[both],
                                   want[both] - after_first[key].numpy()[both], rtol=0,
                                   atol=2.5e-2 * lr + 1e-7, err_msg=key)
        assert np.all(np.abs(got - after_first[key].numpy()) <= lr * 1.0014 + 1e-7), key


def _compare_leaves_of(got, want, rtol=1e-3, atol_frac=1e-4):
    """Tensors by the port's key against JAX's leaves by that key, at the
    gradient tolerance."""
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        w = material_slice._tr(key, np.asarray(want[key]))
        _close_grad(t.detach().numpy(), w, err_msg=key, rtol=rtol, atol_frac=atol_frac)


def test_transient_step_with_the_gauss_pyramid_matches_jax():
    """A narrow transient cache step under rawnerf_transient_unbiased with
    two Gaussian scales: every loss term and gradient leaf; the pyramid
    moves the loss (the port's step without it, on the same weights)."""
    gauss = dict(transient_gauss_sigma_scales=[(1.0, 1.0), (2.0, 0.5)],
                 transient_gauss_constant_scale=0.5, data_loss_gauss_mult=0.5)
    jcfg, tcfg, jmodel, tmodel, variables, jbatch, tbatch = transient_slice.build(seed=3)
    jcfg, tcfg = dataclasses.replace(jcfg, **gauss), dataclasses.replace(tcfg, **gauss)
    (jtotal, (jterms, _)), jgrad = transient_slice.jax_loss(jmodel, jcfg)(variables, jbatch)
    plain = copy.deepcopy(tmodel)
    plain_cfg = dataclasses.replace(tcfg, transient_gauss_sigma_scales=[])
    state, _ = ttrain.create_optimizer(plain_cfg, plain)
    _, stats = ttrain.create_train_step(plain, plain_cfg)(None, state, tbatch, TRAIN_FRAC)
    plain_total = float(stats["loss"])
    state, _ = ttrain.create_optimizer(tcfg, tmodel)
    state, stats = ttrain.create_train_step(tmodel, tcfg)(None, state, tbatch, TRAIN_FRAC)
    assert abs(float(stats["loss"]) - plain_total) > 1e-6 * abs(plain_total)
    assert sorted(stats["losses"]) == sorted(jterms)
    for k, v in jterms.items():
        np.testing.assert_allclose(cache_slice._num(stats["losses"][k]), float(v), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    sampling_options._compare_leaves(tmodel, jgrad, jcfg)


def test_material_correlation_step_matches_jax():
    """material_surface_light_field_light on the spheres scene with the SLF
    variate (whose shader pass emits irradiance_cache) and the material
    correlation on by its weights: neither package's model puts an
    irradiance_cache into the shader results that the extra losses read
    (the variate pass copies only its ref_* outputs), so the term is 0 in
    both, as JAX's loss returns it (JAX's forward traced, not run);
    test_extra_loss_functions_match_jax holds the loss where one is
    given."""
    files, bindings = slf_trainer.SCENES["synthetic_spheres"]
    bindings = bindings + ["Config.material_correlation_weight_albedo = 0.1",
                           "Config.material_correlation_weight_other = 0.1",
                           "Config.irradiance_cache_loss_weight = 0.5",
                           "Config.whitening_loss_weight = 0.2"]
    jt, jmodel, tt = material_trainer._trainers(files, bindings,
                                                "material_surface_light_field_light")
    try:
        jcfg, tcfg = jt.config, tt.config
        jbatch = cache_slice.jdatasets.load_dataset("train", None, jcfg).next_train()
        variables = material_trainer._variables(jmodel, 5)
        seen = {}

        def forward(v):
            results = jmodel.apply(v, jax.random.PRNGKey(0), jbatch.rays, train_frac=TRAIN_FRAC,
                                   train=True, compute_extras=False)
            seen["shader"] = set(results["main"]["shader"])
            seen["loss"] = jextra.material_correlation_loss(
                jmodel, v, jax.random.PRNGKey(1), jbatch.rays, jcfg, jbatch, results["main"],
                results)
            return results["render"]["rgb"]

        jax.eval_shape(forward, variables)
        tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
        tbatch = tt.dataset.next_train()
        with torch.no_grad():
            tres = tt.model(tt.rng, tbatch.rays, train_frac=TRAIN_FRAC, train=True,
                            compute_extras=False)
            losses = textra.compute_extra_losses(tcfg, tbatch, tbatch.rays, tres, "main", {},
                                                 TRAIN_FRAC, model=tt.model, rng=tt.rng)
    finally:
        jgin.clear_config()
        tgin.clear_config()
    assert "ref_rays_indirect_diffuse" in seen["shader"]
    assert "irradiance_cache" not in seen["shader"]
    assert "irradiance_cache" not in tres["main"]["shader"]
    assert isinstance(seen["loss"], float) and seen["loss"] == 0.0
    assert cache_slice._num(losses["material_correlation"]) == 0.0


def test_trainer_takes_micro_steps(tmp_path, monkeypatch):
    """Config.grad_accum_steps = 2 with secondary_grad_accum_steps = 2 (the
    trainer binds their product): each loop step takes four micro-steps,
    two batches each fed to two of them; the checkpoint's step counts
    micro-steps, and a resume starts at the next loop step."""
    ckpt = str(tmp_path / "accum")
    drawn = []

    class Counting(ttrainer.RayBatcher):
        def __next__(self):
            drawn.append(1)
            return super().__next__()

    monkeypatch.setattr(ttrainer, "RayBatcher", Counting)
    args = ["Trainer.stage = 'cache'", f"Config.checkpoint_dir = '{ckpt}'",
            "Config.early_exit_steps = 2", "Config.grad_accum_steps = 2",
            "Config.secondary_grad_accum_steps = 2"]
    trainer = trainer_test._run(args)
    tgin.clear_config()
    assert trainer.grad_accum_steps == 4 and trainer.state.step == 8
    assert len(drawn) == 4
    assert tckpt.load_params(ckpt)["step"] == 8
    assert tckpt.load_params(ckpt)["grad_accum"] is None
    drawn.clear()
    trainer = trainer_test._run(args)
    tgin.clear_config()
    assert trainer.state.step == 8 and not drawn
    assert os.path.exists(os.path.join(ckpt, "train_log.jsonl"))
