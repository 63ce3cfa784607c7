"""The material shader's options and the secondary-ray samplers they reach,
in the port against the JAX package on the same numpy-seeded inputs, with
weights carried across by ``utils/weights.py`` and one numpy stream feeding
both packages' random draws (``test_torch_material_slice.injected``).

Function level: the stratified 2D generator (``RandomGenerator2D.create``),
the uniform-sphere, identity and mirror samplers, GGX_G1 and the
visible-normal GGX sampler, Phong in ``get_lobe``, ``get_outgoing_rays``,
MIS off in ``importance_sample_rays``, and the BRDF correction in each of
its four forms with the converter's two widths of its output layer. Then
one narrow material step under option set C (the anisotropic BRDF
correction, reparam_roughness, emission with a window and variate weights,
MIS off with a stratified generator, stopgrad_light=False,
resample_cache=False, and the extra losses emission, maximum_radiance and
extra_ray) and one under set C' (residual albedo with its loss, a single
diffuse lobe of the specular samplers:
separate_integration_diffuse_specular=False, use_constant_material),
through both packages' losses; and the options where JAX itself fails.

Tolerances (float32), as tests/test_torch_sampling_options.py states them:
- Module outputs: rtol 1e-5, atol 1e-6 (the same ops in the same order).
- Gradients: rtol 1e-3 with an atol of 1e-4 x the leaf's largest entry
  (sums in another order whose terms cancel; a wrong term is O(1)).
- The steps: every loss term to 1e-4 relative, every gradient leaf to a
  relative L2 of 1e-3 (2e-3 where set B's test holds its leaves, and the
  material step's secondary-ray leaves, the cache's and the shader's, to
  1e-2: a 1e-5 move of a surface normal turns a GGX direction, as in
  tests/test_torch_material_slice.py).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import test_torch_cache_slice as cache_slice
import test_torch_material_slice as material_slice
import test_torch_sampling_options as sampling_options
from neural_radiance_caching_tpu.engine.configs import Config as JConfig
from neural_radiance_caching_tpu.models import material_shader as jshader
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.ops import render_utils as jru
from neural_radiance_caching_tpu.parallel import extra_losses as jextra
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch import flagship
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.engine.configs import Config as TConfig
from neural_radiance_caching_tpu_torch.models import material_shader as tshader
from neural_radiance_caching_tpu_torch.ops import render_utils as tru
from neural_radiance_caching_tpu_torch.utils import weights
from test_torch_material_slice import injected, jax_encoder_switch_restored  # noqa: F401

VAL = dict(rtol=1e-5, atol=1e-6)
TRAIN_FRAC = material_slice.TRAIN_FRAC
_close_grad = sampling_options._close_grad


def _t(x):
    return torch.as_tensor(np.asarray(x))


# --- ops/render_utils -----------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 32, 128])
def test_stratified_generator_matches_jax(n):
    """create(n) picks the same blocks, and a stratified draw of a multiple
    of them lands in the same cells as JAX's."""
    jgen, tgen = jru.RandomGenerator2D.create(n, True), tru.RandomGenerator2D.create(n, True)
    assert (tgen.h_blocks, tgen.w_blocks) == (jgen.h_blocks, jgen.w_blocks)
    m = 2 * n
    with injected(1):
        juh, juw = jgen.sample(jax.random.PRNGKey(0), m, None)
        tuh, tuw = tgen.sample(torch.Generator(), m, "cpu")
    np.testing.assert_allclose(tuh.numpy(), np.asarray(juh), **VAL)
    np.testing.assert_allclose(tuw.numpy(), np.asarray(juw), **VAL)
    assert tru.DummySampler2D().sample(None, m, "cpu") == (None, None)


def test_stratified_draw_off_the_blocks_raises_as_in_jax():
    """A stratified draw whose count is no multiple of the blocks: JAX's
    shifts do not broadcast against the draw; the port names that."""
    jgen, tgen = jru.RandomGenerator2D(2, 4, True), tru.RandomGenerator2D(2, 4, True)
    with pytest.raises((TypeError, ValueError), match="broadcast|shapes"):
        jgen.sample(jax.random.PRNGKey(0), 6, None)
    with pytest.raises(NotImplementedError, match="reference gap"):
        tgen.sample(torch.Generator().manual_seed(0), 6, "cpu")


def _local_dirs(rng, shape):
    d = rng.normal(size=shape + (3,))
    d[..., 2] = np.abs(d[..., 2]) + 0.05
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", ["uniform_sphere", "identity", "mirror", "microfacet_visible"])
def test_new_samplers_match_jax(name):
    """Each new sampler by its table name: directions and pdfs on the same
    uniforms, the MIS density of other directions, and for the
    visible-normal GGX sampler the gradient through the roughness."""
    rng = np.random.RandomState(2)
    shape = (6, 5)
    u1, u2 = (rng.uniform(0.01, 0.99, shape).astype(np.float32) for _ in range(2))
    wo, wi = _local_dirs(rng, shape), _local_dirs(rng, shape)
    alpha = rng.uniform(0.05, 0.9, shape + (1,)).astype(np.float32)
    if name == "microfacet_visible":
        js, ts = jru.MicrofacetSampler(sample_visible=True), tru.MicrofacetSampler(True)
    else:
        js, ts = jru.IMPORTANCE_SAMPLER_BY_NAME[name](), tru.IMPORTANCE_SAMPLER_BY_NAME[name]()
    assert ts.global_dirs == js.global_dirs
    jd, jp = js.sample_directions(None, *map(jnp.asarray, (u1, u2, wo, alpha)), None, {})
    ta = _t(alpha).requires_grad_()
    td, tp = ts.sample_directions(None, _t(u1), _t(u2), _t(wo), ta, None, {})
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd), **VAL)
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.pdf(_t(wo), _t(wi), _t(alpha), {}).numpy(),
                               np.asarray(js.pdf(jnp.asarray(wo), jnp.asarray(wi),
                                                 jnp.asarray(alpha), {})), rtol=1e-5, atol=1e-5)
    if name == "microfacet_visible":
        r = rng.normal(size=shape + (3,)).astype(np.float32)
        jg = jax.grad(lambda a: jnp.sum(js.sample_directions(
            None, jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(wo), a, None, {})[0] * r))(
            jnp.asarray(alpha))
        (td * _t(r)).sum().backward()
        _close_grad(ta.grad.numpy(), np.asarray(jg))
        g1 = rng.uniform(0.05, 1.0, shape).astype(np.float32)
        np.testing.assert_allclose(tru.GGX_G1(_t(wo), _t(g1)).numpy(),
                                   np.asarray(jru.GGX_G1(jnp.asarray(wo), jnp.asarray(g1))),
                                   **VAL)


def test_phong_lobe_matches_jax():
    rng = np.random.RandomState(3)
    wi, wo = _local_dirs(rng, (5, 4)), _local_dirs(rng, (5, 4))
    mats = {"albedo": rng.uniform(size=(5, 3)), "specular_albedo": rng.uniform(size=(5, 3)),
            "specular_exponent": rng.uniform(1, 8, (5, 1))}
    mats = {k: v.astype(np.float32) for k, v in mats.items()}
    cfg = tru._shading_config("phong", False, False, False, False)
    normal = np.broadcast_to(np.float32([0, 0, 1]), wi.shape)
    got = tru.get_lobe(_t(wi), _t(wo), _t(normal), {k: _t(v) for k, v in mats.items()}, None, cfg)
    want = jru.get_lobe(jnp.asarray(wi), jnp.asarray(wo), jnp.asarray(normal),
                        {k: jnp.asarray(v) for k, v in mats.items()}, None, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)


@pytest.mark.parametrize("use_mis", [False, True])
def test_outgoing_rays_and_mis_off_match_jax(use_mis):
    """get_outgoing_rays (the extra-ray loss's view turn) with the model's
    uniform hemisphere sampler, and importance_sample_rays with MIS off or
    on over GGX and cosine samplers under a stratified generator."""
    jr, tr, f = sampling_options._rays(4, n=8)
    rng = np.random.RandomState(5)
    normals = _local_dirs(rng, (8, 1))
    with injected(6):
        jout = jru.get_outgoing_rays(
            jax.random.PRNGKey(0), jr, jr.viewdirs, jnp.asarray(normals), {},
            random_generator_2d=jru.RandomGenerator2D(1, 1, False), use_mis=False,
            samplers=((jru.UniformHemisphereSampler(), 1.0),), num_secondary_samples=1)
        tout = tru.get_outgoing_rays(
            torch.Generator(), tr, tr.viewdirs, _t(normals), {},
            random_generator_2d=tru.RandomGenerator2D(1, 1, False), use_mis=False,
            samplers=((tru.UniformHemisphereSampler(), 1.0),), num_secondary_samples=1)
    np.testing.assert_allclose(tout.viewdirs.numpy(), np.asarray(jout.viewdirs), **VAL)
    np.testing.assert_array_equal(tout.origins.numpy(), np.asarray(jout.origins))

    viewdirs = -_local_dirs(rng, (8,))
    material = {"roughness": rng.uniform(0.1, 0.5, (8, 1)).astype(np.float32)}
    kw = dict(use_mis=use_mis, num_secondary_samples=8)
    with injected(7):
        want = jru.importance_sample_rays(
            jax.random.PRNGKey(0), jnp.asarray(viewdirs), jnp.asarray(normals[:, 0]),
            {k: jnp.asarray(v) for k, v in material.items()},
            random_generator_2d=jru.RandomGenerator2D.create(8, True),
            samplers=((jru.MicrofacetSampler(), 1), (jru.CosineSampler(), 1)), **kw)
        got = tru.importance_sample_rays(
            torch.Generator(), _t(viewdirs), _t(normals[:, 0]),
            {k: _t(v) for k, v in material.items()},
            random_generator_2d=tru.RandomGenerator2D.create(8, True),
            samplers=((tru.MicrofacetSampler(), 1), (tru.CosineSampler(), 1)), **kw)
    for k in ("local_lightdirs", "global_lightdirs", "pdf", "weight"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    if not use_mis:
        assert np.all(got["weight"].numpy() == 1.0)


# --- models/material_shader: the BRDF correction --------------------------------------------

BRDF_FORMS = {
    "default": {},
    "anisotropic": dict(anisotropic_brdf_correction=True, deg_brdf_anisotropic=3),
    "per_point": dict(per_point_brdf_correction=True),
    "global": dict(global_brdf_correction=True, deg_brdf=3),
}


def _load_partial(tmodule, variables):
    """Copy a JAX parameter tree that covers part of `tmodule` into it."""
    params = dict(tmodule.named_parameters())
    for path, leaf in weights._flatten(variables["params"]):
        value = np.asarray(leaf)
        value = value.T if path[-1] == "kernel" else value
        with torch.no_grad():
            params[weights.torch_key(path)].copy_(torch.as_tensor(np.ascontiguousarray(value)))


@pytest.mark.parametrize("form", sorted(BRDF_FORMS))
def test_brdf_correction_matches_jax(form):
    """The learned correction of one lobe's samples in each form: its
    values, and its gradient to the correction's parameters and the point
    feature. The port creates the parameters JAX creates at the first call
    (the output layer alone over the feature under per_point, else the MLP
    and the output layer over its width), and the converter fills them."""
    opts = dict(use_brdf_correction=True, net_width_brdf=8, net_depth_brdf=2, bottleneck_width=16,
                use_grid=False, **BRDF_FORMS[form])
    jm = jshader.MaterialMLP(config=JConfig(), **opts)
    tm = tshader.MaterialMLP(config=TConfig(), density_feature_dim=8, **opts)
    rng = np.random.RandomState(8)
    b, s, n = 3, 2, 4
    feature = rng.normal(size=(b, s, 16)).astype(np.float32)
    samples = {k: _local_dirs(rng, (b * s, n)) for k in ("local_viewdirs", "local_lightdirs",
                                                        "global_viewdirs", "global_lightdirs")}
    samples["local_viewdirs"] = np.broadcast_to(samples["local_viewdirs"][:, :1], (b * s, n, 3))
    js = {k: jnp.asarray(v) for k, v in samples.items()}

    def jcall(module, feat):
        return module.get_brdf_correction(feat, js, n)

    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(feature), method=jcall)
    variables = material_slice.random_variables(jax.eval_shape(lambda: variables), 9)
    want_names = {"per_point": ["output_brdf_correction_layer"]}.get(
        form, ["brdf_correction_layers_0", "brdf_correction_layers_1",
               "output_brdf_correction_layer"])
    # The shader's light power comes with its setup, which every call runs.
    assert sorted(variables["params"]) == sorted(want_names + ["light_power"])
    variables["params"].pop("light_power")
    names = {k.split(".")[0] for k, _ in tm.named_parameters() if "brdf_correction" in k}
    assert names == {weights.torch_key((p,)).split(".")[0] for p in want_names}
    _load_partial(tm, variables)
    light = {"light_power": np.zeros((1,), np.float32)}

    def japply(v, feat):
        return jm.apply({"params": dict(v["params"], **light)}, feat, method=jcall)

    want = japply(variables, jnp.asarray(feature))
    tfeat = _t(feature).requires_grad_()
    got = tm.get_brdf_correction(tfeat, {k: _t(np.ascontiguousarray(v))
                                         for k, v in samples.items()}, n)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL)
    r = rng.normal(size=got.shape).astype(np.float32)
    jg, jgf = jax.grad(lambda v, f: jnp.sum(japply(v, f) * r), argnums=(0, 1))(
        variables, jnp.asarray(feature))
    (got * _t(r)).sum().backward()
    # The global form reads no feature: JAX's gradient there is zeros.
    _close_grad(np.zeros_like(feature) if tfeat.grad is None else tfeat.grad.numpy(),
                np.asarray(jgf))
    jleaves = cache_slice._leaves(jg["params"])
    for key, g in jleaves.items():
        _close_grad(dict(tm.named_parameters())[key].grad.numpy(), material_slice._tr(key, g),
                    err_msg=key)


# --- the narrow material steps --------------------------------------------------------------

BASE_CONFIG = dict(batch_size=material_slice.BATCH, lr_delay_steps=0, secondary_far=4.0,
                   material_loss_radius=4.0, data_loss_type="rawnerf_unbiased",
                   use_gradient_debias=True, gradient_checkpointing=False,
                   distortion_loss_mult=0.0, predicted_normal_loss_mult=0.0,
                   predicted_normal_reverse_loss_mult=0.0, is_material=True)


def set_c(ru):
    """Option set C's shader fields (`ru`: the package's render_utils)."""
    return dict(use_brdf_correction=True, anisotropic_brdf_correction=True, net_width_brdf=8,
                reparam_roughness=True, use_diffuse_emission=True, emission_window_frac=0.8,
                emission_variate_weight_start=0.5, emission_variate_weight_end=1.0,
                use_mis=False, stratified_sampling=True,
                random_generator_2d=ru.RandomGenerator2D.create(8, True), stopgrad_light=False,
                resample_cache=False)


SET_C_CONFIG = dict(extra_losses={"emission": {"main": {"mult": 1.0}}},
                    emission_zero_loss_mult=0.1, emission_constant_loss_mult=1.0,
                    maximum_radiance_loss_weight=0.1, extra_ray_loss_mult=0.5)


def set_c_prime(ru):
    del ru
    return dict(use_residual_albedo=True, separate_integration_diffuse_specular=False,
                use_constant_material=True)


SET_C_PRIME_CONFIG = dict(extra_losses={"residual_albedo": {"main": {"mult": 1.0}}})


def build_material(shader_fn, config_overrides, seed=0):
    """The narrow flagship material model with `shader_fn(render_utils)`'s
    shader fields, in both packages, the same weights, and a batch each."""
    common = dict(BASE_CONFIG, **config_overrides)
    jcfg = dataclasses.replace(bench._cache_config(), **common)
    tcfg = flagship.material_config(**common)
    jfull = bench.build_flagship_material_model(jcfg)
    jparams = material_slice.narrow_material(jfull.cache_model_params, jfull.light_sampler_params,
                                             jfull.shader_params)
    jparams["shader_params"].update(shader_fn(jru))
    jmodel = jfull.clone(**jparams)
    tparams = flagship.flagship_material_params()
    tparams.update(material_slice.narrow_material(tparams["cache_model_params"],
                                                  tparams["light_sampler_params"],
                                                  tparams["shader_params"]))
    tparams["shader_params"].update(shader_fn(tru))
    tmodel = flagship.build_flagship_material_model(tcfg, tparams, device="cpu")
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))
    variables = material_slice.random_variables(shapes, seed)
    tmodel.load_state_dict(weights.state_dict_from_jax(variables, tmodel))
    jdata = cache_slice.jdatasets.SyntheticSpheres("train", None, jcfg, num_images=3,
                                                   resolution=16)
    tdata = tdatasets.SyntheticSpheres("train", None, tcfg, num_images=3, resolution=16,
                                       device="cpu")
    return jcfg, tcfg, jmodel, tmodel, variables, jdata.next_train(), tdata.next_train()


def jax_material_step(jmodel, jcfg):
    """The JAX train step's loss of a material model with its extra losses:
    the forward, the gradient-debias forward with its `_nocorr` shader keys,
    the loss assembly and the extra losses of every *main output."""

    def loss_fn(variables, batch):
        rng = jax.random.PRNGKey(0)
        kw = dict(train_frac=TRAIN_FRAC, train=True, compute_extras=False)
        results = jmodel.apply(variables, rng, batch.rays, **kw)
        nocorr = jmodel.apply(
            variables, jax.random.fold_in(rng, 0x5EED), batch.rays,
            cache_outputs={"sampler": results["cache_main"]["sampler"]},
            filtered_sampler_inds=results["cache_main"]["filtered_sampler_inds"], **kw)
        results["render"]["rgb_nocorr"] = nocorr["render"]["rgb"]
        for out_key in ("main", "cache_main"):
            shader, nocorr_shader = results[out_key]["shader"], nocorr[out_key]["shader"]
            for k in ("diffuse_rgb", "specular_rgb", "direct_rgb", "indirect_rgb",
                      "lighting_irradiance"):
                if k in nocorr_shader:
                    shader[k + "_nocorr"] = nocorr_shader[k]
        losses, stats = {}, {}
        for i, key in enumerate(sorted(k for k in results if k.endswith("main"))):
            jtrain._compute_losses_for_output(None, batch, batch.rays, results, jcfg, TRAIN_FRAC,
                                              key, losses, stats)
            jextra.compute_extra_losses(jmodel, variables, jax.random.fold_in(rng, 7919 + i),
                                        batch.rays, jcfg, batch, results, key, losses,
                                        TRAIN_FRAC)
        shader = results["main"]["shader"]
        out = dict(rgb=results["render"]["rgb"],
                   **{k: shader[k] for k in ("material_albedo", "material_roughness",
                                            "material_metalness", "lighting_emission",
                                            "material_residual_albedo")})
        return sum(jax.tree_util.tree_leaves(losses)), (losses, out)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _run_set(shader_fn, config, draws, terms):
    jcfg, tcfg, jmodel, tmodel, variables, jbatch, tbatch = build_material(shader_fn, config)
    with injected(draws), jhash.xla_encoder_scope():
        (jtotal, (jterms, jout)), jgrad = jax_material_step(jmodel, jcfg)(variables, jbatch)
    with injected(draws), torch.no_grad():
        tout = tmodel(torch.Generator(), tbatch.rays, train_frac=TRAIN_FRAC, train=True)
    shader = tout["main"]["shader"]
    for k, v in jout.items():
        got = tout["render"]["rgb"] if k == "rgb" else shader[k]
        np.testing.assert_allclose(got.numpy(), np.asarray(v), err_msg=k, **material_slice.FWD)
    before = copy.deepcopy(tmodel.state_dict())
    state, stats, calls = material_slice.run_port_step(tmodel, tcfg, tbatch, draws)
    assert sorted(stats["losses"]) == sorted(jterms) == sorted(terms)
    floors = {}
    if "extra_ray" in terms:
        # The extra-ray term is the product of two differences of renders
        # that agree to ~1e-3 of each other: a one-ulp move of the rays'
        # origins moves it by ~1e-2 of itself. It is held to 3x that floor
        # of the port's own (the step again on the nudged rays).
        after = copy.deepcopy(tmodel.state_dict())
        tmodel.load_state_dict(before)
        o = tbatch.rays.origins
        nudged = tbatch.replace(rays=tbatch.rays.replace(
            origins=torch.nextafter(o, torch.full_like(o, float("inf")))))
        _, stats_n, _ = material_slice.run_port_step(tmodel, tcfg, nudged, draws)
        tmodel.load_state_dict(after)
        term = cache_slice._num(stats["losses"]["extra_ray"])
        floors["extra_ray"] = abs(cache_slice._num(stats_n["losses"]["extra_ray"]) - term) / abs(
            term)
        assert floors["extra_ray"] < 0.1
    for k, v in jterms.items():
        np.testing.assert_allclose(cache_slice._num(stats["losses"][k]), float(v),
                                   rtol=max(1e-4, 3 * floors.get(k, 0.0)), atol=1e-9, err_msg=k)
    total_rtol = 1e-4 + 3 * sum(floors.get(k, 0.0) * abs(float(v)) for k, v in jterms.items()
                                ) / abs(float(jtotal))
    np.testing.assert_allclose(float(stats["loss"]), float(jtotal), rtol=total_rtol)
    sampling_options._compare_leaves(tmodel, jgrad, jcfg, limit=2e-3,
                                     loose=("cache.", "shader."))
    return tmodel, tout, calls


BASE_TERMS = ["cache_data", "cache_interlevel_0", "cache_interlevel_1", "data"]


def test_set_c_material_step_matches_jax():
    """Set C through both packages: the render and material heads (the
    reparametrised roughness, the eased emission), every loss term (the
    emission, maximum-radiance and extra-ray terms among them), every
    gradient leaf (the correction MLP's and the emission head's among
    them). The extra rays' forward adds its own encoder backwards: the
    cache's primary samples and the material grid (leveled) and its
    secondary samples (planes), twice the plain step's launches."""
    tmodel, tout, calls = _run_set(set_c, SET_C_CONFIG, 41,
                                   BASE_TERMS + ["emission", "extra_ray", "maximum_radiance"])
    assert sorted(calls) == ["leveled"] * 4 + ["planes"] * 2
    params = dict(tmodel.named_parameters())
    for name in ("shader.brdf_correction_layers.0.weight",
                 "shader.output_brdf_correction_layer.bias",
                 "shader.rgb_diffuse_emission_layer.weight"):
        assert params[name].grad is not None and params[name].grad.abs().max() > 0, name
    assert float(tout["main"]["shader"]["lighting_emission"].abs().max()) > 0


def test_set_c_prime_material_step_matches_jax():
    """Set C' through both packages: one diffuse lobe over all secondary
    samples (drawn by the specular samplers; the specular lobe's outputs
    stay 0.0, as in JAX), one material for the scene, the residual albedo
    in the render and its loss; every loss term and gradient leaf."""
    tmodel, tout, calls = _run_set(set_c_prime, SET_C_PRIME_CONFIG, 42,
                                   BASE_TERMS + ["residual_albedo"])
    shader = tout["main"]["shader"]
    assert "ref_rays_indirect_specular" not in shader
    assert shader["ref_samples_indirect_diffuse"]["local_lightdirs"].shape[1] == 8
    np.testing.assert_allclose(shader["material_metalness"].numpy(), 1.0)
    grad = dict(tmodel.named_parameters())["shader.rgb_residual_albedo_layer.weight"].grad
    assert grad is not None and grad.abs().max() > 0
    assert sorted(calls) == ["leveled", "leveled", "planes"]


def _per_point(ru):
    return dict(use_brdf_correction=True, per_point_brdf_correction=True,
                use_residual_albedo=True)


@pytest.mark.parametrize("shader_fn", [set_c, _per_point], ids=["set_c", "per_point"])
def test_converter_round_trips_the_material_options(shader_fn):
    """The JAX tree of a model under set C (the correction MLP, its output
    layer over the MLP's width, the emission head) and under the per-point
    correction (its output layer alone, over the point's feature; the
    residual-albedo head), from the port's state_dict, equals the tree it
    was filled from, leaf for leaf."""
    _, _, _, tmodel, variables, _, _ = build_material(shader_fn, {}, seed=2)
    back = weights.jax_tree_from_state_dict(tmodel.state_dict())
    want, got = cache_slice._leaves(variables["params"]), cache_slice._leaves(back["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if shader_fn is set_c:
        assert {"shader.brdf_correction_layers.1.weight",
                "shader.output_brdf_correction_layer.weight",
                "shader.rgb_diffuse_emission_layer.bias"} <= set(want)
        assert want["shader.output_brdf_correction_layer.weight"].shape == (8, 2)
    else:
        assert not any("brdf_correction_layers" in k for k in want)
        assert want["shader.output_brdf_correction_layer.weight"].shape == (16, 2)
        assert "shader.rgb_residual_albedo_layer.weight" in want


GAPS = {
    "steady_use_indirect_false": (dict(use_indirect=False), AttributeError,
                                  "'float' object has no attribute 'reshape'", "use_indirect"),
    "no_diffuse_sample": (dict(diffuse_sample_fraction=0.0), AttributeError,
                          "'float' object has no attribute 'reshape'", "diffuse_sample_fraction"),
    "phong": (dict(material_type="phong"), KeyError, "roughness", "material_type='phong'"),
    "lambertian": (dict(material_type="lambertian"), KeyError, "roughness",
                   "material_type='lambertian'"),
}


@pytest.mark.parametrize("gap", sorted(GAPS))
def test_material_options_jax_cannot_run_raise(gap):
    """Where JAX's material shader fails (at its first call), the port's
    raises at its construction, naming JAX's failure."""
    shader, jerr, jmatch, tmatch = GAPS[gap]
    jcfg = dataclasses.replace(bench._cache_config(), **BASE_CONFIG)
    jfull = bench.build_flagship_material_model(jcfg)
    jparams = material_slice.narrow_material(jfull.cache_model_params, jfull.light_sampler_params,
                                             jfull.shader_params)
    jparams["shader_params"].update(shader)
    jmodel = jfull.clone(**jparams)
    with pytest.raises(jerr, match=jmatch):
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1),
                                           jpytrees.dummy_rays(4), train_frac=1.0, train=True))
    tparams = flagship.flagship_material_params()
    tparams["shader_params"] = dict(tparams["shader_params"], **shader)
    with pytest.raises(NotImplementedError, match=f"{tmatch}.*reference gap.*{jmatch}"):
        flagship.build_flagship_material_model(flagship.material_config(**BASE_CONFIG),
                                               copy.deepcopy(tparams), device="cpu")


TRANSIENT_GAPS = {
    "separate_integration_off": (dict(separate_integration_diffuse_specular=False),
                                 "separate_integration_diffuse_specular=False"),
    "no_diffuse_sample": (dict(diffuse_sample_fraction=0.0), "diffuse_sample_fraction"),
}


@pytest.mark.parametrize("gap", sorted(TRANSIENT_GAPS))
def test_transient_material_options_jax_cannot_run_raise(gap):
    """The transient material shader's per-lobe path and a diffuse lobe
    without samples: JAX's model fails at its first call (an indirect
    output left the float 0.0 reaches the transient integrator or
    zero_invalid_bins); the port's raises at its construction, naming that."""
    import test_torch_transient_material_slice as tmat

    shader, tmatch = TRANSIENT_GAPS[gap]
    jcfg = dataclasses.replace(bench._cache_config(), batch_size=tmat.BATCH, lr_delay_steps=0,
                               gradient_checkpointing=False, **tmat.STAGE)
    jfull = bench.build_flagship_transient_material_model(jcfg)
    jparams = tmat.narrow(jfull.cache_model_params, jfull.light_sampler_params,
                          jfull.shader_params)
    jparams["shader_params"] = dict(jparams["shader_params"], **shader)
    jmodel = jfull.clone(**jparams)
    with pytest.raises(AttributeError, match="'float' object has no attribute 'shape'"):
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1),
                                           jpytrees.dummy_rays(4), train_frac=1.0, train=True))
    tparams = flagship.flagship_transient_material_params()
    tparams["shader_params"] = dict(tparams["shader_params"], **shader)
    with pytest.raises(NotImplementedError, match=f"{tmatch}.*reference gap.*'shape'"):
        flagship.build_flagship_transient_material_model(
            flagship.transient_material_config(), tparams, device="cpu")
