"""The cache model's own resampling and the shaders' remaining fields
against the JAX package's, at test widths:

- one narrow `ngp_yobo.gin` cache step through both trainers with
  `NeRFModel.resample` (4 draws), then with `resample_argmax` too;
- an eval render of the narrow flagship cache model with
  `resample_render` and `resample_argmax`;
- one narrow `ngp_yobo.gin` cache step under the base shader's fields: the
  cache shader's own grid with posenc (`use_posenc_with_grid`, its degrees
  and basis), the covariance fields, a scale-aware query
  (`unscented_scale_mult` over the julier basis, the contraction), the
  backfacing noise with its target and rate, and the log exposure added to
  the bottleneck (`use_exposure_at_bottleneck`, both packages' batches given
  the same exposures);
- one narrow `ngp_yobo.gin` cache step with the steady shader's active
  path and its shadow rays;
- one narrow cornell cache step under the transient shader's fields
  (`simple_brdf`, a cone light, `Config.light_canonical_frame` and
  `Config.light_intensity_conditioning` with its scale and bias);
- the narrow transient material model's forward under a cone light
  (`TransientMaterialMLP.light_max_angle`, the shader's own light);
- the fields JAX cannot run raising in both packages.

Tolerances: a step's loss terms to 1e-4 relative with an absolute 1e-7,
every gradient leaf to rtol 2e-3 with an absolute 2e-4 x its largest entry
(`tests/test_torch_slf_distance.py`); a render to 1e-4 relative and
absolute x the largest entry (`tests/test_torch_eval_slice.py`); the
transient material forward at `tests/test_torch_transient_material_slice.py`'s
`FWD` and `SEC`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_cache_slice as cache_slice
import test_torch_eval_slice as eval_slice
import test_torch_material_slice as material_slice
import test_torch_material_trainer as material_trainer
import test_torch_trainer as trainer_test
import test_torch_transient_material_slice as tm_slice
import test_torch_transient_trainer as transient_trainer
import bench
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.models import construct as jconstruct
from neural_radiance_caching_tpu.models.nerf_model import NeRFModel as JNeRFModel
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.parallel import mesh as jmesh
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu.engine import renderer as jrenderer
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch import flagship
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.engine import renderer as trenderer
from neural_radiance_caching_tpu_torch.models import construct as tconstruct
from neural_radiance_caching_tpu_torch.parallel import train as ttrain
from neural_radiance_caching_tpu_torch.utils import weights

NGP = material_trainer.NGP
TRAIN_FRAC = material_trainer.TRAIN_FRAC
RESAMPLE = {
    "resample": ["NeRFModel.resample = True", "NeRFModel.num_resample = 4"],
    "argmax": ["NeRFModel.resample = True", "NeRFModel.num_resample = 4",
               "NeRFModel.resample_argmax = True"],
}
# The base shader's fields on the cache shader (its own grid added).
SHADER_FIELDS = [
    "NeRFMLP.use_grid = True",
    "NeRFMLP.grid_params = {'hash_map_size': 4096, 'max_grid_size': 128}",
    "NeRFMLP.warp_fn = @coord.contract",
    "NeRFMLP.use_posenc_with_grid = True", "NeRFMLP.min_deg_point = 1",
    "NeRFMLP.max_deg_point = 3", "NeRFMLP.basis_shape = 'octahedron'",
    "NeRFMLP.basis_subdivisions = 1", "NeRFMLP.isotropize_gaussians = True",
    "NeRFMLP.gaussian_covariance_scale = 2.0", "NeRFMLP.gaussian_covariance_pad = 1e-4",
    "NeRFMLP.unscented_mip_basis = 'julier'", "NeRFMLP.unscented_scale_mult = 0.5",
    "NeRFMLP.backfacing_noise = 0.3", "NeRFMLP.backfacing_target = 'normals'",
    "NeRFMLP.backfacing_noise_rate = 0.5", "NeRFMLP.use_exposure_at_bottleneck = True",
]
# The cone lights' full angle, degrees: it darkens some sampled points and
# lights others.
ANGLE = 150.0
TRANSIENT_FIELDS = [
    "TransientNeRFMLP.simple_brdf = True", "Config.light_canonical_frame = True",
    "Config.light_intensity_conditioning = True",
    "Config.light_intensity_conditioning_scale = 2.0",
    "Config.light_intensity_conditioning_bias = 0.5",
]


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


# --- the cache model's own resampling -----------------------------------------------------


@pytest.mark.parametrize("case", sorted(RESAMPLE))
def test_cache_step_with_resampling_matches_jax(case, monkeypatch):
    """One narrow ngp_yobo.gin cache step with the cache's own resampling
    of primary rays (4 draws; with `resample_argmax` the heaviest sample and
    3 draws from the rest), from the same weights and draws: every loss
    term, gradient leaf and the Adam step."""
    jt, jmodel, tt = material_trainer._trainers(NGP, trainer_test.NGP_TINY + RESAMPLE[case],
                                                "cache")
    cache = tt.model.cache
    assert cache.resample and cache.num_resample == 4
    assert cache.resample_argmax == (case == "argmax")
    variables = material_trainer._variables(jmodel, 5)
    material_trainer._step_parity(jt, jmodel, tt, variables, monkeypatch, [])


def _resample_render_models(seed=0):
    chunk = dict(render_chunk_size=eval_slice.CHUNK)
    extra = dict(resample_render=True, num_resample=3, resample_argmax=True)
    jcfg = dataclasses.replace(bench._cache_config(), **chunk)
    tcfg = flagship.cache_config(**chunk)
    jmodel = JNeRFModel(config=jcfg, **extra, **eval_slice._render_strategy(
        cache_slice.narrow(bench.flagship_cache_params(jcfg))))
    tmodel = flagship.build_flagship_cache_model(tcfg, dict(extra, **eval_slice._render_strategy(
        cache_slice.narrow(flagship.flagship_cache_params()))), device="cpu")
    return jcfg, tcfg, jmodel, tmodel, eval_slice._bridge(jmodel, tmodel, seed)


def test_resample_render_in_an_eval_render_matches_jax():
    """An eval render (two chunks, two repeats) of the narrow flagship cache
    with `resample_render` and `resample_argmax` (3 samples per ray): every
    output against JAX's `create_render_fn` + `render_image`."""
    jcfg, tcfg, jmodel, tmodel, variables = _resample_render_models()
    jview = jdatasets.SyntheticSpheres("test", None, jcfg, num_images=2,
                                       resolution=eval_slice.RES).generate_ray_batch(0)
    tview = eval_slice._port_view(tcfg)
    kw = dict(height=eval_slice.RES, width=eval_slice.RES, render_repeats=eval_slice.REPEATS)
    with eval_slice.injected(3):
        one_device = jmesh.create_mesh(jax.devices()[:1])
        want = jrenderer.render_image(jtrain.create_render_fn(jmodel, mesh=one_device), variables,
                                      jview.rays, jax.random.PRNGKey(0), jcfg, **kw)
        got = trenderer.render_image(ttrain.create_render_fn(tmodel), tview.rays,
                                     torch.Generator().manual_seed(0), tcfg, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=eval_slice.TIGHT,
                                   atol=eval_slice.TIGHT * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=key)
    assert float(got["rgb_variance"].max()) > 0


# --- the base shader's fields -------------------------------------------------------------


def _with_exposure(monkeypatch, tt, exposure):
    """Both packages' train batches carry `exposure` [rays, 1] as their
    rays' exposure_values."""
    real = jdatasets.load_dataset

    def load(*args, **kw):
        data = real(*args, **kw)
        nxt = data.next_train

        def next_train():
            b = nxt()
            return b.replace(rays=b.rays.replace(exposure_values=jnp.asarray(exposure)))

        data.next_train = next_train
        return data

    monkeypatch.setattr(jdatasets, "load_dataset", load)
    tnext = tt.dataset.next_train

    def tnext_train():
        b = tnext()
        return b.replace(rays=b.rays.replace(exposure_values=torch.as_tensor(exposure)))

    monkeypatch.setattr(tt.dataset, "next_train", tnext_train)


def test_shader_fields_cache_step_matches_jax(monkeypatch):
    """One narrow ngp_yobo.gin cache step under every field of the base
    shader that the cache shader reads: its own grid queried scale-aware at
    the julier control points through the contraction, the posenc of the
    isotropised, scaled and padded Gaussians over a subdivided octahedron,
    noise in place of the backfacing samples' colour, the log exposure at
    the bottleneck; every loss term, gradient leaf and the Adam step."""
    jt, jmodel, tt = material_trainer._trainers(NGP, trainer_test.NGP_TINY + SHADER_FIELDS,
                                                "cache")
    shader = tt.model.cache.shader
    assert shader.reads_posenc and shader.pos_basis_t.shape[0] == 3
    n = tt.config.batch_size
    exposure = np.random.RandomState(2).uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    _with_exposure(monkeypatch, tt, exposure)
    variables = material_trainer._variables(jmodel, 5)
    # The cache shader's grid backward launches the leveled kernel.
    material_trainer._step_parity(jt, jmodel, tt, variables, monkeypatch, ["leveled"])


def test_steady_active_cache_step_matches_jax(monkeypatch):
    """One narrow ngp_yobo.gin cache step with the steady shader's active
    path (`NeRFMLP.use_active`: the point light, the BRDF-net direct terms,
    C-channel indirect nets) and its shadow rays through the cache's
    weights (`Config.use_occlusions`); every loss term, gradient leaf and
    the Adam step."""
    bindings = trainer_test.NGP_TINY + [
        "NeRFMLP.use_active = True", "Config.use_occlusions = True",
        "Config.occlusions_secondary_only = False"]
    jt, jmodel, tt = material_trainer._trainers(NGP, bindings, "cache")
    shader = tt.model.cache.shader
    assert shader.use_active and hasattr(shader, "indirect_layer")
    variables = material_trainer._variables(jmodel, 5)
    own = {k: v.clone() for k, v in tt.model.state_dict().items()}
    material_trainer._step_parity(jt, jmodel, tt, variables, monkeypatch, [])
    # The point light reaches the render at the port's own initial weights
    # (at the parity's drawn ones every normal faces away from the light,
    # and the direct term is 0, in JAX too).
    tt.model.load_state_dict(own)
    with torch.no_grad():
        render = tt.model(torch.Generator().manual_seed(0), tt.dataset.next_train().rays,
                          train=True, train_frac=TRAIN_FRAC)["render"]
    assert float(render["direct_rgb"].abs().max()) > 0


def _jax_init_raises(files, bindings, stage, exc, match):
    jt = trainer_test.synthesize("jax", files, bindings, stage)
    jmodel = jconstruct.make_model(jt.config)
    with pytest.raises(exc, match=match), jhash.xla_encoder_scope():
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1),
                                           jpytrees.dummy_rays(4), train_frac=1.0, train=False))
    tgin.clear_config()


def test_posenc_outside_the_cache_shaders_raises_in_both():
    """Posenc with the grid in the material shader: only JAX's cache
    shaders build the basis, and the material shader's first query raises
    AttributeError."""
    bindings = (trainer_test.NGP_TINY + material_trainer.MATERIAL_TINY + material_trainer.MATERIAL
                + ["MaterialMLP.use_grid = True", "MaterialMLP.use_posenc_with_grid = True",
                   "MaterialMLP.grid_params = {'hash_map_size': 4096, 'max_grid_size': 128}"])
    stage = "material_light_from_scratch"
    _jax_init_raises(NGP, bindings, stage, AttributeError, "pos_basis_t")
    tt = trainer_test.synthesize("torch", NGP, bindings, stage)
    with pytest.raises(NotImplementedError, match="reference gap.*pos_basis_t"):
        tconstruct.make_model(tt.config, device="cpu")


def test_shader_without_feature_or_grid_raises_in_both():
    """A cache shader with neither the density feature nor a grid: JAX
    concatenates no feature and raises ValueError at the first query."""
    bindings = trainer_test.NGP_TINY + ["NeRFMLP.use_density_feature = False"]
    _jax_init_raises(NGP, bindings, "cache", ValueError, "Need at least one array")
    tt = trainer_test.synthesize("torch", NGP, bindings, "cache")
    with pytest.raises(NotImplementedError, match="reference gap.*Need at least one array"):
        tconstruct.make_model(tt.config, device="cpu")


# --- the transient shaders' fields --------------------------------------------------------


def test_transient_shader_fields_cache_step_matches_jax(monkeypatch):
    """One narrow cornell cache step (the in-step cast) under the transient
    shader's fields: n.h alone into the BRDF net, the indirect nets reading
    the light in the surface's frame and scaled by the light's intensity;
    every loss term, gradient leaf and the Adam step."""
    jt, jmodel, tt = transient_trainer._cornell(TRANSIENT_FIELDS)
    jcfg = jt.config
    shader = tt.model.cache.shader
    assert shader.simple_brdf
    assert tt.config.light_canonical_frame and tt.config.light_intensity_conditioning
    variables = material_trainer._variables(jmodel, 5)
    jdata = jdatasets.load_dataset("train", None, jcfg)
    jbatch = jdata.next_train()
    with material_slice.injected(7), jhash.xla_encoder_scope():
        (_, jlosses_), jgrad = transient_trainer.jax_step_loss(jmodel, jcfg, jdata, TRAIN_FRAC)(
            variables, jbatch)
    jgrad = jlosses.clip_gradients(jax.tree_util.tree_map(jnp.nan_to_num, jgrad), jcfg)
    jstate, _ = jtrain.create_optimizer(jcfg, variables)
    updates, _ = jstate.tx.update(jgrad, jstate.opt_state, variables)
    jnew = material_slice._leaves(optax.apply_updates(variables, updates)["params"])

    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    calls = []
    material_slice._counting_scatters(monkeypatch, calls)
    with material_slice.injected(7):
        state, stats = tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), TRAIN_FRAC)
    assert calls == ["leveled"]
    got = {k: float(v) for k, v in stats["losses"].items()}
    assert sorted(got) == sorted(jlosses_)
    for k, v in jlosses_.items():
        np.testing.assert_allclose(got[k], float(v), err_msg=k, **transient_trainer.LOSS)
    want = material_slice._leaves(jgrad["params"])
    params = dict(tt.model.named_parameters())
    assert sorted(params) == sorted(want)
    for k, p in params.items():
        material_slice._close(p.grad.numpy(), material_slice._tr(k, want[k]),
                              *transient_trainer.GRAD, k)
    for k, p in params.items():
        lr = max(g["lr"] for g in state.optimizer.param_groups
                 if any(q is p for q in g["params"]))
        np.testing.assert_allclose(p.detach().numpy(), material_slice._tr(k, jnew[k]),
                                   rtol=0, atol=2 * lr + 1e-7, err_msg=k)
    assert float(params["cache.shader.brdf_layers.0.weight"].grad.abs().max()) > 0


def test_transient_cache_cone_light_matches_jax():
    """The cornell cache shader's point light under a cone of `ANGLE`
    degrees about the camera's look direction (`light_max_angle`), at 8
    points per ray from the camera toward a point past the light: the light
    radiance, its multiplier and the radiance before occlusion against
    JAX's `_compute_light_radiance`."""
    _, jmodel, tt, variables = transient_trainer._bridged(
        [f"TransientNeRFMLP.light_max_angle = {ANGLE}"])
    jrays, trays = transient_trainer._rays(tt)
    s = np.linspace(0.1, 1.6, 8, dtype=np.float32)[None, :, None]
    origins, lights = trays.origins.numpy()[:, None], trays.lights.numpy()[:, None]
    targets = origins + trays.viewdirs.numpy()[:, None] * 2.0
    means = origins + s * (targets - origins) + 0.3 * s * (lights - origins)
    dists = np.linalg.norm(lights - means, axis=-1, keepdims=True)
    dirs = (lights - means) / np.maximum(dists, 1e-5)

    def radiance(module, rays, means, dirs, dists):
        return module.cache.shader._compute_light_radiance(None, rays, {"means": means}, None,
                                                           dirs, None, dists)

    want = jmodel.apply(variables, jrays, jnp.asarray(means), jnp.asarray(dirs),
                        jnp.asarray(dists), method=radiance)
    with torch.no_grad():
        got = tt.model.cache.shader._light_radiance(
            trays, {"means": torch.as_tensor(means)}, torch.as_tensor(dists), None, None)
    for g, w, name in zip(got, want, ("radiance", "mult", "before_occ")):
        material_slice._close(g.numpy(), np.asarray(w), 1e-5, 1e-7, name)
    lit = got[2].numpy() > 0
    assert lit.any() and not lit.all()


def test_transient_material_cone_light_matches_jax():
    """The narrow transient material model's forward lit by the shader's own
    light (no learnable light) under a 150-degree cone
    (`TransientMaterialMLP.light_max_angle`): the direct radiance, the
    render and the time-binned indirect against JAX's, from the same
    weights and draws."""
    stage = dict(tm_slice.STAGE, learnable_light=False)
    jcfg = dataclasses.replace(bench._cache_config(), batch_size=tm_slice.BATCH,
                               lr_delay_steps=0, gradient_checkpointing=False, **stage)
    tcfg = flagship.transient_material_config(
        batch_size=tm_slice.BATCH, lr_delay_steps=0, n_bins=tm_slice.N_BINS,
        exposure_time=tm_slice.EXPOSURE, gradient_checkpointing=False, learnable_light=False)
    jfull = bench.build_flagship_transient_material_model(jcfg)
    jp = tm_slice.narrow(jfull.cache_model_params, jfull.light_sampler_params,
                         jfull.shader_params)
    jp["shader_params"] = dict(jp["shader_params"], light_max_angle=ANGLE)
    jmodel = jfull.clone(**jp)
    tparams = flagship.flagship_transient_material_params()
    tparams.update(tm_slice.narrow(tparams["cache_model_params"], tparams["light_sampler_params"],
                                   tparams["shader_params"]))
    tparams["shader_params"] = dict(tparams["shader_params"], light_max_angle=ANGLE)
    tmodel = flagship.build_flagship_transient_material_model(tcfg, tparams, device="cpu")
    assert tmodel.shader.light_max_angle == ANGLE and not tcfg.learnable_light
    variables = eval_slice._bridge(jmodel, tmodel, 0)
    jbatch = jdatasets.SyntheticSpheres("train", None, jcfg, num_images=3,
                                        resolution=16).next_train()
    tbatch = tdatasets.SyntheticSpheres("train", None, tcfg, num_images=3, resolution=16,
                                        device="cpu").next_train()

    def jforward(v, rays):
        out = jmodel.apply(v, jax.random.PRNGKey(0), rays, train_frac=tm_slice.TRAIN_FRAC,
                           train=True)
        return dict(out["main"]["shader"], rgb=out["render"]["rgb"])

    with material_slice.injected(11), jhash.xla_encoder_scope():
        jout = jax.jit(jforward)(variables, jbatch.rays)
    with material_slice.injected(11), torch.no_grad():
        tout = tmodel(torch.Generator(), tbatch.rays, train_frac=tm_slice.TRAIN_FRAC, train=True)
    got = dict(tout["main"]["shader"], rgb=tout["render"]["rgb"])
    direct = np.asarray(jout["direct_rgb"])
    # The cone darkens some surface points and lights others.
    assert (np.abs(direct).max(-1) == 0).any() and float(np.abs(direct).max()) > 0
    for k in ("direct_rgb", "light_dists"):
        material_slice._close(got[k].numpy(), np.asarray(jout[k]), err_msg=k, **tm_slice.FWD)
    # The time-binned render: a pulse near a bin edge splits between the two
    # bins by float32 rounding of its path length (4 of 768 entries ~2e-3
    # apart with or without the cone; the direct radiance above agrees at
    # FWD), as the secondary outputs do.
    for k in ("rgb", "transient_indirect", "indirect_rgb"):
        material_slice._close(got[k].numpy(), np.asarray(jout[k]), err_msg=k, **tm_slice.SEC)
