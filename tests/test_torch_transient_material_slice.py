"""The transient material stage (InvProp inverse rendering) end to end: a
narrow TransientMaterialModel with the flagship's structure (the transient
cache with secondary-ray resampling, the vMF LightMLP, the active and
indirect TransientMaterialMLP with the flagship BRDF head and the learnable
light source) built in both packages with the same numpy-seeded weights
(bridged by ``utils/weights.state_dict_from_jax``) and fed the same random
numbers: every uniform, normal and categorical draw of both packages comes
from one numpy stream (``test_torch_material_slice.injected``), 16 bins of
0.8.

The step is held in the two forms the stage runs in: as the bench builds it
(no extra loss) and with the staged trainer's consistency binding
(``flagship.trainer_consistency_losses``, ``mse_unbiased``). Both come from
one JAX trace (a vjp of the two totals), so both see the same draws.
Compared: the forward (time-binned renderings, direct and indirect shader
outputs, the learnable light's distances), every loss term, the `_nocorr`
keys the debias forward grafts, every gradient leaf, one Adam step, the set
of parameters no loss reaches and the encoder backwards; then the eval
render through ``create_render_fn`` + ``render_image``.

Tolerances (float32), as in ``test_torch_material_slice.py``: rendered
values rtol 1e-4 / atol 1e-4 x the output's largest entry, per-secondary-ray
statistics 1e-3 / 1e-3 x the largest entry (a 1e-5 difference in a predicted
normal turns a GGX direction near grazing angles), loss terms 1e-4,
gradients rtol 2e-3 with an atol of 2e-3 x the leaf's largest entry (10x
the material slice's: at 16 rays a secondary sample moved across a grid
cell shows, ``GRAD_ATOL``), the Adam step exactly +-lr where the gradient's
sign is determined, to 1e-6. A wrong term is off by O(1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import test_torch_eval_slice as eval_slice
import test_torch_material_slice as material_slice
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import renderer as jrenderer
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.parallel import extra_losses as jextra
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.parallel import mesh as jmesh
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch import flagship
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.engine import renderer as trenderer
from neural_radiance_caching_tpu_torch.parallel import extra_losses as textra
from neural_radiance_caching_tpu_torch.parallel import train as ttrain
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees
from neural_radiance_caching_tpu_torch.utils import weights
from test_torch_material_slice import jax_encoder_switch_restored  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("jax_encoder_switch_restored")

TRAIN_FRAC = 0.5
BATCH = 16
N_BINS = 16
EXPOSURE = 0.8
FWD = dict(rtol=1e-4, atol_frac=1e-4)
SEC = dict(rtol=1e-3, atol_frac=1e-3)
STAGE = dict(use_transient=True, n_bins=N_BINS, exposure_time=EXPOSURE, learnable_light=True,
             light_source_position=[0.0, 0.0, 1.0],
             data_loss_type="rawnerf_transient_unbiased", linear_to_srgb=False,
             secondary_far=4.0, material_loss_radius=4.0, use_gradient_debias=True,
             cache_consistency_loss_weight=1.0, cache_consistency_loss_type="mse_unbiased",
             distortion_loss_mult=0.0, predicted_normal_loss_mult=0.0,
             predicted_normal_reverse_loss_mult=0.0)
# Gradient atol, as a fraction of the leaf's largest entry: a rounding
# difference that moves one secondary sample across a grid cell moves its
# table update to another row and changes the density MLP's inputs there (at
# this batch, 5 of 16,384 density-table entries by up to 1.3e-3 of the
# table's largest, one density bias by 5e-4).
GRAD_ATOL = 2e-3
BASE_TERMS = ["cache_data", "cache_interlevel_0", "cache_interlevel_1", "data"]
CONSISTENCY = textra.CONSISTENCY

# No loss reaches these: the learnable light replaces the shader's own
# light power; the light sampler's outputs feed only the (unused on this
# path) light importance sampler, under a stop-gradient; the light source's
# position, shift and dark-level offsets are constants while their optimize_*
# flags are off; the cache shader's ambient heads are off (use_ambient=False).
UNREACHED = {
    "shader.light_power",
    "shader.learnable_light.light_source_offset", "shader.learnable_light.transient_shift_offset",
    "shader.learnable_light.dark_level_offset",
    "light_sampler.layers.0.weight", "light_sampler.layers.0.bias",
    "light_sampler.layers.1.weight", "light_sampler.layers.1.bias",
    "light_sampler.output_layer.weight", "light_sampler.output_layer.bias",
    "light_sampler.grid.dense_levels", "light_sampler.grid.hash_levels",
    "cache.shader.ambient_irradiance_layer.weight", "cache.shader.ambient_irradiance_layer.bias",
    "cache.shader.surface_lf.output_ambient_rgb_layer.weight",
    "cache.shader.surface_lf.output_ambient_rgb_layer.bias",
}
NOCORR_KEYS = ("direct_rgb_nocorr", "transient_indirect_nocorr", "cache_direct_rgb_nocorr",
               "cache_transient_indirect_nocorr")


def narrow(cache_model_params, light_sampler_params, shader_params):
    """The flagship transient material structure at test widths (the same
    edits in both packages)."""
    p = material_slice.narrow_material(cache_model_params, light_sampler_params, shader_params)
    p["cache_model_params"]["shader_params"].update(net_width_brdf=8, net_width_irradiance=16)
    return p


def build(seed=0, extra_losses=None, **cfg_overrides):
    extra = dict(extra_losses=extra_losses or {})
    jcfg = dataclasses.replace(bench._cache_config(), batch_size=BATCH, lr_delay_steps=0,
                               gradient_checkpointing=False, **STAGE, **extra)
    tcfg = flagship.transient_material_config(batch_size=BATCH, lr_delay_steps=0, n_bins=N_BINS,
                                              exposure_time=EXPOSURE,
                                              gradient_checkpointing=False, **extra,
                                              **cfg_overrides)
    jfull = bench.build_flagship_transient_material_model(jcfg)
    jmodel = jfull.clone(**narrow(jfull.cache_model_params, jfull.light_sampler_params,
                                  jfull.shader_params))
    tparams = flagship.flagship_transient_material_params()
    tparams.update(narrow(tparams["cache_model_params"], tparams["light_sampler_params"],
                          tparams["shader_params"]))
    tmodel = flagship.build_flagship_transient_material_model(tcfg, tparams, device="cpu")
    variables = eval_slice._bridge(jmodel, tmodel, seed)
    jdata = jdatasets.SyntheticSpheres("train", None, jcfg, num_images=3, resolution=16)
    tdata = tdatasets.SyntheticSpheres("train", None, tcfg, num_images=3, resolution=16,
                                       device="cpu")
    return jcfg, tcfg, jmodel, tmodel, variables, jdata.next_train(), tdata.next_train()


def jax_step(jmodel, jcfg):
    """The JAX train step's losses in both forms from one trace: the forward,
    the gradient-debias forward with its `_nocorr` shader keys grafted (JAX
    train.py:413-447), the loss assembly over every *main output, and the
    consistency loss under the trainer's binding; returns the two totals'
    values and gradients, the terms and the compared outputs."""
    cons_cfg = dataclasses.replace(jcfg, extra_losses=flagship.trainer_consistency_losses(jcfg))

    def totals(variables, batch):
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
                      "transient_indirect", "lighting_irradiance", "cache_diffuse_rgb",
                      "cache_specular_rgb", "cache_direct_rgb", "cache_indirect_rgb",
                      "cache_transient_indirect"):
                if k in nocorr_shader:
                    shader[k + "_nocorr"] = nocorr_shader[k]
        losses, stats = {}, {}
        for i, key in enumerate(sorted(k for k in results if k.endswith("main"))):
            jtrain._compute_losses_for_output(None, batch, batch.rays, results, jcfg, TRAIN_FRAC,
                                              key, losses, stats)
            jextra.compute_extra_losses(jmodel, variables, jax.random.fold_in(rng, 7919 + i),
                                        batch.rays, cons_cfg, batch, results, key, losses,
                                        TRAIN_FRAC)
        base = sum(v for k, v in losses.items() if k != CONSISTENCY)
        shader = results["main"]["shader"]
        out = dict(rgb=results["render"]["rgb"], cache_rgb=results["render"]["cache_rgb"],
                   **{k: shader[k] for k in ("direct_rgb", "transient_indirect",
                                            "indirect_rgb", "light_dists", "material_albedo",
                                            "material_roughness", "lighting_irradiance",
                                            "indirect_occ") + NOCORR_KEYS})
        return (base, losses[CONSISTENCY]), (losses, out)

    def step(variables, batch):
        (base, cons), vjp, (losses, out) = jax.vjp(lambda v: totals(v, batch), variables,
                                                   has_aux=True)
        one, zero = jnp.ones_like(base), jnp.zeros_like(base)
        return dict(bench=(base, vjp((one, zero))[0]),
                    trainer=(base + cons, vjp((one, one))[0])), losses, out

    return jax.jit(step)


def run_port_step(tmodel, tcfg, tbatch, draws_seed, calls=None, spy=None):
    """One port train step with injected draws; `calls` collects the
    table-gradient scatters, `spy` sees the results after the debias pass."""
    state, _ = ttrain.create_optimizer(tcfg, tmodel)
    step = ttrain.create_train_step(tmodel, tcfg)
    with material_slice.injected(draws_seed), pytest.MonkeyPatch.context() as mp:
        if calls is not None:
            material_slice._counting_scatters(mp, calls)
        if spy is not None:
            real = ttrain._debias_forward

            def debias(model, rng, rays, train_frac, model_results):
                real(model, rng, rays, train_frac, model_results)
                spy(model_results)

            mp.setattr(ttrain, "_debias_forward", debias)
        state, stats = step(torch.Generator().manual_seed(1), state, tbatch, TRAIN_FRAC)
    return state, stats


@pytest.fixture(scope="module")
def parity():
    jcfg, tcfg, jmodel, tmodel, variables, jbatch, tbatch = build()
    with material_slice.injected(11), jhash.xla_encoder_scope():
        jforms, jterms, jout = jax_step(jmodel, jcfg)(variables, jbatch)
    with material_slice.injected(11), torch.no_grad():
        tout = tmodel(torch.Generator(), tbatch.rays, train_frac=TRAIN_FRAC, train=True)
    params_before = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    forms = {}
    for form, extra in (("bench", {}), ("trainer", flagship.trainer_consistency_losses(tcfg))):
        model = tmodel if form == "bench" else build(extra_losses=extra)[3]
        cfg = dataclasses.replace(tcfg, extra_losses=extra)
        calls, seen = [], {}
        state, stats = run_port_step(model, cfg, tbatch, 11, calls,
                                     lambda r: seen.update(shader=r["main"]["shader"],
                                                           render=r["render"]))
        forms[form] = dict(model=model, state=state, stats=stats, calls=calls, seen=seen)
    return dict(jcfg=jcfg, variables=variables, jforms=jforms, jterms=jterms, jout=jout,
                tout=tout, forms=forms, params_before=params_before)


def test_forward_matches_jax(parity):
    jout, tout = parity["jout"], parity["tout"]
    shader = tout["main"]["shader"]
    got = dict(shader, rgb=tout["render"]["rgb"], cache_rgb=tout["render"]["cache_rgb"])
    assert tuple(got["rgb"].shape) == (BATCH, N_BINS, 3)
    assert tuple(got["transient_indirect"].shape) == (BATCH, 1, N_BINS, 3)
    assert tuple(got["direct_rgb"].shape) == (BATCH, 1, 3)
    assert float(np.abs(np.asarray(jout["direct_rgb"])).max()) > 0
    assert float(np.abs(np.asarray(jout["transient_indirect"])).max()) > 0
    for k in ("rgb", "cache_rgb", "direct_rgb", "light_dists", "material_albedo",
              "material_roughness"):
        material_slice._close(got[k].numpy(), np.asarray(jout[k]), err_msg=k, **FWD)
    for k in ("transient_indirect", "indirect_rgb", "lighting_irradiance", "indirect_occ"):
        material_slice._close(got[k].numpy(), np.asarray(jout[k]), err_msg=k, **SEC)


@pytest.mark.parametrize("form", ["bench", "trainer"])
def test_loss_terms_match_jax(parity, form):
    terms = parity["forms"][form]["stats"]["losses"]
    jterms = {k: v for k, v in parity["jterms"].items() if form == "trainer" or k != CONSISTENCY}
    want = BASE_TERMS + ([CONSISTENCY] if form == "trainer" else [])
    assert sorted(terms) == sorted(jterms) == sorted(want)
    for k, v in jterms.items():
        np.testing.assert_allclose(float(terms[k].detach()), float(v), rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    assert float(jterms["data"]) > 0 and float(parity["jterms"][CONSISTENCY]) > 0
    np.testing.assert_allclose(float(parity["forms"][form]["stats"]["loss"]),
                               float(parity["jforms"][form][0]), rtol=1e-4)


@pytest.mark.parametrize("form", ["bench", "trainer"])
def test_gradients_and_adam_step_match_jax(parity, form):
    jcfg, run = parity["jcfg"], parity["forms"][form]
    jgrad = jlosses.clip_gradients(
        jax.tree_util.tree_map(jnp.nan_to_num, parity["jforms"][form][1]), jcfg)
    jg = material_slice._leaves(jgrad["params"])
    tparams = dict(run["model"].named_parameters())
    assert sorted(jg) == sorted(tparams)
    for key, g in jg.items():
        material_slice._close(tparams[key].grad.numpy(), material_slice._tr(key, g), rtol=2e-3,
                              atol_frac=GRAD_ATOL, err_msg=key)
    # The learnable light trains through the direct lobes.
    assert np.any(jg["shader.learnable_light.light_power"])

    jstate, _ = jtrain.create_optimizer(jcfg, parity["variables"])
    jnew = material_slice._leaves(jstate.apply_gradients(grads=jgrad).params["params"])
    lr = float(run["state"].lr_fn(0))
    for key, p_new in jnew.items():
        p_new, g = material_slice._tr(key, p_new), material_slice._tr(key, jg[key])
        t_new = tparams[key].detach().numpy()
        before = parity["params_before"][key].numpy()
        determined = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(t_new[determined], p_new[determined], rtol=0, atol=1e-6,
                                   err_msg=key)
        assert np.all(np.abs(t_new - before) <= lr * (1 + 1e-5) + 1e-7), key


@pytest.mark.parametrize("form", ["bench", "trainer"])
def test_unreached_parameters_and_scatters(parity, form):
    run = parity["forms"][form]
    jg = material_slice._leaves(parity["jforms"][form][1]["params"])
    assert {k for k, g in jg.items() if not np.any(g)} == UNREACHED
    unchanged = {k for k, v in run["model"].state_dict().items()
                 if torch.equal(v, parity["params_before"][k])}
    assert unchanged == UNREACHED
    # One leveled backward per encoder a loss reaches: the cache's primary
    # samples, its secondary samples (below the planes threshold here, as at
    # the flagship's 524,288 points) and the material grid. The light
    # sampler's grid gets no gradient and the debias pass no graph.
    assert run["calls"] == ["leveled"] * 3


def test_debias_pass_keeps_no_graph_and_grafts_jax_nocorr_keys(parity):
    jout = parity["jout"]
    seen = parity["forms"]["trainer"]["seen"]
    assert not seen["render"]["rgb_nocorr"].requires_grad and seen["render"]["rgb"].requires_grad
    for k in NOCORR_KEYS:
        got = seen["shader"][k]
        assert not got.requires_grad, k
        tol = FWD if k in ("direct_rgb_nocorr", "cache_direct_rgb_nocorr") else SEC
        material_slice._close(got.numpy(), np.asarray(jout[k]), err_msg=k, **tol)


def test_learnable_shift_trains_the_cache_integrators_only():
    """With optimize_transient_shift and optimize_dark_level on, the shift
    and dark level reach the cache's renderings (its pass and the
    consistency integrator) with a gradient, and the material integrator's
    without one."""
    _, tcfg, _, tmodel, _, _, tbatch = build(seed=5)
    light = tmodel.shader.learnable_light
    light.optimize_transient_shift = light.optimize_dark_level = True
    with torch.no_grad():
        light.transient_shift_offset.fill_(0.3)
        light.dark_level_offset.fill_(0.2)
    with material_slice.injected(6):
        out = tmodel(torch.Generator(), tbatch.rays, train_frac=TRAIN_FRAC, train=True)
    params = (light.transient_shift_offset, light.dark_level_offset)
    renderings = {"cache pass": out["cache_main"]["integrator"]["rgb"],
                  "consistency integrator": out["main"]["cache_integrator"]["rgb"],
                  "material integrator": out["render"]["rgb"]}
    for name, rgb in renderings.items():
        grads = torch.autograd.grad((rgb * torch.linspace(0, 1, N_BINS)[:, None]).sum(), params,
                                    retain_graph=True, allow_unused=True)
        carried = [g is not None and bool(g.abs().sum() > 0) for g in grads]
        assert carried == ([False, False] if name == "material integrator" else [True, True]), name


def test_steady_consistency_loss_matches_jax():
    """The steady material stage's consistency loss on synthetic shader
    dicts: diffuse and specular carried, direct a disabled scalar, indirect
    with its nocorr twins, under each loss type and both nocorr targets."""
    rng = np.random.RandomState(21)
    b = 6

    def rgb():
        return rng.uniform(0, 1, (b, 1, 3)).astype(np.float32)

    shader = {"diffuse_rgb": rgb(), "cache_diffuse_rgb": rgb(), "specular_rgb": rgb(),
              "cache_specular_rgb": rgb().reshape(b, 3), "direct_rgb": 0.0,
              "cache_direct_rgb": rgb(), "indirect_rgb": rgb(), "cache_indirect_rgb": rgb(),
              "indirect_rgb_nocorr": rgb(), "cache_indirect_rgb_nocorr": rgb()}
    lossmult = rng.uniform(0.5, 1, (b, 1)).astype(np.float32)
    masks = (rng.rand(b, 1) > 0.3).astype(np.float32)
    jrays = dataclasses.replace(jpytrees.dummy_rays(b), lossmult=lossmult)
    trays = tpytrees.Rays(*([None] * 12), lossmult=torch.as_tensor(lossmult), near=None,
                          far=None, cam_idx=None, light_idx=None)
    for loss_type in ("mse_unbiased", "rawnerf_unbiased", "charb"):
        for integrated in (True, False):
            over = dict(cache_consistency_loss_type=loss_type,
                        cache_consistency_use_integrated=integrated,
                        cache_consistency_indirect_weight=0.7,
                        cache_consistency_direct_weight=0.6, rawnerf_eps_material=0.05)
            jcfg = dataclasses.replace(bench._cache_config(), **over)
            tcfg = flagship.material_config(**over)
            want = jextra.direct_indirect_consistency_loss(
                None, None, None, jrays, jcfg,
                jpytrees.Batch(rays=jrays, rgb=np.zeros((b, 3), np.float32), masks=masks),
                {"shader": {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                            for k, v in shader.items()}}, None)
            tshader = {k: (torch.as_tensor(v).requires_grad_() if isinstance(v, np.ndarray)
                           else v) for k, v in shader.items()}
            got = textra.direct_indirect_consistency_loss(
                tcfg, tpytrees.Batch(rays=trays, rgb=torch.zeros(b, 3),
                                     masks=torch.as_tensor(masks)), trays, {"shader": tshader})
            np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                                       err_msg=f"{loss_type} integrated={integrated}")
            # The material side is a constant (stop-gradient weight 0).
            got.backward()
            assert tshader["diffuse_rgb"].grad is None
            assert tshader["cache_diffuse_rgb"].grad.abs().sum() > 0


def test_consistency_weight_ease_matches_jax():
    over = dict(use_consistency_weight_ease=True, consistency_weight_ease_start=0.2,
                consistency_weight_ease_frac=0.4, consistency_weight_ease_min=0.1)
    jcfg = dataclasses.replace(bench._cache_config(), **over)
    tcfg = flagship.material_config(**over)
    for frac in (0.0, 0.3, 0.5, 0.9):
        np.testing.assert_allclose(textra.consistency_weight_ease(tcfg, frac),
                                   float(jextra.consistency_weight_ease(jcfg, frac)), rtol=1e-6)
    assert textra.consistency_weight_ease(flagship.material_config(), 0.3) == 1.0


def test_trainer_binding_reads_the_config_weight():
    """The binding's multiplier is the Config's cache_consistency_loss_weight
    (JAX engine/trainer.py:293-299), and it scales the loss that
    compute_extra_losses adds."""
    rng = np.random.RandomState(3)
    b = 4
    shader = {k: torch.as_tensor(rng.uniform(0, 1, (b, 1, 3)).astype(np.float32))
              for k in ("direct_rgb", "cache_direct_rgb")}
    rays = tpytrees.Rays(*([None] * 12), lossmult=torch.ones(b, 1), near=None, far=None,
                         cam_idx=None, light_idx=None)
    batch = tpytrees.Batch(rays=rays, rgb=torch.zeros(b, 3), masks=None)
    got = {}
    for weight in (1.0, 0.1):
        cfg = flagship.transient_material_config(cache_consistency_loss_weight=weight)
        binding = flagship.trainer_consistency_losses(cfg)
        assert binding == {CONSISTENCY: {"main": {"mult": weight, "start_frac": 0.0}}}
        cfg = dataclasses.replace(cfg, extra_losses=binding)
        losses = textra.compute_extra_losses(cfg, batch, rays, {"main": {"shader": shader}},
                                             "main", {}, TRAIN_FRAC)
        got[weight] = float(losses[CONSISTENCY])
    assert got[1.0] > 0
    np.testing.assert_allclose(got[0.1], 0.1 * got[1.0], rtol=1e-6)


@pytest.mark.parametrize("extra", [
    {"residual_albedo": {"main": {"mult": 1.0}}},
    {"emission": {"main": {"mult": 1.0}}},
    {"maximum_radiance_loss_weight": 1.0},
    {"normalize_weight_loss_weight": 1.0},
])
def test_unported_extra_losses_raise(extra):
    cfg = flagship.transient_material_config()
    if "main" in str(extra):
        cfg = dataclasses.replace(
            cfg, extra_losses=dict(flagship.trainer_consistency_losses(cfg), **extra))
    else:
        cfg = dataclasses.replace(cfg, **extra)
    name = next(iter(extra)).replace("_loss_weight", "")
    # Ported now (held against JAX in tests/test_torch_loss_options.py): the
    # step builds, and the loss is added to the main output's terms, by its
    # name or by its Config weight.
    ttrain.create_train_step(None, cfg)
    rng = np.random.RandomState(3)
    rays = tpytrees.Rays(*([None] * 12), lossmult=torch.ones(4, 1), near=None, far=None,
                         cam_idx=None, light_idx=None)
    batch = tpytrees.Batch(rays=rays, rgb=torch.as_tensor(rng.uniform(size=(4, 3)),
                                                          dtype=torch.float32))
    shader = {k: torch.as_tensor(rng.uniform(size=(4, 5, 3)), dtype=torch.float32)
              for k in ("rgb", "lighting_emission", "lighting_irradiance",
                        "material_residual_albedo")}
    results = {"main": {"shader": shader, "geometry": None,
                        "integrator": {"cache_rgb": torch.full((4, 3), 0.5)}}}
    losses = textra.compute_extra_losses(cfg, batch, rays, results, "main", {}, TRAIN_FRAC,
                                         rng=torch.Generator())
    assert name in losses and np.isfinite(float(losses[name]))


@pytest.mark.parametrize("change", ["shadow_rays", "tfilter", "share_light_power"])
def test_unported_options_raise(change):
    """Shadow rays, a light power shared with the cache and the temporal
    filter are ported (held against JAX in
    tests/test_torch_transient_material_trainer.py and
    tests/test_torch_invprop_scenes.py): the narrow model runs with them and
    its outputs are finite. The filter still raises where it is longer than
    the bins (a Gaussian of 2 bins has 17 taps against 16 bins), as JAX's
    convolution does."""
    over = {"shadow_rays": dict(use_occlusions=True, occlusions_secondary_only=False),
            "tfilter": dict(tfilter_sigma=1.0)}.get(change, {})
    cfg = flagship.transient_material_config(batch_size=BATCH, n_bins=N_BINS, **over)
    params = flagship.flagship_transient_material_params()
    params.update(narrow(params["cache_model_params"], params["light_sampler_params"],
                         params["shader_params"]))
    if change == "share_light_power":
        params = dict(params, share_light_power=True)
    model = flagship.build_flagship_transient_material_model(cfg, params, device="cpu")
    batch = tdatasets.SyntheticSpheres("train", None, cfg, num_images=2, resolution=8,
                                       device="cpu").next_train()
    if change == "tfilter":
        model.integrator.config = model.cache.integrator.config = dataclasses.replace(
            cfg, tfilter_sigma=2.0)
        with pytest.raises(ValueError, match="17 taps is longer than the 16 time bins"):
            model(torch.Generator().manual_seed(0), batch.rays, train_frac=0.5)
        model.integrator.config = model.cache.integrator.config = cfg
    with torch.no_grad():
        render = model(torch.Generator().manual_seed(0), batch.rays, train_frac=0.5)["render"]
    assert model.share_light_power == (change == "share_light_power")
    assert all(bool(torch.isfinite(v).all()) for v in render.values()
               if isinstance(v, torch.Tensor) and v.is_floating_point())


def test_eval_render_matches_jax():
    chunk = dict(render_chunk_size=eval_slice.CHUNK)
    jcfg, tcfg, jmodel, tmodel, variables, _, _ = build(seed=7, **chunk)
    jcfg = dataclasses.replace(jcfg, **chunk)
    res = eval_slice.RES
    jview = jdatasets.SyntheticSpheres("test", None, jcfg, num_images=2,
                                       resolution=res).generate_ray_batch(0)
    tview = tdatasets.SyntheticSpheres("test", None, tcfg, num_images=2, resolution=res,
                                       device="cpu").generate_ray_batch(0)
    assert jview.rays.origins.shape[0] == 2 * eval_slice.CHUNK
    kw = dict(height=res, width=res, render_repeats=1)
    calls = []
    with eval_slice.injected(3):
        one_device = jmesh.create_mesh(jax.devices()[:1])
        want = jrenderer.render_image(jtrain.create_render_fn(jmodel, mesh=one_device), variables,
                                      jview.rays, jax.random.PRNGKey(0), jcfg, **kw)
        with eval_slice.counting_scatters(calls):
            got = trenderer.render_image(ttrain.create_render_fn(tmodel), tview.rays,
                                         torch.Generator().manual_seed(0), tcfg, device="cpu",
                                         **kw)
    assert sorted(got) == sorted(want)
    assert got["rgb"].shape == (res, res, N_BINS, 3)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        material_slice._close(got[key], w, err_msg=key, **SEC)
    assert calls == []  # no backward: the eval render launches no table-gradient scatter
