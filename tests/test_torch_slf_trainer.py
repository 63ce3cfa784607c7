"""The surface-light-field (SLF) stages of the staged trainer against the JAX
package's: the cache's SLF memory and its queries, the SLF control variate
of the material model, and the SLF distillation loss, on the same gin files,
weights and random draws.

Every SLF stage of configs/ngp_yobo.gin takes one port step (the from-scratch
ones at the trainer's default sample factor, 2: at 1 their two variate
samples per point fall below the specular lobe's two samplers, a resample
that the port refuses). material_surface_light_field_light takes one step
through both trainers on a narrow ngp_yobo.gin and on synthetic_spheres.gin
with the variate bound, with resampling (without it the variate cannot sum
into the render, in JAX either), and so does the cache-side
surface_light_field_light, whose SLF loss reads no secondary ray and is 0.
The memory's bypass pass, its query with the material shader's stop-gradient
weights and the distillation loss are held against JAX's on the same inputs.
The draws of both packages come from one numpy stream
(`test_torch_material_slice.injected`).

Tolerances (float32), as in test_torch_material_trainer.py: one train step's
loss terms to 1e-4 relative (material_smoothness to 1e-3), every gradient
leaf to rtol 2e-3 with an absolute 2e-4 x the leaf's largest entry, the
parameters after the trainer's Adam step within 2 x their group's learning
rate of optax's. The memory's query and the distillation loss on seeded
inputs (a few ops each): values and gradients to 1e-5 relative, 1e-4 through
the sRGB curve, with an absolute rtol x the largest gradient entry.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_material_slice as material_slice
import test_torch_material_trainer as material_trainer
import test_torch_trainer as trainer_test
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import configs as jconfigs
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.models import nerf_model as jnerf
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.parallel import extra_losses as jextra
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch.engine import configs as tconfigs
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.models import nerf_model as tnerf
from neural_radiance_caching_tpu_torch.parallel import extra_losses as textra
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees
from neural_radiance_caching_tpu_torch.utils import weights

TRAIN_FRAC = material_trainer.TRAIN_FRAC
LOSS = trainer_test.LOSS
GRAD = material_trainer.GRAD
UNIT = dict(rtol=1e-5, atol=1e-7)
SRGB = dict(rtol=1e-4, atol=1e-7)
RESAMPLE = ["Trainer.resample = True", "Trainer.resample_render = True"]
SLF_STAGES = ("surface_light_field", "surface_light_field_light", "material_surface_light_field",
              "material_surface_light_field_light", "material_surface_light_field_from_scratch",
              "material_surface_light_field_light_from_scratch")
NGP_SLF = trainer_test.NGP_TINY + material_trainer.MATERIAL_TINY + RESAMPLE
# (gin files, bindings) of the parity steps: sample factor 1 (8 secondary
# samples, 16 for the variate), the smoothness weights, and the irradiance
# weight of material_smoothness, which reads an irradiance_cache if the
# shader results hold one. On spheres the variate bound and a narrow memory.
SCENES = {
    "ngp_yobo": (material_trainer.NGP, NGP_SLF + material_trainer.SMOOTH + [
        "Trainer.sample_factor = 1", "Config.material_smoothness_irradiance_weight = True"]),
    "synthetic_spheres": ([trainer_test.SPHERES], trainer_test.TINY + material_trainer.MATERIAL
                          + material_trainer.SMOOTH + RESAMPLE + [
        "MaterialModel.slf_variate = True", "Config.material_ray_sampler_interlevel_loss_mult = 1.0",
        "Config.material_smoothness_irradiance_weight = True",
        "SurfaceLightFieldMLP.net_width_viewdirs = 16",
        "SurfaceLightFieldMLP.bottleneck_viewdirs = 16"]),
}
# The leveled launches of one spheres SLF step: the cache's primary samples,
# the variate's cache estimate (the main pass queries the memory, which has
# no grid), material_smoothness's "geometry" pass and the light sampler's
# grid; none on ngp_yobo.gin (density normals take the plain encoder).
STEP_LAUNCHES = {"synthetic_spheres": ["leveled"] * 4, "ngp_yobo": []}


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


def _spy_smoothness(mp, table, seen, results_arg):
    """Record whether material_smoothness finds an irradiance_cache in its
    shader results (its positional argument `results_arg`; JAX's loss would
    weight by it)."""
    fn = table["material_smoothness"]

    def spy(*args, **kwargs):
        seen.append("irradiance_cache" in args[results_arg]["shader"])
        return fn(*args, **kwargs)

    mp.setitem(table, "material_smoothness", spy)


@pytest.fixture(scope="module", params=sorted(SCENES))
def slf_step(request):
    """One material_surface_light_field_light step through both trainers
    from the same weights: JAX's losses, clipped gradients and optax
    update, and the port's losses, gradients, parameters after its Adam
    step, scatter launches and what material_smoothness saw."""
    scene = request.param
    files, bindings = SCENES[scene]
    jt, jmodel, tt = material_trainer._trainers(files, bindings,
                                                "material_surface_light_field_light")
    jcfg = jt.config
    variables = material_trainer._variables(jmodel, 5)
    jbatch = jdatasets.load_dataset("train", None, jcfg).next_train()
    jseen, tseen, calls = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        _spy_smoothness(mp, jextra.EXTRA_LOSS_FUNCTIONS, jseen, 6)
        _spy_smoothness(mp, textra.EXTRA_LOSS_FUNCTIONS, tseen, 5)
        with material_slice.injected(7), jhash.xla_encoder_scope():
            (_, jl), jgrad = material_trainer.jax_step_loss(jmodel, jcfg, TRAIN_FRAC)(
                variables, jbatch)
        jgrad = jlosses.clip_gradients(jax.tree_util.tree_map(jnp.nan_to_num, jgrad), jcfg)
        jstate, _ = jtrain.create_optimizer(jcfg, variables)
        updates, _ = jstate.tx.update(jgrad, jstate.opt_state, variables)
        tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
        material_slice._counting_scatters(mp, calls)
        with material_slice.injected(7):
            state, stats = tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), TRAIN_FRAC)
    jgin.clear_config()
    tgin.clear_config()
    params = dict(tt.model.named_parameters())
    return dict(
        scene=scene, jlosses={k: float(v) for k, v in jl.items()},
        jgrad=material_slice._leaves(jgrad["params"]),
        jnew=material_slice._leaves(optax.apply_updates(variables, updates)["params"]),
        losses={k: float(v) for k, v in stats["losses"].items()},
        grads={k: p.grad.numpy().copy() for k, p in params.items()},
        params={k: p.detach().numpy().copy() for k, p in params.items()},
        lrs={k: max(g["lr"] for g in state.optimizer.param_groups
                    if any(q is p for q in g["params"])) for k, p in params.items()},
        calls=calls, jseen=jseen, tseen=tseen)


def test_slf_step_loss_terms_match_jax(slf_step):
    got, want = slf_step["losses"], slf_step["jlosses"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        tol = material_trainer.SMOOTHNESS_LOSS if k.endswith("smoothness") else LOSS
        np.testing.assert_allclose(got[k], v, err_msg=k, **tol)
    extra = ["material_ray_sampler", "material_smoothness", "light_sampling",
             "material_surface_light_field"]
    assert [k for k in got if k in extra] == extra
    assert "surface_light_field" not in got and got["material_surface_light_field"] > 0
    assert all(np.isfinite(v) for v in got.values())


def test_slf_step_gradients_match_jax(slf_step):
    grads, want = slf_step["grads"], slf_step["jgrad"]
    assert sorted(grads) == sorted(want)
    assert any(k.startswith("cache.surface_lf_mem.") for k in grads)
    for k, g in grads.items():
        material_slice._close(g, material_slice._tr(k, want[k]), *GRAD, k)
    # The distillation loss trains the memory.
    assert np.abs(grads["cache.surface_lf_mem.output_rgba_layer.weight"]).max() > 0


def test_slf_step_adam_matches_optax(slf_step):
    for k, p in slf_step["params"].items():
        np.testing.assert_allclose(p, material_slice._tr(k, slf_step["jnew"][k]), rtol=0,
                                   atol=2 * slf_step["lrs"][k] + 1e-7, err_msg=k)


def test_slf_step_launches_and_unit_irradiance(slf_step):
    """The leveled launches of the step, each a kernel launch on the card;
    and no irradiance_cache in the shader results material_smoothness
    reads, in either package: the variate's shader pass makes one, and only
    its ref_* outputs are copied over (so its irradiance weight is unit)."""
    assert slf_step["calls"] == STEP_LAUNCHES[slf_step["scene"]]
    assert slf_step["jseen"] == slf_step["tseen"] == [False]


def test_slf_memory_takes_the_cache_learning_rate_group():
    """The memory's path, Cache/SurfaceLightFieldMem, has no component named
    SurfaceLightField: optax gives it the Cache schedule, and so does the
    port; a stage without optimize_surface_light_field zeroes it."""
    files, bindings = SCENES["ngp_yobo"]
    _, _, tt = material_trainer._trainers(files, bindings, "material_surface_light_field_light")
    names = {k: g["name"] for g in tt.state.optimizer.param_groups for k, p in
             tt.model.named_parameters() if any(q is p for q in g["params"])}
    mem = [k for k in names if k.startswith("cache.surface_lf_mem.")]
    assert mem and {names[k] for k in mem} == {"Cache"}
    # A stage that does not optimise the memory zeroes its schedule.
    tt = trainer_test.synthesize("torch", files, bindings, "material_light_from_scratch")
    assert tt.extra_opt_params["SurfaceLightFieldMem"]["lr_init"] == 0.0


def test_warm_start_from_a_cache_checkpoint_keeps_the_memory_at_init():
    """A cache-stage checkpoint holds no memory: the SLF material stage's
    warm start fills the cache from it and leaves the memory as it was
    built, as JAX's partial restore does."""
    from neural_radiance_caching_tpu_torch.parallel import train as ttrain

    def model(stage):
        tt = trainer_test.synthesize("torch", material_trainer.NGP, NGP_SLF, stage)
        tt._setup_rng()
        tt._load_datasets()
        tt._setup_model()
        return tt

    source = model("cache").model.state_dict()
    tt = model("material_surface_light_field_light")
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}
    ttrain.restore_partial_checkpoint(tt.model, source, prefixes=tt.prefixes,
                                      exclude_prefixes=tuple(tt.exclude_prefixes),
                                      replace_dict=tt.replace_dict, source_material=True)
    after = tt.model.state_dict()
    mem = [k for k in after if k.startswith("cache.surface_lf_mem.")]
    assert mem and not any(k in source for k in mem)
    for k, v in after.items():
        assert torch.equal(v, source[k] if k in source else before[k]), k


@pytest.mark.parametrize("stage", SLF_STAGES)
def test_ngp_yobo_slf_stage_steps(stage):
    """Each SLF stage of ngp_yobo.gin at test widths: one port step, every
    loss term finite; the material stages' distillation loss positive, the
    cache-side stages' 0 (no material pass, no secondary ray)."""
    tt = trainer_test.synthesize("torch", material_trainer.NGP, NGP_SLF, stage)
    tt._setup_rng()
    tt._load_datasets()
    tt._setup_model()
    material = stage.startswith("material")
    assert hasattr(tt.model.cache, "surface_lf_mem") == material
    _, stats = tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), TRAIN_FRAC)
    losses = {k: float(v) for k, v in stats["losses"].items()}
    assert all(np.isfinite(v) for v in losses.values()), losses
    assert (losses["material_surface_light_field"] > 0) == material


def test_cache_side_slf_stage_matches_jax(monkeypatch):
    """surface_light_field_light on ngp_yobo.gin: a cache with no material
    pass, so no memory parameters (JAX's module creates them at their first
    query), the SLF loss 0; every loss term, leaf and the Adam step."""
    jt, jmodel, tt = material_trainer._trainers(material_trainer.NGP, NGP_SLF,
                                                "surface_light_field_light")
    variables = material_trainer._variables(jmodel, 5)
    assert "SurfaceLightFieldMem" not in variables["params"]["Cache"]
    got = material_trainer._step_parity(jt, jmodel, tt, variables, monkeypatch, [])
    assert got["material_surface_light_field"] == 0.0 and got["light_sampling"] == 0.0


# --- the memory's query and the variate on seeded inputs --------------------------------


def _rays(rng, lead):
    """The same rays in both packages, every field of shape lead + [...]."""
    def unit(n):
        v = rng.randn(*lead, n).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    f = dict(origins=rng.uniform(-1, 1, lead + (3,)), directions=unit(3), radii=np.full(
        lead + (1,), 0.01), lights=rng.uniform(-2, 2, lead + (3,)),
        imageplane=rng.uniform(0, 1, lead + (2,)), look=unit(3), up=unit(3),
        cam_origins=rng.uniform(-2, 2, lead + (3,)), vcam_look=unit(3), vcam_up=unit(3),
        vcam_origins=rng.uniform(-2, 2, lead + (3,)), lossmult=np.ones(lead + (1,)),
        near=np.full(lead + (1,), 0.2), far=np.full(lead + (1,), 6.0))
    f = {k: np.asarray(v, np.float32) for k, v in f.items()}
    f["viewdirs"] = f["directions"]
    idx = np.zeros(lead + (1,), np.int32)
    return (jpytrees.Rays(cam_idx=jnp.asarray(idx), light_idx=jnp.asarray(idx),
                          **{k: jnp.asarray(v) for k, v in f.items()}),
            tpytrees.Rays(cam_idx=torch.as_tensor(idx), light_idx=torch.as_tensor(idx),
                          **{k: torch.tensor(v, requires_grad=True) for k, v in f.items()}))


@pytest.mark.parametrize("stopgrad", [(1.0, 1.0), (0.5, 0.25)])
def test_get_slf_results_matches_jax(stopgrad):
    """The memory (ngp_yobo.gin's, narrow) queried along secondary rays
    [P, S] with the material shader's stopgrad_slf_weight: every output, and
    the gradients of a weighted sum of rgb and its unscaled twin with
    respect to the memory's parameters and the rays' origins, directions and
    lights (the outputs' half of the weight applies; the rays' does not)."""
    jcfg = trainer_test.synthesize("jax", material_trainer.NGP, NGP_SLF,
                                   "material_surface_light_field").config
    tt = trainer_test.synthesize("torch", material_trainer.NGP, NGP_SLF,
                                 "material_surface_light_field")
    jmodel = jnerf.NeRFModel(config=jcfg, use_surface_light_field=True)
    tmodel = tnerf.NeRFModel(config=tt.config, use_surface_light_field=True)
    rng = np.random.RandomState(4)
    jrays, trays = _rays(rng, (5, 4))
    kw = dict(use_slf=True, train=True, train_frac=TRAIN_FRAC, stopgrad_cache_weight=stopgrad)
    key = jax.random.PRNGKey(0)
    jvars = jmodel.init(key, key, jrays, **kw)
    assert list(jvars["params"]) == ["SurfaceLightFieldMem"]
    jvars = material_slice.random_variables(jvars, 3)
    tmodel.surface_lf_mem.load_state_dict(weights.state_dict_from_jax(
        jvars["params"]["SurfaceLightFieldMem"], tmodel.surface_lf_mem))
    a = rng.uniform(-1, 1, (5, 4, 1, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (5, 4, 1, 3)).astype(np.float32)

    def jfn(v, origins, viewdirs, lights):
        rays = jrays.replace(origins=origins, viewdirs=viewdirs, lights=lights)
        out = jmodel.apply(v, key, rays, **kw)
        return (out["rgb"] * a).sum() + (out["rgb_no_stopgrad"] * b).sum(), out

    jargs = (jvars, jrays.origins, jrays.viewdirs, jrays.lights)
    (_, jout), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3), has_aux=True)(*jargs)
    tout = tmodel(None, trays, **kw)
    assert sorted(tout) == sorted(jout)
    for k, v in jout.items():
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(v), err_msg=k, **UNIT)
    tloss = (tout["rgb"] * torch.as_tensor(a)).sum() + (
        tout["rgb_no_stopgrad"] * torch.as_tensor(b)).sum()
    params = dict(tmodel.surface_lf_mem.named_parameters())
    tg = torch.autograd.grad(tloss, list(params.values()) + [trays.origins, trays.viewdirs,
                                                              trays.lights], allow_unused=True)
    want = material_slice._leaves(jg[0]["params"]["SurfaceLightFieldMem"])
    assert sorted(params) == sorted(want)
    for (k, v), g in zip(params.items(), tg):
        # The ambient trunk feeds no output of the query: no gradient.
        g = torch.zeros_like(v) if g is None else g
        material_slice._close(g.numpy(), material_slice._tr(k, want[k]), UNIT["rtol"],
                              UNIT["rtol"], k)
    for name, g, w in zip(("origins", "viewdirs", "lights"), tg[len(params):], jg[1:]):
        g = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        material_slice._close(g, np.asarray(w), UNIT["rtol"], UNIT["rtol"], name)


@pytest.mark.parametrize("passes", [("surface_light_field",),
                                    ("cache", "light", "material", "surface_light_field_vis")])
def test_slf_passes_match_jax(passes):
    """The memory's bypass pass along the primary rays, every output against
    JAX's; and the full pass that also reports the memory's radiance, as
    the render's cache_incoming_* keys, against the bypass's."""
    files, bindings = SCENES["synthetic_spheres"]
    jt, jmodel, tt = material_trainer._trainers(files, bindings,
                                                "material_surface_light_field_light")
    variables = material_trainer._variables(jmodel, 5)
    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    jbatch = jdatasets.load_dataset("train", None, jt.config).next_train()
    tbatch = tt.dataset.next_train()
    kw = dict(train_frac=TRAIN_FRAC, train=True, compute_extras=False)
    with material_slice.injected(4), torch.no_grad():
        tout = tt.model(torch.Generator(), tbatch.rays, passes=passes, **kw)
    if passes == ("surface_light_field",):
        with material_slice.injected(4), jhash.xla_encoder_scope():
            jout = jax.jit(lambda v, rays: jmodel.apply(v, jax.random.PRNGKey(0), rays,
                                                        passes=passes, **kw))(variables,
                                                                              jbatch.rays)
        assert sorted(tout) == sorted(jout)
        for k, v in jout.items():
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(v), err_msg=k, **UNIT)
        return
    with torch.no_grad():
        slf = tt.model(torch.Generator(), tbatch.rays, passes=("surface_light_field",), **kw)
    render = tout["render"]
    for k in ("incoming_rgb", "incoming_acc", "incoming_s_dist"):
        torch.testing.assert_close(render[f"cache_{k}"],
                                   slf[k].reshape(render["rgb"].shape[:-1] + (-1,)))


# --- the distillation loss on seeded inputs -----------------------------------------------

SLF_LOSS = {
    "defaults": {},
    "finite far and radius": dict(surface_light_field_loss_far=3.0,
                                  surface_light_field_loss_radius=0.9),
    "above the surface": dict(surface_light_field_is_secondary=True),
    "depth within the env distance": dict(surface_light_field_loss_depth_scale=0.5,
                                          env_map_distance=2.5),
    "forward gradient, diffuse lobe only": dict(surface_light_field_stopgrad_weight_forward=0.5),
}


@pytest.mark.parametrize("variant", sorted(SLF_LOSS))
def test_material_surface_light_field_loss_matches_jax(variant):
    """The loss on the same shader records in both packages (points [P, n],
    a 3-level secondary sampler): its value, and its gradients with respect
    to the memory's and the cache's radiance."""
    rng = np.random.RandomState(5)
    p, n, s = 6, 4, 5
    kw = dict(surface_light_field_loss_type="mse", surface_light_field_linear_to_srgb=True,
              surface_light_field_loss_acc_scale_opaque=0.125,
              surface_light_field_loss_acc_scale_empty=0.25, mask_lossmult=True,
              **SLF_LOSS[variant])
    jcfg, tcfg = jconfigs.Config(**kw), tconfigs.Config(**kw)
    lobes = ("_indirect_diffuse",) if "diffuse lobe only" in variant else (
        "_indirect_diffuse", "_indirect_specular")
    radiance = {}
    records = {}
    for suffix in lobes:
        for side in ("_cache", "_slf"):
            radiance[suffix + side] = rng.uniform(0, 2, (p, n, 3)).astype(np.float32)
        tdist = np.sort(rng.uniform(0, 4, (p, n, s + 1)), axis=-1).astype(np.float32)
        records[suffix] = dict(
            origins=rng.uniform(-1, 1, (p, n, 3)).astype(np.float32),
            local_lightdirs=rng.randn(p, n, 3).astype(np.float32),
            weights=rng.uniform(0, 0.3, (p, n, s)).astype(np.float32), tdist=tdist,
            sdist=tdist / 4.0, incoming_weights=np.ones((p, n, 1, 1), np.float32),
            incoming_dist=np.zeros((p, n, 1, 1), np.float32),
            incoming_s_dist=rng.uniform(0, 1, (p, n, 1, 1)).astype(np.float32))

    def shader(pkg, rad):
        conv = jnp.asarray if pkg == "jax" else torch.as_tensor
        rays_cls = jpytrees.Rays if pkg == "jax" else tpytrees.Rays
        out = {}
        for suffix, r in records.items():
            zeros = conv(np.zeros((p, n, 1), np.float32))
            rays = rays_cls(**{f.name: zeros for f in dataclasses.fields(rays_cls)
                               if f.default is dataclasses.MISSING})
            out[f"ref_rays{suffix}_cache"] = rays.replace(origins=conv(r["origins"]))
            out[f"ref_samples{suffix}_cache"] = {
                "radiance_in_no_stopgrad": rad[suffix + "_cache"],
                "local_lightdirs": conv(r["local_lightdirs"])}
            out[f"ref_samples{suffix}_slf"] = {"radiance_in_no_stopgrad": rad[suffix + "_slf"]}
            out[f"ref_sampler_results{suffix}_cache"] = [
                {k: conv(r[k]) for k in ("weights", "tdist", "sdist")}]
            out[f"ref_sampler_results{suffix}_slf"] = [
                {k: conv(r[k]) for k in ("incoming_weights", "incoming_dist", "incoming_s_dist")}]
        return out

    jbatch = jpytrees.Batch(rays=None, rgb=jnp.zeros((p, 3)))
    tbatch = tpytrees.Batch(rays=None, rgb=torch.zeros((p, 3)))

    def jfn(rad):
        return jextra.material_surface_light_field_loss(
            None, None, None, None, jcfg, jbatch, {"shader": shader("jax", rad)}, None)

    jrad = {k: jnp.asarray(v) for k, v in radiance.items()}
    trad = {k: torch.tensor(v, requires_grad=True) for k, v in radiance.items()}
    want, jg = jax.value_and_grad(jfn)(jrad)
    tloss = textra.material_surface_light_field_loss(None, None, None, tcfg, tbatch,
                                                     {"shader": shader("torch", trad)}, None)
    assert float(want) > 0
    np.testing.assert_allclose(tloss.item(), float(want), **SRGB)
    tg = torch.autograd.grad(tloss, list(trad.values()), allow_unused=True)
    for (k, v), g in zip(trad.items(), tg):
        g = np.zeros(v.shape, np.float32) if g is None else g.numpy()
        material_slice._close(g, np.asarray(jg[k]), SRGB["rtol"], SRGB["rtol"], k)
    assert textra.material_surface_light_field_loss(None, None, None, tcfg, tbatch,
                                                    {"shader": {}}, None) == 0.0


def test_surface_light_field_weight_ease_matches_jax():
    for kw in (dict(use_surface_light_field_weight_ease=True,
                    surface_light_field_weight_ease_start=0.1,
                    surface_light_field_weight_ease_frac=0.4,
                    surface_light_field_weight_ease_min=0.2),
               dict(use_surface_light_field_weight_ease=True,
                    surface_light_field_weight_ease_start=0.3), {}):
        for frac in (0.0, 0.2, 0.35, 0.9):
            want = jextra.surface_light_field_weight_ease(jconfigs.Config(**kw),
                                                          jnp.float32(frac))
            got = textra.surface_light_field_weight_ease(tconfigs.Config(**kw), frac)
            np.testing.assert_allclose(got, float(want), rtol=1e-6, err_msg=f"{kw} {frac}")


# --- what the JAX package cannot run ---------------------------------------------------


def test_the_variate_without_resampling_raises():
    """Without Trainer.resample every cache sample is a surface point: the
    JAX model's reshape of the variate to one point per ray fails, and the
    port raises naming it."""
    bindings = [b for b in NGP_SLF if not b.startswith("Trainer.resample")]
    tt = trainer_test.synthesize("torch", material_trainer.NGP, bindings,
                                 "material_surface_light_field_light")
    tt._setup_rng()
    tt._load_datasets()
    tt._setup_model()
    with pytest.raises(NotImplementedError, match=re.escape("material_model.py:577")):
        tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), TRAIN_FRAC)


def test_a_transient_slf_query_raises():
    """The transient cache builds no memory, and a query of one raises
    naming the JAX package's missing get_slf_results (cornell's material
    SLF stages: test_torch_transient_material_trainer.py)."""
    assert not tnerf.TransientNeRFModel._has_surface_lf_mem
    with pytest.raises(NotImplementedError, match="no get_slf_results"):
        tnerf.TransientNeRFModel.get_slf_results(None, None, None, TRAIN_FRAC, True)


def test_material_ray_sampler_on_slf_queries_raises():
    """An SLF material stage without the variate (synthetic_spheres.gin's):
    the main pass's secondary rays query the memory and keep no sampler
    weights, where JAX's loss raises KeyError."""
    bindings = trainer_test.TINY + material_trainer.MATERIAL + RESAMPLE
    tt = trainer_test.synthesize("torch", [trainer_test.SPHERES], bindings,
                                 "material_surface_light_field_light")
    assert not tt.config.extra_losses.get("material_surface_light_field")
    tt._setup_rng()
    tt._load_datasets()
    tt._setup_model()
    with pytest.raises(NotImplementedError, match="KeyError 'weights'"):
        tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), TRAIN_FRAC)
