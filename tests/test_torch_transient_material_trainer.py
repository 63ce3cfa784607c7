"""The staged trainer's transient (InvProp) material stages against the JAX
package's, on configs/transient_simulation_ngp_yobo_cornell.gin at test
widths (`test_torch_transient_trainer.TRANSIENT_TINY`, with a narrow light
sampler and material shader): material_light_from_scratch and
material_light_finetune, the second with its shadow rays. Cases: the
secondary queries' shared light power, the `shadow_eps_indirect` near offset
of secondary rays, the secondary queries' shadow rays and the surface
points' stored occlusion, one step of each stage through both trainers, the
CPU entry point (cache, then from scratch, then finetune, a resume and an
eval view), a narrow step of pots, kitchen and peppers, and the fields the
JAX package declares and never reads (accepted, read by nothing here).

Every uniform, normal and categorical draw of both packages comes from one
numpy stream (`test_torch_material_slice.injected`), in the order both take
them. Weights are drawn from U(-0.5, 0.5), the hash tables from the grid's
own init range U(-1e-4, 1e-4), as a stage starts them.

Tolerances (float32), those of `tests/test_torch_transient_trainer.py`:
the secondary queries on the same inputs to 1e-4 relative with an absolute
1e-6 x the largest entry (their compositing weights 1e-5, WEIGHTS_ATOL);
loss terms to 1e-4 relative with an absolute 1e-7 (material_smoothness, an
L1 of differences of heads at points 0.1 apart, to 1e-3, as in the material
trainer's tests); every gradient leaf to rtol 2e-3 with an absolute 2e-4 x
the leaf's largest entry; after the trainer's Adam step a parameter within
2 x its group's learning rate of optax's. The memory trims hold losses bit
for bit and leaves to TRIM_GRAD_ATOL.
"""

import ast
import dataclasses
import functools
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_material_slice as material_slice
import test_torch_material_trainer as material_trainer
import test_torch_trainer as trainer_test
import test_torch_transient_trainer as transient_trainer
from neural_radiance_caching_tpu.data import camera_utils as jcam
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.parallel import extra_losses as jextra
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu_torch import train_with_trainer
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.models import construct as tconstruct
from neural_radiance_caching_tpu_torch.models import integrator as tintegrator
from neural_radiance_caching_tpu_torch.models import layers as tlayers
from neural_radiance_caching_tpu_torch.ops import render as trender
from neural_radiance_caching_tpu_torch.parallel import train as ttrain
from neural_radiance_caching_tpu_torch.utils import checkpoints as tckpt
from neural_radiance_caching_tpu_torch.utils import weights

CORNELL = transient_trainer.CORNELL
TRAIN_FRAC = 0.25
LOSS = trainer_test.LOSS
SMOOTHNESS_LOSS = material_trainer.SMOOTHNESS_LOSS
GRAD = material_trainer.GRAD
# The cornell material stages at test widths: the narrow cache of the cache
# stage's tests, a narrow light sampler and material shader, the secondary
# rays' cache queries on the narrow sampling strategy, four secondary rays
# per surface point (two per lobe).
MATERIAL_TINY = transient_trainer.TRANSIENT_TINY + [
    "Trainer.resample = True", "Trainer.sample_factor = 1",
    "LightMLP.num_components = 8", "LightMLP.net_width = 16", "LightMLP.bottleneck_width = 16",
    "TransientMaterialMLP.net_width = 16", "TransientMaterialMLP.bottleneck_width = 16",
    f"TransientMaterialMLP.grid_params = {{{transient_trainer.GRID}, 'num_features': 4}}",
    f"TransientMaterialMLP.cache_train_sampling_strategy = {transient_trainer.STRATEGY}",
    f"TransientMaterialMLP.cache_render_sampling_strategy = {transient_trainer.STRATEGY}",
    "LightSourceMap.net_width = 16",
]
OCCLUSIONS = transient_trainer.OCCLUSIONS
STAGES = {"from_scratch": "material_light_from_scratch", "finetune": "material_light_finetune"}
NOCORR_KEYS = material_trainer.NOCORR_KEYS


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


def jax_step_loss(jmodel, jcfg, dataset, train_frac):
    """The JAX train step's loss (`parallel/train.py` without the mesh): the
    in-step cast, the forward, the debias forward and its `_nocorr` grafts,
    per *main output its losses and extra losses, the regularizers."""
    cams = transient_trainer._jax_cameras(dataset)

    def loss_fn(variables, batch):
        rng = jax.random.PRNGKey(0)
        rays = jcam.cast_ray_batch(
            cams["cameras"], cams["lights"], batch.rays, rng=jax.random.fold_in(rng, 0xCA57),
            jitter=jcfg.jitter_rays, xnp=jnp, impulse_response=cams["impulse_response"])
        batch = batch.replace(rays=rays)
        kw = dict(train_frac=train_frac, train=True, compute_extras=False)
        results = jmodel.apply(variables, rng, rays, **kw)
        nocorr = jmodel.apply(
            variables, jax.random.fold_in(rng, 0x5EED), rays,
            cache_outputs={"sampler": results["cache_main"]["sampler"]},
            filtered_sampler_inds=results["cache_main"]["filtered_sampler_inds"], **kw)
        results["render"]["rgb_nocorr"] = nocorr["render"]["rgb"]
        for out_key in ("main", "cache_main"):
            shader, nocorr_shader = results[out_key]["shader"], nocorr[out_key]["shader"]
            for k in NOCORR_KEYS:
                if k in nocorr_shader:
                    shader[k + "_nocorr"] = nocorr_shader[k]
        losses, stats = {}, {}
        for i, key in enumerate(sorted(k for k in results if k.endswith("main"))):
            jtrain._compute_losses_for_output(None, batch, rays, results, jcfg, train_frac, key,
                                              losses, stats)
            jextra.compute_extra_losses(jmodel, variables, jax.random.fold_in(rng, 7919 + i),
                                        rays, jcfg, batch, results, key, losses, train_frac)
        for k, v in jlosses.param_regularizer_loss(variables, jcfg).items():
            losses["regularizer_" + k] = v
        return sum(jax.tree_util.tree_leaves(losses)), losses

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _binned_radiance_summed(light_sampling_loss):
    """JAX's light_sampling_loss reshapes every record of the secondary
    samples to [rays, samples, d], which the time-binned radiance of a
    transient lobe cannot take (it raises); it reads that radiance summed
    over the bins, so it is handed the sum. The port's loss reads the same
    sum and the records it fits (pdf, weight)."""
    def loss(model, variables, rng, rays, config, batch, results, full_results, **kwargs):
        shader = dict(results["shader"])
        for k, v in results["shader"].items():
            if k.startswith("ref_samples_indirect"):
                shader[k] = {n: x.sum(-2) if x.ndim == 4 else x for n, x in v.items()}
        return light_sampling_loss(model, variables, rng, rays, config, batch,
                                   dict(results, shader=shader), full_results, **kwargs)

    return loss


def _stage(stage, extra=(), files=CORNELL):
    """(JAX trainer, JAX model, port trainer) of a narrow cornell material
    stage."""
    return material_trainer._trainers(files, MATERIAL_TINY + list(extra), STAGES[stage])


def _step_parity(jt, jmodel, tt, variables, monkeypatch, grads=None):
    """One step through both trainers from `variables`: every loss term,
    every gradient leaf, and the Adam step against optax. Returns the
    losses and the scatter launches of the port's step; with `grads`, a
    dict, both packages' gradient leaves are kept there ("jax", "port")."""
    jcfg = jt.config
    monkeypatch.setitem(jextra.EXTRA_LOSS_FUNCTIONS, "light_sampling",
                        _binned_radiance_summed(jextra.light_sampling_loss))
    jdata = jdatasets.load_dataset("train", None, jcfg)
    jbatch = jdata.next_train()
    with material_slice.injected(7), jhash.xla_encoder_scope():
        (_, jlosses_), jgrad = jax_step_loss(jmodel, jcfg, jdata, TRAIN_FRAC)(variables, jbatch)
    jgrad = jlosses.clip_gradients(jax.tree_util.tree_map(jnp.nan_to_num, jgrad), jcfg)
    jstate, _ = jtrain.create_optimizer(jcfg, variables)
    updates, _ = jstate.tx.update(jgrad, jstate.opt_state, variables)
    jnew = material_slice._leaves(optax.apply_updates(variables, updates)["params"])

    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    calls = []
    material_slice._counting_scatters(monkeypatch, calls)
    with material_slice.injected(7):
        state, stats = tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), TRAIN_FRAC)

    got = {k: float(v) for k, v in stats["losses"].items()}
    assert sorted(got) == sorted(jlosses_)
    for k, v in jlosses_.items():
        np.testing.assert_allclose(got[k], float(v), err_msg=k,
                                   **(SMOOTHNESS_LOSS if k.endswith("smoothness") else LOSS))
    want = material_slice._leaves(jgrad["params"])
    params = dict(tt.model.named_parameters())
    assert sorted(params) == sorted(want)
    if grads is not None:
        grads["jax"] = {k: material_slice._tr(k, np.asarray(want[k])) for k in params}
        grads["port"] = {k: p.grad.numpy().copy() for k, p in params.items()}
    for k, p in params.items():
        material_slice._close(p.grad.numpy(), material_slice._tr(k, want[k]), *GRAD, k)
    for k, p in params.items():
        lr = max(g["lr"] for g in state.optimizer.param_groups
                 if any(q is p for q in g["params"]))
        np.testing.assert_allclose(p.detach().numpy(), material_slice._tr(k, jnew[k]),
                                   rtol=0, atol=2 * lr + 1e-7, err_msg=k)
    return got, calls


@pytest.mark.parametrize("stage", ["from_scratch", "finetune"])
def test_one_cornell_material_step_through_both_trainers(stage, monkeypatch):
    """A narrow cornell material stage, one step through both trainers: from
    scratch (shared light power, shadow_eps_indirect, the stage's extra
    losses, geometry smoothness on the cache), and finetune (shadow rays from
    the surface points and from every secondary query, the occlusion
    threshold at 0 so that each one reaches the light)."""
    jt, jmodel, tt = _stage(stage, OCCLUSIONS[3:] if stage == "finetune" else ())
    cfg = tt.config
    assert cfg.use_occlusions == (stage == "finetune")
    assert tt.model.share_light_power and tt.model.shader.shadow_eps_indirect
    variables = material_trainer._variables(jmodel, 5)
    got, calls = _step_parity(jt, jmodel, tt, variables, monkeypatch)
    extra = {"material_ray_sampler", "material_smoothness", "light_sampling",
             "direct_indirect_consistency", "regularizer_density_grid"}
    assert extra <= set(got)
    assert ("cache_geometry_smoothness" in got) == (stage == "from_scratch")
    assert got["light_sampling"] != 0 and got["material_smoothness"] != 0
    # The leveled kernel (its plain version here): the cache shader's
    # appearance grid on the primary samples and on the secondary queries,
    # the material shader's grid, and the grids of the light sampler and of
    # material_smoothness's perturbed material heads; no shadow pass adds one.
    assert calls and set(calls) == {"leveled"}


# --- the secondary queries on the same inputs ------------------------------------------

# Per case: the bindings of the narrow from-scratch stage, and the toggle
# whose effect the case shows in the port (the same query without it must
# differ). The occlusion case takes the finetune stage's bindings, with the
# threshold at 0 and the shadow rays' near bound at 0.02 (the narrow
# cache's shadow opacities are small).
QUERY_CASES = {
    "shared_light_power": ([], ("model", "share_light_power", False)),
    "shadow_eps_indirect": ([], ("shader", "shadow_eps_indirect", False)),
    "secondary_occlusions": (OCCLUSIONS + ["Config.shadow_near_min = 0.02",
                                           "Config.shadow_near_max = 0.02"],
                             ("config", "use_occlusions", False)),
}
NUM_SECONDARY = 4
# The compositing weights of samples whose opacity 1 - exp(-x) is under
# ~1e-6 are multiples of float32's spacing below 1 (6e-8), and XLA's exp and
# torch's differ by a few ulps there: they agree to 1e-5 of the largest
# weight (the others to 1e-4 relative).
WEIGHTS_ATOL = 1e-5


def _secondary_rays(trays, seed):
    """Surface points on the primary rays (t in [1.5, 4.5]), unit normals
    facing the camera and NUM_SECONDARY rays from each point into the
    normal's hemisphere, as (points [N, 1, 3], normals [N, 1, 3], secondary
    rays [N, S]): every field of the primary rays broadcast over S, the
    origins, directions and view directions replaced, near 0.05."""
    rng = np.random.RandomState(seed)
    n = trays.origins.shape[0]
    t = rng.uniform(1.5, 4.5, (n, 1, 1)).astype(np.float32)
    points = trays.origins.numpy()[:, None] + t * trays.viewdirs.numpy()[:, None]
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)  # noqa: E731
    normals = unit(rng.normal(size=(n, 1, 3)) - 2 * trays.viewdirs.numpy()[:, None])
    dirs = unit(rng.normal(size=(n, NUM_SECONDARY, 3)))
    dirs = np.where((dirs * normals).sum(-1, keepdims=True) < 0, -dirs, dirs).astype(np.float32)
    fields = {}
    for f in dataclasses.fields(trays):
        x = getattr(trays, f.name)
        if isinstance(x, torch.Tensor) and x.shape[:1] == (n,):
            x = x[:, None].expand((n, NUM_SECONDARY) + tuple(x.shape[1:])).contiguous()
        fields[f.name] = x
    fields.update(origins=torch.as_tensor(np.broadcast_to(points, dirs.shape).copy()),
                  directions=torch.as_tensor(dirs), viewdirs=torch.as_tensor(dirs),
                  near=torch.full((n, NUM_SECONDARY, 1), 0.05))
    ref = type(trays)(**fields)
    return points.astype(np.float32), normals.astype(np.float32), ref


@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_secondary_queries_match_jax(case):
    """The material shader's secondary queries through the cache (its
    radiance-cache closure) on given surface points and rays, in both
    packages: the radiance [N, S, bins, C] and the per-level samples. Cases:
    lit by the material shader's power (share_light_power; the cache's own
    power differs), with the rays' near bound pushed off the surface along
    its normal (shadow_eps_indirect), and with a shadow ray from the point
    each query resamples (the finetune bindings)."""
    bindings, (owner, field, off) = QUERY_CASES[case]
    jt, jmodel, tt = _stage("from_scratch", bindings)
    variables = material_trainer._variables(jmodel, 5)
    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    tmodel = tt.model
    assert tmodel.share_light_power and tmodel.shader.shadow_eps_indirect
    jrays, trays = transient_trainer._rays(tt)
    points, normals, ref_rays = _secondary_rays(trays, 3)
    jref = jrays.replace(**{f.name: jnp.asarray(getattr(ref_rays, f.name).numpy())
                            for f in dataclasses.fields(ref_rays)
                            if getattr(ref_rays, f.name) is not None})
    jsr = {"points": jnp.asarray(points), "normals": jnp.asarray(normals)}

    def query(module, rays, ref, sr):
        fn = module.shader._make_radiance_cache_fn(rays, sr, module, None, TRAIN_FRAC, True)
        rgb, _, srs = fn(jax.random.PRNGKey(0), ref, None, None)
        return rgb, [{k: level[k] for k in ("tdist", "weights")} for level in srs]

    with material_slice.injected(11), jhash.xla_encoder_scope():
        want_rgb, want_srs = jax.jit(lambda v: jmodel.apply(
            v, jrays, jref, jsr, method=query))(variables)
    tsr = {"points": torch.as_tensor(points), "normals": torch.as_tensor(normals)}

    def port():
        fn = tmodel.shader._make_radiance_cache_fn(tmodel, tsr, TRAIN_FRAC, True)
        with material_slice.injected(11), torch.no_grad():
            return fn(tt.rng, ref_rays)

    rgb, _, srs = port()
    assert rgb.shape == (16, NUM_SECONDARY, tt.config.n_bins, 3)
    material_slice._close(rgb.numpy(), np.asarray(want_rgb), 1e-4, 1e-6, "rgb")
    for i, (g, w) in enumerate(zip(srs, want_srs)):
        material_slice._close(g["tdist"].numpy(), np.asarray(w["tdist"]), 1e-4, 1e-6,
                              f"level {i} tdist")
        material_slice._close(g["weights"].numpy(), np.asarray(w["weights"]), 1e-4,
                              WEIGHTS_ATOL, f"level {i} weights")
    # The case's toggle moves the query.
    target = {"model": tmodel, "shader": tmodel.shader, "config": tt.config}[owner]
    old = getattr(target, field)
    object.__setattr__(target, field, off)
    try:
        rgb_off, _, srs_off = port()
    finally:
        object.__setattr__(target, field, old)
    if case == "shadow_eps_indirect":
        facing = (ref_rays.viewdirs.numpy() * normals).sum(-1) > 0
        assert np.all(srs[0]["tdist"].numpy()[..., 0][facing]
                      >= srs_off[0]["tdist"].numpy()[..., 0][facing])
        assert not torch.equal(srs[0]["tdist"], srs_off[0]["tdist"])
    else:
        assert not torch.allclose(rgb, rgb_off)
    if case == "secondary_occlusions":
        # A shadow ray darkens, never brightens, the secondary radiance.
        assert np.all(rgb.sum(dim=(-1, -2)).numpy() <= rgb_off.sum(dim=(-1, -2)).numpy() + 1e-6)


# --- the entry point and the other scenes ------------------------------------------------


def _main(stage, ckpt, *extra):
    """train_with_trainer on a narrow cornell stage on the CPU, one step."""
    args = ["--device", "cpu", f"--gin_configs={CORNELL[0]}"] + [
        f"--gin_bindings={b}" for b in MATERIAL_TINY + [
            f"Trainer.stage = '{stage}'", f"Config.checkpoint_dir = '{ckpt}'",
            "Config.early_exit_steps = 1", "Trainer.save_results = False",
            "Config.metric_harness_train_config = {'disable_lpips': True}", *extra]]
    trainer = train_with_trainer.main(args)
    tgin.clear_config()
    return trainer


def test_cornell_entry_point_trains_both_material_stages(tmp_path):
    """train_with_trainer on the CPU: the cache stage, then
    material_light_from_scratch warm-started from it (the cache loaded, the
    material heads at their init, as JAX's partial restore leaves them),
    then material_light_finetune warm-started from that (with its shadow
    rays), a second finetune run that resumes and takes no step, and one
    test view of the material model cast on the host."""
    cache, scratch, finetune = (str(tmp_path / n) for n in ("cache", "scratch", "finetune"))
    _main("cache", cache)
    source = tckpt.load_params(cache)

    warm = [f"Config.partial_checkpoint_dir = '{cache}'"]
    jt = trainer_test.synthesize("jax", CORNELL, MATERIAL_TINY + warm, STAGES["from_scratch"])
    tt = trainer_test.synthesize("torch", CORNELL, MATERIAL_TINY + warm, STAGES["from_scratch"])
    tt._setup_rng()
    tt._load_datasets()
    tt._setup_model()
    fresh = {k: v.clone() for k, v in tt.model.state_dict().items()}
    exclude = tuple(tt.exclude_prefixes)
    assert "params/MaterialShader" in exclude
    ttrain.restore_partial_checkpoint(tt.model, source["model"], prefixes=tt.prefixes,
                                      exclude_prefixes=exclude, replace_dict=tt.replace_dict,
                                      source_material=source["material"])
    restored = tt.model.state_dict()
    for k, v in restored.items():
        assert torch.equal(v, source["model"][k] if k.startswith("cache.") else fresh[k]), k

    @dataclasses.dataclass
    class State:
        params: dict

        def replace(self, params):
            return State(params)

    jstate = jtrain.restore_partial_checkpoint(
        State(weights.jax_tree_from_state_dict(fresh)),
        weights.jax_tree_from_state_dict(source["model"]), prefixes=jt.prefixes,
        exclude_prefixes=exclude, replace_dict=jt.replace_dict)
    got = dict(trainer_test._tree_keys(weights.jax_tree_from_state_dict(restored)))
    want = dict(trainer_test._tree_keys(jstate.params))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg="/".join(k))
    tgin.clear_config()
    jgin.clear_config()

    _main(STAGES["from_scratch"], scratch, *warm)
    assert tckpt.latest_checkpoint_step(scratch) == 1 and tckpt.load_params(scratch)["material"]
    trainer = _main(STAGES["finetune"], finetune,
                    f"Config.partial_checkpoint_dir = '{scratch}'")
    assert trainer.config.use_occlusions and trainer.state.step == 1
    # A run without the warm start resumes the finetune stage's checkpoint.
    assert _main(STAGES["finetune"], finetune).state.step == 1
    metrics = trainer.log_test_set_evaluation(1, 1.0)
    assert np.isfinite(metrics["psnr"]) and 0 <= metrics["transient_iou"] <= 1


@pytest.mark.parametrize("scene", ["pots", "kitchen", "peppers"])
@pytest.mark.parametrize("stage", ["from_scratch", "finetune"])
def test_simulated_scenes_material_step_runs(scene, stage):
    """The other simulated scenes' material stages at test widths: one port
    step, every loss term finite, the light sampler trained (finetune
    freezes the material shader, as in JAX)."""
    tt = trainer_test.synthesize(
        "torch", [f"configs/transient_simulation_ngp_yobo_{scene}.gin"], MATERIAL_TINY,
        STAGES[stage])
    tt._setup_rng()
    tt._load_datasets()
    tt._setup_model()
    assert tt.config.use_occlusions == (stage == "finetune")
    params = dict(tt.model.named_parameters())
    before = {k: params[k].detach().clone() for k in ("light_sampler.layers.0.weight",
                                                       "shader.pred_brdf_layer.weight")}
    _, stats = tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), TRAIN_FRAC)
    losses = {k: float(v) for k, v in stats["losses"].items()}
    assert {"data", "light_sampling", "material_smoothness"} <= set(losses)
    assert np.all(np.isfinite(list(losses.values())))
    moved = {k: not torch.equal(params[k].detach(), v) for k, v in before.items()}
    assert moved == {"light_sampler.layers.0.weight": True,
                     "shader.pred_brdf_layer.weight": stage == "from_scratch"}


# --- fields the JAX package declares and never reads ---------------------------------------

# (port class, the gin name that binds it on the cornell material model, field,
# the value bound): the configs' value where a config sets one
# (configs/transient_simulation_ngp_yobo.gin binds the irradiance-cache
# fields; glossy and neilf bind stopgrad_variate_weight), else one away from
# the JAX default. The JAX class of each port class has its name.
_SAMPLER_VALUE = "(('CosineSampler', 2.0),)"
DEAD_FIELDS = [
    ("BaseMaterialMLP", "TransientMaterialMLP", "use_irradiance_cache", "True"),
    ("BaseMaterialMLP", "TransientMaterialMLP", "irradiance_cache_weight", "0.0"),
    ("BaseMaterialMLP", "TransientMaterialMLP", "irradiance_cache_decay_rate", "0.25"),
    ("BaseMaterialMLP", "TransientMaterialMLP", "stopgrad_variate_weight", "0.1"),
    ("BaseMaterialMLP", "TransientMaterialMLP", "irradiance_cache_stopgrad_weight", "0.5"),
    ("BaseMaterialMLP", "TransientMaterialMLP", "use_mesh_points", "False"),
    ("BaseMaterialMLP", "TransientMaterialMLP", "use_mesh_points_for_prediction", "False"),
    ("BaseMaterialMLP", "TransientMaterialMLP", "use_mesh_normals", "False"),
    ("BaseMaterialMLP", "TransientMaterialMLP", "use_corrected_normals", "True"),
    ("BaseMaterialMLP", "TransientMaterialMLP", "multiple_illumination_outputs", "False"),
    ("BaseMaterialMLP", "TransientMaterialMLP", "stopgrad_occ_weight", "0.5"),
    ("BaseShader", "TransientNeRFMLP", "affine_density_feature", "True"),
    ("BaseShader", "TransientNeRFMLP", "rgb_bias_diffuse", "-2.0"),
    ("BaseShader", "TransientNeRFMLP", "rgb_padding", "0.01"),
    ("BaseShader", "TransientNeRFMLP", "backfacing_near", "0.3"),
    ("BaseNeRFMLP", "TransientNeRFMLP", "cull_backfacing", "False"),
    ("BaseNeRFMLP", "TransientNeRFMLP", "num_glo_embeddings", "10"),
    ("BaseNeRFMLP", "TransientNeRFMLP", "num_glo_features", "4"),
    ("BaseNeRFMLP", "TransientNeRFMLP", "run_surface_light_field", "False"),
    ("BaseNeRFMLP", "TransientNeRFMLP", "use_learned_vignette_map", "True"),
    ("BaseNeRFMLP", "TransientNeRFMLP", "use_normals_feature", "True"),
    ("BaseNeRFMLP", "TransientNeRFMLP", "use_pred_normals_feature", "True"),
    ("BaseNeRFMLP", "TransientNeRFMLP", "weight_thold", "0.1"),
    ("BaseNeRFMLP", "TransientNeRFMLP", "use_corrected_normals", "True"),
    ("BaseNeRFMLP", "TransientNeRFMLP", "multiple_illumination_outputs", "False"),
    ("DensityMLP", "DensityMLP", "filter_backfacing", "True"),
    ("ProposalVolumeSampler", "ProposalVolumeSampler", "sampling_anneal_blur_start", "0.5"),
    ("ProposalVolumeSampler", "ProposalVolumeSampler", "sampling_anneal_blur_stop", "0.1"),
    ("ProposalVolumeSampler", "ProposalVolumeSampler", "sampling_anneal_rate", "0.1"),
    ("ProposalVolumeSampler", "ProposalVolumeSampler", "grid_representation", "'triplane'"),
    ("SurfaceLightFieldMLP", "TransientSurfaceLightFieldMLP", "window_points_frac", "0.5"),
    ("BaseMaterialModel", "TransientMaterialModel", "depth_key", "'distance_mean'"),
    ("BaseMaterialModel", "TransientMaterialModel", "use_resample_depth", "True"),
    ("BaseMaterialModel", "TransientMaterialModel", "sampler_params", "{'anneal_slope': 2.0}"),
    ("NeRFModel", "TransientNeRFModel", "use_material", "True"),
] + [("Model", "TransientMaterialModel", f"{kind}_importance_samplers", _SAMPLER_VALUE)
     for kind in ("uniform_sphere", "cosine", "light", "distance", "light_field", "irradiance",
                  "extra_ray")]
# The trainer binds use_resample_depth from its own field.
_BINDING = {"use_resample_depth": "Trainer.resample_depth = True"}
_CONFIG_NAMES = {"config", "cfg"}


@functools.lru_cache(maxsize=None)
def _jax_classes():
    """{JAX class name: (base names, attributes read off `self`)} and
    {attribute: places it is read off anything but self or a config}."""
    classes, foreign = {}, {}
    root = pathlib.Path(jgin.__file__).resolve().parents[1]
    for path in root.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                bases = [getattr(b, "attr", getattr(b, "id", None)) for b in node.bases]
                reads = {n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)
                         and isinstance(n.value, ast.Name) and n.value.id == "self"}
                classes[node.name] = (bases, reads)
            owner = getattr(node, "value", None)
            if isinstance(node, ast.Attribute) and not (
                    isinstance(owner, ast.Name) and owner.id in {"self"} | _CONFIG_NAMES) and not (
                    isinstance(owner, ast.Attribute) and owner.attr == "config"):
                foreign.setdefault(node.attr, []).append(f"{path.name}:{node.lineno}")
            if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "getattr"
                    and len(node.args) > 1 and isinstance(node.args[1], ast.Constant)):
                foreign.setdefault(node.args[1].value, []).append(f"{path.name}:{node.lineno}")
    return classes, foreign


def _family(classes, name):
    """`name`, its bases and its subclasses (the classes whose `self` may be
    an instance of it)."""
    up, stack = set(), [name]
    while stack:
        c = stack.pop()
        if c in classes and c not in up:
            up.add(c)
            stack.extend(classes[c][0])
    down, grew = {name}, True
    while grew:
        grew = False
        for c, (bases, _) in classes.items():
            if c not in down and down & set(bases):
                down.add(c)
                grew = True
    return up | down


def _material_render(bindings, state=None):
    """The narrow cornell material model's forward (no graph, injected
    draws) with `bindings`, from `state` if given; (render, state)."""
    tt = trainer_test.synthesize("torch", CORNELL, MATERIAL_TINY + ["Config.batch_size = 4"]
                                 + list(bindings), STAGES["from_scratch"])
    tt._setup_rng()
    tt._load_datasets()
    model = tconstruct.make_model(tt.config, device="cpu")
    if state is not None:
        model.load_state_dict(state)
    _, trays = transient_trainer._rays(tt)
    with material_slice.injected(2), torch.no_grad():
        render = model(None, trays, train_frac=TRAIN_FRAC, train=True)["render"]
    tgin.clear_config()
    return model, render, model.state_dict()


@pytest.fixture(scope="module")
def default_render():
    """The forward with every field of DEAD_FIELDS at its JAX default (the
    cornell config's irradiance-cache bindings undone)."""
    defaults = [f"{gin_name}.{field} = {value}" for _, gin_name, field, value in (
        ("", "TransientMaterialMLP", "use_irradiance_cache", "False"),
        ("", "TransientMaterialMLP", "irradiance_cache_weight", "1.0"),
        ("", "TransientMaterialMLP", "irradiance_cache_decay_rate", "1.0"))]
    _, render, state = _material_render(defaults)
    tgin.clear_config()
    return render, state


@pytest.mark.parametrize("port_cls,gin_name,field,value", DEAD_FIELDS,
                         ids=[f"{c}.{f}" for c, _, f, _ in DEAD_FIELDS])
def test_dead_field_is_read_by_nothing(port_cls, gin_name, field, value, default_render):
    """A field the JAX class declares and reads nowhere (no `self.<field>`
    in the class, its bases or its subclasses; no read of that name off any
    other object but a config): the port accepts it at `value`, keeps it,
    and the model runs exactly the forward of one built with the default."""
    classes, foreign = _jax_classes()
    assert port_cls in classes
    readers = [c for c in _family(classes, port_cls) if field in classes[c][1]]
    assert not readers and not foreign.get(field), (readers, foreign.get(field))
    want, state = default_render
    model, got, _ = _material_render([_BINDING.get(field, f"{gin_name}.{field} = {value}")],
                                     state)
    holders = [m for m in model.modules() if type(m).__name__ == gin_name]
    assert holders and all(getattr(m, field) == ast.literal_eval(value) for m in holders)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k


def test_env_map_stays_refused_by_its_own_option():
    """stopgrad_env_map_weight is read only on the environment map's branch
    (JAX `_make_env_map_fn`): the configs' value is accepted. The branch,
    use_env_map, once raised here; on the active transient shader it builds
    and turns the fused indirect query off (JAX runs no environment lobe on
    the active path; the steady shader's lobes are held against JAX in
    tests/test_torch_env_map.py)."""
    tt = trainer_test.synthesize("torch", CORNELL, MATERIAL_TINY, STAGES["from_scratch"])
    model = tconstruct.make_model(tt.config, device="cpu")
    assert model.shader.stopgrad_env_map_weight == (0.1, 1.0)
    tgin.clear_config()
    tt = trainer_test.synthesize("torch", CORNELL, MATERIAL_TINY + [
        "TransientMaterialMLP.use_env_map = True"], STAGES["from_scratch"])
    model = tconstruct.make_model(tt.config, device="cpu")
    assert model.shader.use_env_map and model.shader.use_active


# --- value-identical memory trims on the 700-bin path ------------------------------------


# A trim changes the order in which autograd sums a leaf's gradient terms:
# the leaves move by up to ~1.3e-7 of their largest entry (float32 rounding).
TRIM_GRAD_ATOL = 1e-6


def _trim(monkeypatch, trim, on):
    """Set one memory trim on or off: the mask-keeping clamp (off: torch.clamp),
    no time-binned extras composited in a train step (off: composited), the
    FFT shift's spectra a chunk of rays at a time (on: one ray per chunk;
    off: all rays at once)."""
    if trim == "clamp" and not on:
        monkeypatch.setattr(tlayers, "_Clamp", types.SimpleNamespace(
            apply=lambda x, lo, hi: torch.clamp(x, lo, hi)))
    elif trim == "binned_extras" and not on:
        monkeypatch.setattr(tintegrator, "_UNRENDERED_EXTRAS", ())
        monkeypatch.setattr(tintegrator, "_TRAIN_UNRENDERED_EXTRAS", ())
    elif trim == "fft_chunks":
        monkeypatch.setattr(trender, "_FFT_CHUNK_ELEMENTS", 1 if on else 1 << 62)


@pytest.mark.parametrize("trim", ["clamp", "binned_extras", "fft_chunks"])
@pytest.mark.parametrize("stage", ["cache", "from_scratch"])
def test_memory_trims_leave_the_step_unchanged(stage, trim, monkeypatch):
    """The trims of the 700-bin path that the cornell stages share: the
    clamps of the cache shader's indirect transients and of the SLF's
    incoming radiance keep a boolean mask for the backward (not their
    input), a train step composites no time-binned extra that no loss
    reads, and the FFT shift forms its per-sample spectra a chunk of rays
    at a time. One port step with the trim and one without, from the same
    weights and draws, with the finetune bindings (shadow rays): every loss
    term bit for bit equal, every gradient leaf within TRIM_GRAD_ATOL of its
    largest entry (autograd accumulates the leaves' sums in another order)."""
    bindings = MATERIAL_TINY + OCCLUSIONS
    name = "cache" if stage == "cache" else STAGES[stage]
    runs = []
    for trimmed in (True, False):
        tt = trainer_test.synthesize("torch", CORNELL, bindings, name)
        tt._setup_rng()
        tt._load_datasets()
        tt._setup_model()
        if runs:
            tt.model.load_state_dict(state)
        state = {k: v.clone() for k, v in tt.model.state_dict().items()}
        with monkeypatch.context() as mp:
            _trim(mp, trim, trimmed)
            with material_slice.injected(3):
                _, stats = tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), TRAIN_FRAC)
        runs.append(({k: v.detach().clone() for k, v in stats["losses"].items()},
                     {k: p.grad.clone() for k, p in tt.model.named_parameters()
                      if p.grad is not None}))
        tgin.clear_config()
    (losses, grads), (losses_ref, grads_ref) = runs
    assert sorted(losses) == sorted(losses_ref) and sorted(grads) == sorted(grads_ref)
    for k, v in losses_ref.items():
        assert torch.equal(losses[k], v), k
    for k, v in grads_ref.items():
        material_slice._close(grads[k].numpy(), v.numpy(), 0.0, TRIM_GRAD_ATOL, k)


def test_clamp_matches_torch_clamp():
    """The mask-keeping clamp: torch.clamp's values and gradients, at the
    bounds, beyond them and at NaN."""
    x = torch.tensor([-1.0, 0.0, 0.5, 2.0, 3.0, float("nan"), float("inf")], requires_grad=True)
    y = x.detach().clone().requires_grad_(True)
    g = torch.arange(1.0, 8.0)
    out, ref = tlayers.clamp(x, 0.0, 2.0), torch.clamp(y, 0.0, 2.0)
    (out * g).sum().backward()
    (ref * g).sum().backward()
    assert torch.equal(out, ref) or torch.allclose(out, ref, equal_nan=True)
    assert torch.equal(x.grad, y.grad)


# Every stage of configs/trainer.gin.
TRAINER_STAGES = re.findall(r'^    "([a-z_]+)": \{', pathlib.Path(
    "configs/trainer.gin").read_text(), re.M)


@pytest.mark.parametrize("stage", TRAINER_STAGES)
def test_cornell_stage_table(stage, monkeypatch):
    """Each staged-trainer stage on the narrow cornell config: one port
    step, every loss term finite. The cache-side surface-light-field stages
    (no material pass, so no query of the memory, whose SLF loss finds no
    secondary ray and is 0) also against JAX's step: every loss term, leaf
    and the Adam step. The material ones raise NotImplementedError at the
    first query, naming the JAX package's missing get_slf_results (its
    transient cache has no SLF memory)."""
    if stage.startswith("surface_light_field"):
        jt, jmodel, tt = material_trainer._trainers(CORNELL, MATERIAL_TINY, stage)
        got, _ = _step_parity(jt, jmodel, tt, material_trainer._variables(jmodel, 5),
                              monkeypatch)
        assert got["material_surface_light_field"] == 0.0
        return
    tt = trainer_test.synthesize("torch", CORNELL, MATERIAL_TINY, stage)
    tt._setup_rng()
    tt._load_datasets()
    tt._setup_model()
    if "surface_light_field" in stage:
        with pytest.raises(NotImplementedError, match="no get_slf_results"):
            tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), TRAIN_FRAC)
        return
    _, stats = tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), TRAIN_FRAC)
    assert np.all(np.isfinite([float(v) for v in stats["losses"].values()]))
