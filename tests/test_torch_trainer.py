"""The port's staged trainer against the JAX package's, on the same gin
files: the stage bindings and Configs, the parameter groups and the weight
bridge, the per-module Adam, one cache-stage train step through both
trainers, checkpoints and warm starts, the eval hook, and which config
families the port builds.

Tolerances (float32): learning rates 1e-5 relative (optax's update under
unit gradients is -lr up to its bias corrections' rounding); parameters
after two Adam steps from the same gradients 1e-6 relative. One train step:
the losses agree to 1e-4 relative (a ~100-op forward), every gradient leaf
to rtol 2e-3 with an absolute 2e-4 x the leaf's largest entry (sums in
another order whose terms cancel; a wrong term is off by O(1)), as in the
other slices' tests; after the trainer's Adam step a parameter is within
2 x its group's learning rate of JAX's (the step moves it by about +-lr,
with the sign of a gradient that may be near zero).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_gin_config as gin_test
import test_torch_material_slice as material_slice
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import configs as jconfigs
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.engine.trainer import Trainer as JTrainer
from neural_radiance_caching_tpu.models import construct as jconstruct
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch import train_with_trainer
from neural_radiance_caching_tpu_torch.engine import configs as tconfigs
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.engine import trainer as ttrainer
from neural_radiance_caching_tpu_torch.models import construct as tconstruct
from neural_radiance_caching_tpu_torch.ops import image as timage
from neural_radiance_caching_tpu_torch.ops import scatter_cuda
from neural_radiance_caching_tpu_torch.parallel import train as ttrain
from neural_radiance_caching_tpu_torch.utils import checkpoints as tckpt
from neural_radiance_caching_tpu_torch.utils import weights

SPHERES = "configs/synthetic_spheres.gin"
HOTDOG = "configs/nerf_ngp_yobo_hotdog.gin"
# The JAX trainer test's bindings for a scene config without its data.
HOTDOG_BINDINGS = ["Config.dataset_loader = 'synthetic_spheres'", "Config.batch_size = 16",
                   "Config.near = 0.2"]
TINY = ["Config.num_dataset_images = 2", "Config.factor = 4", "Config.render_chunk_size = 144"]
# ngp_yobo.gin's cache stage at test widths: the same flags (density normals
# on the final level, the power-ladder ray warp, the SLF at its defaults,
# the mask loss, the debias pass, the per-module schedules).
NGP_TINY = HOTDOG_BINDINGS + TINY + [
    "ProposalVolumeSampler.sampling_strategy = ((0, 0, 8), (1, 1, 8), (2, 2, 8))",
    "NeRFModel.train_sampling_strategy = ((0, 0, 8), (1, 1, 8), (2, 2, 8))",
    "NeRFModel.render_sampling_strategy = ((0, 0, 8), (1, 1, 8), (2, 2, 8))",
    "ProposalVolumeSampler.mlp_params_per_level = ("
    "{'disable_density_normals': True, 'enable_pred_normals': False, "
    "'normals_for_filter_only': True, 'use_grid': False, 'max_deg_point': 4, "
    "'net_depth': 2, 'net_width': 16}, "
    "{'disable_density_normals': True, 'enable_pred_normals': False, "
    "'normals_for_filter_only': True, 'use_grid': False, 'max_deg_point': 4, "
    "'net_depth': 2, 'net_width': 16}, "
    "{'disable_density_normals': False, 'enable_pred_normals': True, "
    "'normals_for_filter_only': False, 'net_depth': 2, 'net_width': 16})",
    "ProposalVolumeSampler.grid_params_per_level = (None, None, "
    "{'hash_map_size': 4096, 'max_grid_size': 128, 'num_features': 4})",
    "NeRFMLP.net_width = 16", "NeRFMLP.bottleneck_width = 16",
    "NeRFMLP.net_width_integrated_brdf = 8", "SurfaceLightFieldMLP.net_width_viewdirs = 16",
    "SurfaceLightFieldMLP.bottleneck_viewdirs = 16",
]
SCENES = {"synthetic_spheres": ([SPHERES], TINY), "ngp_yobo": (["configs/ngp_yobo.gin"], NGP_TINY)}
STAGES = (
    "cache", "light", "surface_light_field", "surface_light_field_light", "material",
    "material_light", "material_surface_light_field", "material_surface_light_field_light",
    "material_from_scratch", "material_light_from_scratch", "material_light_finetune",
    "material_surface_light_field_from_scratch",
    "material_surface_light_field_light_from_scratch",
)
MATERIAL = ["Trainer.resample = True", "Trainer.sample_factor = 1"]
LOSS = dict(rtol=1e-4, atol=1e-7)


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


def synthesize(pkg, files, bindings, stage):
    """The trainer's binding synthesis (no data, no model): the trainer."""
    configs, gin, trainer_cls = ((jconfigs, jgin, JTrainer) if pkg == "jax"
                                 else (tconfigs, tgin, ttrainer.Trainer))
    gin.clear_config()
    configs.load_config(config_files=files, bindings=list(bindings) + [
        f"Trainer.stage = '{stage}'"])
    trainer = trainer_cls() if pkg == "jax" else trainer_cls(device="cpu")
    trainer._setup_names()
    trainer._setup_config_parameters()
    trainer._setup_binding_configs()
    return trainer


CASES = [(f, s) for f in ("spheres", "hotdog") for s in STAGES] + [("spheres", "stopgrad")]


@pytest.mark.parametrize("files,stage", CASES, ids=[f"{f}-{s}" for f, s in CASES])
def test_stage_bindings_and_config_equal_jax(files, stage):
    files, bindings = {"spheres": ([SPHERES], []), "hotdog": ([HOTDOG], HOTDOG_BINDINGS)}[files]
    extra = []
    if stage == "stopgrad":
        stage, extra = "material_light", ["Trainer.stopgrad = True"]
    jt = synthesize("jax", files, bindings + extra, stage)
    tt = synthesize("torch", files, bindings + extra, stage)
    assert tt.bindings == jt.bindings
    want = gin_test._config_dict(jt.config, jgin._REGISTRY)
    got = gin_test._config_dict(tt.config, tgin._REGISTRY)
    got.pop("transient_shift_form")
    assert got == want
    assert tt.extra_opt_params == jt.extra_opt_params


def _jax_variables(jmodel, seed):
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))
    return material_slice.random_variables(shapes, seed)


def _models(stage, bindings=()):
    jt = synthesize("jax", [SPHERES], TINY + list(bindings), stage)
    tt = synthesize("torch", [SPHERES], TINY + list(bindings), stage)
    jmodel = jconstruct.make_model(jt.config)
    tmodel = tconstruct.make_model(tt.config, device="cpu")
    return jt, tt, jmodel, tmodel


def _tree_keys(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _tree_keys(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_cache_stage_builds_only_the_cache_and_the_bridge_goes_both_ways():
    jt, tt, jmodel, tmodel = _models("cache")
    assert {k.split(".")[0] for k in tmodel.state_dict()} == {"cache"}
    variables = _jax_variables(jmodel, 1)
    assert sorted(variables["params"]) == ["Cache"]
    tmodel.load_state_dict(weights.state_dict_from_jax(variables, tmodel))
    back = dict(_tree_keys(weights.jax_tree_from_state_dict(tmodel.state_dict())))
    want = dict(_tree_keys(variables))
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg="/".join(k))


def test_material_stage_builds_its_groups_and_its_step_raises():
    _, tt, jmodel, tmodel = _models("material_light_from_scratch", MATERIAL)
    variables = _jax_variables(jmodel, 2)
    assert sorted(variables["params"]) == ["Cache", "LightSampler", "MaterialShader"]
    tmodel.load_state_dict(weights.state_dict_from_jax(variables, tmodel))
    tree = weights.jax_tree_from_state_dict(tmodel.state_dict())
    assert sorted(tree["params"]) == ["Cache", "LightSampler", "MaterialShader"]
    # The stage's own extra losses are ported (its step is held against JAX's in
    # test_torch_material_trainer.py): its step builds, and so it does with
    # material_correlation bound (ported, tests/test_torch_loss_options.py).
    assert list(tt.config.extra_losses)[:3] == [
        "material_ray_sampler", "material_smoothness", "light_sampling"]
    ttrain.create_train_step(tmodel, tt.config)
    extra = dict(tt.config.extra_losses, material_correlation={"main": {"mult": 1.0}})
    assert callable(ttrain.create_train_step(
        tmodel, dataclasses.replace(tt.config, extra_losses=extra)))


# --- the optimizer -------------------------------------------------------------------

OPT_PARAMS = {
    "Cache": {"lr_init": 0.02, "lr_final": 0.002, "lr_delay_steps": 10,
              "lr_init_material": 0.004, "lr_final_material": 4e-4},
    # Inside Cache: the parameters of both prefixes take the last one's schedule.
    "MLP_2": {"lr_init": 0.03, "lr_final": 1e-4, "adam_eps": 1e-10},
    "LightSampler": {"lr_delay_steps": 0, "lr_final": 0.0, "lr_init": 0.0},
    "MaterialShader": {"lr_init": 5e-3, "lr_final": 5e-5, "lr_delay_mult": 0.1},
}


@pytest.fixture(scope="module")
def material_pair():
    _, _, jmodel, tmodel = _models("material_light_from_scratch", MATERIAL)
    variables = _jax_variables(jmodel, 3)
    tmodel.load_state_dict(weights.state_dict_from_jax(variables, tmodel))
    jgin.clear_config()
    tgin.clear_config()
    return variables, tmodel


@pytest.mark.parametrize("is_material", [False, True])
def test_per_module_adam_matches_optax(material_pair, is_material):
    variables, tmodel = material_pair
    cfg = dict(lr_init=0.01, lr_final=0.001, max_steps=6000, lr_delay_steps=100,
               lr_delay_mult=0.01, extra_opt_params=OPT_PARAMS, is_material=is_material)
    jstate, _ = jtrain.create_optimizer(jconfigs.Config(**cfg), variables)
    saved = {k: v.clone() for k, v in tmodel.state_dict().items()}
    state, _ = ttrain.create_optimizer(tconfigs.Config(**cfg), tmodel)
    names = ttrain.param_group_names(tconfigs.Config(**cfg), tmodel)
    assert names["cache.sampler.mlps.2.grid.hash_levels"] == "MLP_2"
    assert names["cache.sampler.mlps.0.density_layers.0.weight"] == "Cache"
    assert names["shader.pred_brdf_layer.weight"] == "MaterialShader"

    # With unit gradients Adam's update is exactly -lr: optax's learning rate
    # of every parameter at steps 0, 1, 50 and 5000 against the port's.
    ones = jax.tree_util.tree_map(jnp.ones_like, variables)
    update = jax.jit(lambda s: jstate.tx.update(ones, s, variables))
    advance = jax.jit(lambda s, n: jax.lax.fori_loop(0, n, lambda i, s: update(s)[1], s))
    opt_state, done = jstate.opt_state, 0
    group_of = {id(p): i for i, g in enumerate(state.optimizer.param_groups)
                for p in g["params"]}
    params = dict(tmodel.named_parameters())
    for step in (0, 1, 50, 5000):
        opt_state = advance(opt_state, step - done)
        updates, opt_state = update(opt_state)
        done = step + 1
        want = material_slice._leaves(updates["params"])
        for key, p in params.items():
            lr = state.group_lr_fns[group_of[id(p)]](step)
            np.testing.assert_allclose(-np.asarray(want[key]).reshape(-1)[0], lr,
                                       rtol=1e-5, atol=1e-12, err_msg=f"{key} @ {step}")

    # Two Adam steps from fixed gradients.
    rng = np.random.RandomState(4)
    grads = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)), variables)
    jparams, opt_state = variables, jstate.opt_state
    for step in range(2):
        updates, opt_state = jstate.tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = weights.state_dict_from_jax(grads, tmodel)
        for group, lr_fn in zip(state.optimizer.param_groups, state.group_lr_fns):
            group["lr"] = lr_fn(step)
        for key, p in params.items():
            p.grad = tgrads[key]
        state.optimizer.step()
    want = material_slice._leaves(jparams["params"])
    for key, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), material_slice._tr(key, want[key]),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    for key in ("light_sampler.output_layer.weight", "light_sampler.grid.hash_levels"):
        assert torch.equal(params[key].detach(), saved[key])
    tmodel.load_state_dict(saved)


# --- one train step through both trainers --------------------------------------------


def jax_loss(jmodel, jcfg, train_frac):
    """The JAX train step's loss: the forward, the gradient-debias forward
    over the same cache samples, and the loss assembly over every *main
    output (the trainer's step without the mesh)."""

    def loss_fn(variables, batch):
        rng = jax.random.PRNGKey(0)
        kw = dict(train_frac=train_frac, train=True, compute_extras=False)
        results = jmodel.apply(variables, rng, batch.rays, **kw)
        nocorr = jmodel.apply(
            variables, jax.random.fold_in(rng, 0x5EED), batch.rays,
            cache_outputs={"sampler": results["cache_main"]["sampler"]},
            filtered_sampler_inds=results["cache_main"]["filtered_sampler_inds"], **kw)
        results["render"]["rgb_nocorr"] = nocorr["render"]["rgb"]
        losses, stats = {}, {}
        for key in sorted(k for k in results if k.endswith("main")):
            jtrain._compute_losses_for_output(None, batch, batch.rays, results, jcfg,
                                              train_frac, key, losses, stats)
        return sum(jax.tree_util.tree_leaves(losses)), losses

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_one_cache_step_through_both_trainers(scene, monkeypatch):
    files, bindings = SCENES[scene]
    jt = synthesize("jax", files, bindings, "cache")
    jcfg = jt.config
    jmodel = jconstruct.make_model(jcfg)
    variables = _jax_variables(jmodel, 5)
    jbatch = jdatasets.load_dataset("train", None, jcfg).next_train()
    with material_slice.injected(7), jhash.xla_encoder_scope():
        (_, jlosses), jgrad = jax_loss(jmodel, jcfg, 0.0)(variables, jbatch)
    jstate, _ = jtrain.create_optimizer(jcfg, variables)
    updates, _ = jstate.tx.update(jgrad, jstate.opt_state, variables)
    jnew = material_slice._leaves(optax.apply_updates(variables, updates)["params"])

    tt = synthesize("torch", files, bindings, "cache")
    tt._setup_rng()
    tt._load_datasets()
    tt._setup_model()
    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    calls = []
    material_slice._counting_scatters(monkeypatch, calls)
    with material_slice.injected(7):
        state, stats = tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), 0.0)
    # The kernel path: one leveled launch per step, none with density normals.
    assert calls == (["leveled"] if scene == "synthetic_spheres" else [])

    got = {k: float(v) for k, v in stats["losses"].items()}
    assert sorted(got) == sorted(jlosses)
    assert {k for k in got if k.startswith("cache_")} == {
        "cache_" + k for k in got if not k.startswith("cache_")}
    for k, v in jlosses.items():
        np.testing.assert_allclose(got[k], float(v), err_msg=k, **LOSS)
    want = material_slice._leaves(jgrad["params"])
    params = dict(tt.model.named_parameters())
    assert sorted(params) == sorted(want)
    for k, p in params.items():
        material_slice._close(p.grad.numpy(), material_slice._tr(k, want[k]), 2e-3, 2e-4, k)
    # The Adam step of the trainer's per-module schedules: a parameter moves
    # by about its group's learning rate, so hold it to that scale.
    for k, p in params.items():
        lr = max(g["lr"] for g in state.optimizer.param_groups
                 if any(q is p for q in g["params"]))
        np.testing.assert_allclose(p.detach().numpy(), material_slice._tr(k, jnew[k]),
                                   rtol=0, atol=2 * lr + 1e-7, err_msg=k)


# --- checkpoints, warm starts and eval ----------------------------------------------


def _run(args):
    return train_with_trainer.main(["--device", "cpu", f"--gin_configs={SPHERES}"]
                                   + [f"--gin_bindings={b}" for b in TINY + args])


@pytest.fixture(scope="module")
def cache_checkpoint(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "spheres_cache")
    args = ["Trainer.stage = 'cache'", f"Config.checkpoint_dir = '{ckpt}'",
            "Config.early_exit_steps = 3"]
    _run(args)
    tgin.clear_config()
    lines = open(os.path.join(ckpt, "train_log.jsonl")).read().splitlines()
    trainer = _run(args)
    tgin.clear_config()
    return ckpt, lines, trainer


def test_checkpoint_and_resume(cache_checkpoint):
    ckpt, lines, trainer = cache_checkpoint
    assert tckpt.latest_checkpoint_step(ckpt) == 3
    assert os.path.exists(os.path.join(ckpt, "config.gin"))
    assert "Trainer.stage = 'cache'" in open(os.path.join(ckpt, "config.gin")).read()
    logged = [json.loads(line) for line in lines]
    assert [r["step"] for r in logged] == [1, 2]  # print_every = 2
    assert {"loss/data", "loss/cache_data", "loss/mask", "loss/cache_mask"} <= set(logged[-1])
    # The second run resumed at step 3 and took no step.
    assert trainer.state.step == 3
    assert open(os.path.join(ckpt, "train_log.jsonl")).read().splitlines() == lines
    saved = tckpt.load_params(ckpt)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k


def test_material_warm_start_matches_jax_partial_restore(cache_checkpoint):
    ckpt = cache_checkpoint[0]
    jt, tt, jmodel, tmodel = _models("material_light_from_scratch", MATERIAL)
    fresh = {k: v.clone() for k, v in tmodel.state_dict().items()}
    source = tckpt.load_params(ckpt)
    assert source["material"] and source["step"] == 3
    exclude = ("params/MaterialShader",)
    ttrain.restore_partial_checkpoint(tmodel, source["model"], prefixes=tt.prefixes,
                                      exclude_prefixes=exclude, source_material=True)
    for k, v in tmodel.state_dict().items():
        want = source["model"][k] if k.startswith("cache.") else fresh[k]
        assert torch.equal(v, want), k

    @dataclasses.dataclass
    class State:
        params: dict

        def replace(self, params):
            return State(params)

    jstate = jtrain.restore_partial_checkpoint(
        State(weights.jax_tree_from_state_dict(fresh)),
        weights.jax_tree_from_state_dict(source["model"]), prefixes=jt.prefixes,
        exclude_prefixes=exclude, replace_dict=jt.replace_dict)
    got = dict(_tree_keys(weights.jax_tree_from_state_dict(tmodel.state_dict())))
    want = dict(_tree_keys(jstate.params))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg="/".join(k))


def test_train_render_every_evaluates_and_saves(tmp_path):
    ckpt = str(tmp_path / "spheres_eval")
    trainer = _run(["Trainer.stage = 'cache'", f"Config.checkpoint_dir = '{ckpt}'",
                    "Config.early_exit_steps = 2", "Config.train_render_every = 2",
                    "Config.metric_harness_train_config = {'disable_lpips': True}"])
    img = np.load(os.path.join(ckpt, "save", "color", "000002.npy"))
    assert img.shape == (12, 12, 3) and np.isfinite(img).all()
    assert len(trainer.metric_list["psnr"]) == 1
    seen = {}
    render = trainer.render_test_view

    def spy(cam_idx, train_frac):
        seen["out"] = render(cam_idx, train_frac)
        return seen["out"]

    trainer.render_test_view = spy
    metrics = trainer.log_test_set_evaluation(2, 1.0)
    rendering, batch = seen["out"]
    want = ttrainer.compute_eval_metrics(
        rendering, batch, 12, 12, trainer.config, timage.MetricHarness(disable_lpips=True),
        trainer.postprocess_fn)
    assert metrics == want and {"psnr", "ssim"} <= set(want)
    # Without the binding the evaluation scores LPIPS too, on the trainer's
    # device: NaN at these 12^2 views, as JAX's, whose fifth VGG tap has no
    # pixel left (tests/test_torch_lpips.py holds the values at 48^2 on).
    trainer.metric_harness = None
    trainer.config = dataclasses.replace(trainer.config, metric_harness_train_config={})
    metrics = trainer.log_test_set_evaluation(2, 1.0)
    assert {"psnr", "ssim", "lpips", "lpips_calibrated", "avg_err"} == set(metrics)
    assert np.isnan(metrics["lpips"]) and metrics["psnr"] == want["psnr"]


@pytest.mark.parametrize("config", [SPHERES, "configs/transient_simulation_ngp_yobo_cornell.gin"])
def test_the_entry_point_runs_on_the_card_unless_asked(config):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_with_trainer.main([f"--gin_configs={config}"]
                                + [f"--gin_bindings={b}" for b in HOTDOG_BINDINGS + TINY])


# --- config families -------------------------------------------------------------------

# The cache stage of each family scene of tests/test_config_families.py: the
# port builds the same parameter groups as JAX (["Cache"] for most: the
# InvProp scenes' TransientMaterialModel holds only its cache there, in JAX
# too; statue_fwp's adds its VignetteMap and the material shader's light,
# which its cache reads), or raises NotImplementedError naming the option it
# does not port yet (neilf's SLF point offsets, read by its distance head;
# the steady active shader; tests/test_torch_slf_distance.py holds every
# nero / open / orb config).
FAMILY_CACHE_STAGE = {
    "blender_ngp_yobo_lego.gin": None,
    "glossy_bunny_yobo.gin": None,
    "neilf_cat_yobo.gin": None,
    "nero_ngp_yobo_bell.gin": None,
    "nero_ngp_yobo_teapot.gin": None,
    "open_ngp_yobo_egg.gin": None,
    "open_ngp_yobo_stone.gin": None,
    "open_ngp_yobo_bird.gin": None,
    "orb_ngp_yobo_teapot.gin": None,
    "real_ngp_yobo_000.gin": None,
    "synthetic_ngp_yobo_kitchen.gin": None,
    "transient_simulation_ngp_yobo_cornell.gin": None,
    "transient_simulation_ngp_yobo_pots.gin": None,
    "transient_simulation_ngp_yobo_peppers.gin": None,
    "transient_simulation_ngp_yobo_kitchen.gin": None,
    "transient_simulation_ngp_yobo_cornell_itof.gin": None,
    "transient_simulation_ngp_yobo_cornell_steady_state.gin": None,
    "transient_simulation_ngp_yobo_statue_fwp.gin": None,
    "transient_simulation_ngp_yobo_kettle_fwp.gin": None,
    "nerf_ngp_yobo_hotdog.gin": None,
    "ngp_yobo.gin": None,
    "synthetic_spheres.gin": None,
}


@pytest.mark.parametrize("scene", sorted(FAMILY_CACHE_STAGE))
def test_config_family_cache_stage(scene):
    option = FAMILY_CACHE_STAGE[scene]
    if option is None:
        jt = synthesize("jax", [f"configs/{scene}"], ["Config.batch_size = 16"], "cache")
        jmodel = jconstruct.make_model(jt.config)
        jax_groups = set(jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4),
            train_frac=1.0, train=False))["params"])
    tt = synthesize("torch", [f"configs/{scene}"], ["Config.batch_size = 16"], "cache")
    if option is None:
        model = tconstruct.make_model(tt.config, device="cpu")
        groups = {weights.jax_path(k)[0] for k in model.state_dict()}
        assert groups == jax_groups
        assert "Cache" in groups
    else:
        with pytest.raises(NotImplementedError, match=option.replace("(", r"\(")):
            tconstruct.make_model(tt.config, device="cpu")


def test_cornell_itof_cache_step_raises_at_its_data_loss():
    """cornell_itof builds its cache stage (above); its step raises at the
    cache's iToF data loss, whose 2 x 4 + 1 = 9 iToF rows meet a loss weight
    per time bin (8 here), where JAX's step raises too
    (tests/test_torch_invprop_scenes.py)."""
    tt = synthesize("torch", ["configs/transient_simulation_ngp_yobo_cornell_itof.gin"],
                    HOTDOG_BINDINGS + TINY + ["Config.n_bins = 8"], "cache")
    tt._setup_rng()
    tt._load_datasets()
    tt._setup_model()
    with pytest.raises(NotImplementedError, match="rawnerf_transient_itof"):
        tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), 0.0)


def test_train_one_stage_runs_the_ports_entry_point(monkeypatch):
    from neural_radiance_caching_tpu_torch import train_one_stage

    calls = []
    monkeypatch.setattr(train_one_stage.subprocess, "call",
                        lambda cmd, cwd=None: calls.append((cmd, cwd)) or 0)
    monkeypatch.setattr("sys.argv", ["train_one_stage", "-s", "spheres_test", "-t",
                                     "material_resample", "-p", "cache", "--device", "cpu",
                                     "--early_exit_steps", "2"])
    with pytest.raises(SystemExit) as exit_info:
        train_one_stage.main()
    assert exit_info.value.code == 0
    (cmd, cwd), = calls
    assert cmd[1:4] == ["-m", "neural_radiance_caching_tpu_torch.train_with_trainer",
                        "--device=cpu"]
    assert "--gin_configs=configs/synthetic_spheres.gin" in cmd
    assert "--gin_bindings=Trainer.stage='material'" in cmd
    assert "--gin_bindings=Trainer.resample=True" in cmd
    assert any(c.startswith("--gin_bindings=Config.partial_checkpoint_dir=") and
               c.endswith("spheres_test_cache'") for c in cmd)
    assert os.path.exists(os.path.join(cwd, "configs", "synthetic_spheres.gin"))
