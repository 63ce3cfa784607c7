"""The staged trainer's transient (InvProp) cache stage against the JAX
package's, on configs/transient_simulation_ngp_yobo_cornell.gin at test
widths: in-step ray casting, the cache shader's appearance grid, shadow rays,
the shared light power, the parameter regularizers, geometry smoothness, the
density-radius filter, and one cache step through both trainers with and
without the finetune stages' occlusion bindings.

Every uniform, normal and categorical draw of both packages comes from one
numpy stream (`test_torch_material_slice.injected`), in the order both take
them: the in-step cast's jitter first, then the forward (a shadow ray's
direction draw and its sampler's intervals inside the cache shader, before
the surface light field's), the debias forward, then the extra losses.
The weights are drawn from U(-0.5, 0.5), the hash tables from the grid's
own init range U(-1e-4, 1e-4), as the stage starts them
(`test_torch_material_trainer._variables`).

Tolerances (float32), tightest first: the cast rays agree to 1e-6 relative
(the same ops in the same order; the jitter's normal draws scaled by 0.5
exactly); unit-level values on the same inputs (light radiance, the
regularizers, occlusions, the density-radius filter) to 1e-5 relative; loss
terms of the model and of the step to 1e-4 relative with an absolute 1e-7 (a
~100-op forward through two sampler hierarchies, the shadow rays' a third),
as in the other trainers' tests; every gradient leaf to rtol 2e-3 with an
absolute 2e-4 x the leaf's largest entry (sums in another order whose terms
cancel; a wrong term is off by O(1)); after the trainer's Adam step a
parameter is within 2 x its group's learning rate of optax's (the step moves
it by about +-lr, with the sign of a gradient that may be near zero).
"""

import dataclasses
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
import test_torch_transient_material_slice as transient_material_slice
from neural_radiance_caching_tpu.data import camera_utils as jcam
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.parallel import extra_losses as jextra
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch.data import camera_utils as tcam
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch import train_with_trainer
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.models import construct as tconstruct
from neural_radiance_caching_tpu_torch.parallel import extra_losses as textra
from neural_radiance_caching_tpu_torch.parallel import losses as tlosses
from neural_radiance_caching_tpu_torch.utils import checkpoints as tckpt
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees
from neural_radiance_caching_tpu_torch.utils import weights

CORNELL = ["configs/transient_simulation_ngp_yobo_cornell.gin"]
PEPPERS = ["configs/transient_simulation_ngp_yobo_peppers.gin"]
STRATEGY = "((0, 0, 8), (1, 1, 8), (2, 2, 8))"
GRID = "'hash_map_size': 4096, 'max_grid_size': 128"
# The cornell cache stage at test widths, without its data: the same flags
# (three grid proposal levels with density normals, the power-ladder ray
# warp, the shader's appearance grid, the transient SLF, the mask loss, the
# debias pass, the density-grid regularizer, geometry smoothness, in-step
# ray casting), 24 bins of 0.5 (the scene's path lengths reach ~9).
TRANSIENT_TINY = trainer_test.HOTDOG_BINDINGS + trainer_test.TINY + [
    "Config.n_bins = 24", "Config.exposure_time = 0.5",
    f"ProposalVolumeSampler.sampling_strategy = {STRATEGY}",
    f"TransientNeRFModel.train_sampling_strategy = {STRATEGY}",
    f"TransientNeRFModel.render_sampling_strategy = {STRATEGY}",
    "ProposalVolumeSampler.mlp_params_per_level = ("
    "{'disable_density_normals': False, 'enable_pred_normals': False, "
    "'normals_for_filter_only': True, 'net_depth': 2, 'net_width': 16}, "
    "{'disable_density_normals': False, 'enable_pred_normals': False, "
    "'normals_for_filter_only': True, 'net_depth': 2, 'net_width': 16}, "
    "{'disable_density_normals': False, 'enable_pred_normals': True, "
    "'normals_for_filter_only': False, 'net_depth': 2, 'net_width': 16})",
    f"ProposalVolumeSampler.grid_params_per_level = ({{{GRID}, 'num_features': 1}}, "
    f"{{{GRID}, 'num_features': 1}}, {{{GRID}, 'num_features': 4}})",
    "HashEncoding.hash_map_size = 4096", "HashEncoding.max_grid_size = 128",
    f"TransientNeRFMLP.grid_params = {{{GRID}, 'num_features': 4}}",
    "TransientNeRFMLP.net_width = 16", "TransientNeRFMLP.bottleneck_width = 16",
    "TransientNeRFMLP.net_width_integrated_brdf = 8", "TransientNeRFMLP.net_width_brdf = 8",
    "TransientNeRFMLP.net_width_irradiance = 8", "TransientNeRFMLP.bottleneck_irradiance = 8",
    "TransientSurfaceLightFieldMLP.net_width_viewdirs = 16",
    "TransientSurfaceLightFieldMLP.bottleneck_viewdirs = 16",
]
# The finetune stages' occlusion bindings (JAX engine/trainer.py:179-182),
# with the occlusion threshold at 0 so that every shadow ray's opacity
# reaches the direct light (at the cornell threshold of 0.9 the narrow
# cache's shadow rays, clipped at secondary_far = 1, stay below it).
OCCLUSIONS = ["Config.use_occlusions = True", "Config.occlusions_secondary_only = False",
              "Config.occlusions_primary_only = False", "Config.occ_threshold_min = 0.0",
              "Config.occ_threshold_max = 0.0"]
TRAIN_FRAC = 0.25
LOSS = trainer_test.LOSS
GRAD = material_trainer.GRAD
UNIT = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


def _jax_cameras(dataset):
    return dict(cameras=tuple(jnp.asarray(c) if c is not None else None
                              for c in dataset.cameras),
                lights=jnp.asarray(dataset.lights),
                impulse_response=None if dataset.impulse_response is None
                else jnp.asarray(dataset.impulse_response))


def jax_step_loss(jmodel, jcfg, dataset, train_frac):
    """The JAX train step's loss (`parallel/train.py` without the mesh): the
    in-step cast of the batch's Pixels (its jitter key folded in first), the
    forward, the debias forward, per *main output its losses and extra
    losses, then the parameter regularizers."""
    cams = _jax_cameras(dataset)

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


def _cornell(extra=(), files=CORNELL):
    """(JAX trainer, JAX model, port trainer) of the narrow cornell cache
    stage; the JAX model reads its gin bindings when it is applied, so within
    the test that builds it."""
    return material_trainer._trainers(files, TRANSIENT_TINY + list(extra), "cache")


@pytest.mark.parametrize("bindings", ["direct", "occlusions"])
def test_one_cornell_cache_step_through_both_trainers(bindings, monkeypatch):
    jt, jmodel, tt = _cornell(OCCLUSIONS if bindings == "occlusions" else ())
    jcfg = jt.config
    assert jcfg.cast_rays_in_train_step and tt.config.use_occlusions == (bindings != "direct")
    variables = material_trainer._variables(jmodel, 5)
    jdata = jdatasets.load_dataset("train", None, jcfg)
    jbatch = jdata.next_train()
    assert isinstance(jbatch.rays, jpytrees.Pixels)
    with material_slice.injected(7), jhash.xla_encoder_scope():
        (_, jlosses_), jgrad = jax_step_loss(jmodel, jcfg, jdata, TRAIN_FRAC)(variables, jbatch)
    jgrad = jlosses.clip_gradients(jax.tree_util.tree_map(jnp.nan_to_num, jgrad), jcfg)
    jstate, _ = jtrain.create_optimizer(jcfg, variables)
    updates, _ = jstate.tx.update(jgrad, jstate.opt_state, variables)
    jnew = material_slice._leaves(optax.apply_updates(variables, updates)["params"])

    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    tbatch = tt.dataset.next_train()
    assert isinstance(tbatch.rays, tpytrees.Pixels)
    calls = []
    material_slice._counting_scatters(monkeypatch, calls)
    with material_slice.injected(7):
        state, stats = tt.train_step(tt.rng, tt.state, tbatch, TRAIN_FRAC)
    # The appearance grid's backward: the one encoder outside the density
    # normals (the sampler levels' plain encoder); the shadow pass has no graph.
    assert calls == ["leveled"]

    got = {k: float(v) for k, v in stats["losses"].items()}
    assert sorted(got) == sorted(jlosses_)
    assert {"geometry_smoothness", "regularizer_density_grid", "cache_data", "data"} <= set(got)
    assert {k for k in got if k.startswith("cache_")} == {
        "cache_" + k for k in got if not k.startswith(("cache_", "regularizer_"))
        and k != "geometry_smoothness"}
    for k, v in jlosses_.items():
        np.testing.assert_allclose(got[k], float(v), err_msg=k, **LOSS)
    want = material_slice._leaves(jgrad["params"])
    params = dict(tt.model.named_parameters())
    assert sorted(params) == sorted(want)
    for k, p in params.items():
        material_slice._close(p.grad.numpy(), material_slice._tr(k, want[k]), *GRAD, k)
    for k, p in params.items():
        lr = max(g["lr"] for g in state.optimizer.param_groups
                 if any(q is p for q in g["params"]))
        np.testing.assert_allclose(p.detach().numpy(), material_slice._tr(k, jnew[k]),
                                   rtol=0, atol=2 * lr + 1e-7, err_msg=k)


# --- the modules of the slice on the same inputs -----------------------------------------


def _bridged(extra=(), files=CORNELL, seed=5, table_scale=2e-4, appearance_scale=None):
    """_cornell's pair with the same weights in both models; the appearance
    grid's tables from U(-0.5, 0.5) times `appearance_scale` if given."""
    jt, jmodel, tt = _cornell(extra, files)
    variables = material_trainer._variables(jmodel, seed, table_scale)
    if appearance_scale is not None:
        variables = jax.tree_util.tree_map_with_path(
            lambda path, x: x * np.float32(appearance_scale / table_scale)
            if "appearance_grid" in jax.tree_util.keystr(path) else x, variables)
    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    return jt, jmodel, tt, variables


def _rays(tt):
    """One train batch of `tt`'s dataset cast on the host, as (JAX rays, port
    rays)."""
    data = tt.dataset
    trays = tcam.cast_ray_batch(tcam.cameras_to(data.cameras, "cpu"),
                                torch.as_tensor(data.lights), data.next_train().rays)
    jrays = jpytrees.Rays(**{f.name: jnp.asarray(getattr(trays, f.name).numpy())
                             for f in dataclasses.fields(trays)
                             if getattr(trays, f.name) is not None})
    return jrays, trays


def _close_tree(got, want, rtol, atol_frac, prefix=""):
    for k, v in want.items():
        material_slice._close(np.asarray(got[k].detach()), np.asarray(v), rtol, atol_frac,
                              f"{prefix}{k}")


@pytest.mark.parametrize("jitter", [0, 1, 2])
def test_cast_ray_batch_matches_jax(jitter):
    """The train step's cast of a Pixels batch on the device (jnp in JAX),
    without and with the pixel jitter (uniform, then normal)."""
    bindings = TRANSIENT_TINY + [f"Config.jitter_rays = {jitter}"]
    jt = trainer_test.synthesize("jax", CORNELL, bindings, "cache")
    tt = trainer_test.synthesize("torch", CORNELL, bindings, "cache")
    jdata = jdatasets.load_dataset("train", None, jt.config)
    tdata = tdatasets.load_dataset("train", None, tt.config, device="cpu")
    jpix, tpix = jdata.next_train().rays, tdata.next_train().rays
    cams = _jax_cameras(jdata)
    cast = jax.jit(lambda p: jcam.cast_ray_batch(
        cams["cameras"], cams["lights"], p, rng=jax.random.PRNGKey(3), jitter=jitter, xnp=jnp))
    with material_slice.injected(11):
        want = cast(jpix)
        got = tcam.cast_ray_batch(tcam.cameras_to(tdata.cameras, "cpu"),
                                  torch.as_tensor(tdata.lights), tpix,
                                  rng=torch.Generator().manual_seed(0), jitter=jitter)
    unjittered = tcam.cast_ray_batch(tcam.cameras_to(tdata.cameras, "cpu"),
                                     torch.as_tensor(tdata.lights), tpix)
    for field in ("origins", "directions", "viewdirs", "radii", "imageplane", "look", "up",
                  "cam_origins", "lights", "near", "far", "lossmult"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=1e-6, atol=1e-7, err_msg=field)
    assert got.directions.dtype == torch.float32
    assert torch.equal(got.directions, unjittered.directions) == (jitter == 0)


def test_appearance_grid_forward_and_gradients(monkeypatch):
    """The cache shader's own hash grid (F = 4 at the 'mean' control point):
    the shader's outputs and the gradients of a weighted sum of its rgb with
    respect to every shader leaf, the grid's tables among them; its backward
    is the one scatter of the pass."""
    jt, jmodel, tt, variables = _bridged(appearance_scale=1.0)
    jrays, trays = _rays(tt)
    w = np.random.RandomState(0).uniform(size=(16, 8, 3)).astype(np.float32)
    keys = ("rgb", "direct_rgb", "indirect_rgb", "transient_indirect")

    def jloss(v):
        shader = jmodel.apply(v, jax.random.PRNGKey(0), jrays, train_frac=TRAIN_FRAC, train=True,
                              compute_extras=False)["main"]["shader"]
        return jnp.sum(shader["rgb"] * w), {k: shader[k] for k in keys}

    with material_slice.injected(3), jhash.xla_encoder_scope():
        (_, want), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables)
    calls = []
    material_slice._counting_scatters(monkeypatch, calls)
    with material_slice.injected(3):
        shader = tt.model(tt.rng, trays, train_frac=TRAIN_FRAC, train=True,
                          compute_extras=False)["main"]["shader"]
        (shader["rgb"] * torch.as_tensor(w)).sum().backward()
    assert calls == ["leveled"]
    _close_tree(shader, want, 1e-4, 1e-5)
    jg = material_slice._leaves(jgrad["params"])
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in tt.model.named_parameters() if k.startswith("cache.shader.")}
    assert {"cache.shader.grid.hash_levels", "cache.shader.grid.dense_levels"} <= set(grads)
    assert float(grads["cache.shader.grid.hash_levels"].abs().max()) > 0
    for k, g in grads.items():
        material_slice._close(g.numpy(), material_slice._tr(k, jg[k]), *GRAD, k)


# The shadow-ray ramps spread over train_frac, for the unit test: the shadow
# rays' near bound from 0.3 down to 0.02, the occlusion threshold from 0.1
# down to 0.02 (the narrow cache's shadow opacities at U(-0.5, 0.5) tables
# spread over 0-0.17), both over [0.2, 0.6].
RAMPS = OCCLUSIONS[:3] + [
    "Config.occ_threshold_min = 0.02", "Config.occ_threshold_max = 0.1",
    "Config.occ_threshold_rate = 0.4", "Config.occ_threshold_start_frac = 0.2",
    "Config.shadow_near_min = 0.02", "Config.shadow_near_max = 0.3",
    "Config.shadow_near_rate = 0.4", "Config.shadow_near_start_frac = 0.2"]


def test_compute_occlusions_matches_jax(monkeypatch):
    """Shadow rays from given samples toward the light at train_frac before,
    inside and past both ramps, with the light on the camera for 4 of the 16
    rays: the thresholded occlusions, and no scatter (the pass has no
    graph)."""
    jt, jmodel, tt, variables = _bridged(RAMPS, table_scale=1.0)
    jrays, trays = _rays(tt)
    on_camera = np.arange(16) < 4
    lights = np.where(on_camera[:, None], trays.origins.numpy(), trays.lights.numpy())
    trays = trays.replace(lights=torch.as_tensor(lights))
    jrays = jrays.replace(lights=jnp.asarray(lights))
    rng = np.random.RandomState(2)
    t = rng.uniform(1.5, 4.5, (16, 4, 1)).astype(np.float32)
    means = trays.origins.numpy()[:, None] + t * trays.viewdirs.numpy()[:, None]
    normals = rng.normal(size=(16, 4, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    light_dists = np.linalg.norm(lights[:, None] - means, axis=-1, keepdims=True)
    jfiltered = {"means": jnp.asarray(means), "normals": jnp.asarray(normals)}
    tfiltered = {"means": torch.as_tensor(means), "normals": torch.as_tensor(normals)}

    def occlusions(module, rays, filtered, dists, train_frac):
        return module.cache.shader._compute_occlusions(
            jax.random.PRNGKey(0), rays, filtered, None, None, dists, module, train_frac, True,
            False, filtered_sampler_results=filtered)

    jocc = jax.jit(lambda v, frac: jmodel.apply(v, jrays, jfiltered, jnp.asarray(light_dists),
                                                frac, method=occlusions))
    calls = []
    material_slice._counting_scatters(monkeypatch, calls)
    got = {}
    for frac in (0.1, 0.4, 0.9):
        with material_slice.injected(13), jhash.xla_encoder_scope():
            want = np.asarray(jocc(variables, frac))
        with material_slice.injected(13):
            got[frac] = tt.model.cache.shader._compute_occlusions(
                tt.rng, trays, torch.as_tensor(light_dists), tt.model, frac, True, False,
                tfiltered).numpy()
        material_slice._close(got[frac], want, 1e-4, 1e-6, f"train_frac {frac}")
        assert not got[frac][on_camera].any()
        assert got[frac][~on_camera].any() and not got[frac][~on_camera].all()
    assert calls == []
    # The ramps move the result: a lower threshold and a nearer start later on.
    assert (got[0.9] > 0).sum() > (got[0.1] > 0).sum()


def _light_radiance_pair(jmodel, tmodel, variables, jrays, trays, share, light_power):
    """The cache shader's light radiance in both packages at 8 points per ray
    on the segment from its camera to its light (the last ones within
    light_near of the light), under a `radiance_cache` that shares its
    light power (`share`) and the `light_power` passed; and their distances
    to the light."""
    s = np.linspace(0.1, 1.0, 8, dtype=np.float32)[None, :, None]
    origins, lights = trays.origins.numpy()[:, None], trays.lights.numpy()[:, None]
    means = origins + s * (lights - origins)
    dists = np.linalg.norm(lights - means, axis=-1, keepdims=True)

    def radiance(module, rays, means, dists):
        rc = types.SimpleNamespace(share_light_power=share, shader=module.shader) \
            if share is not None else None
        return module.cache.shader._compute_light_radiance(
            None, rays, {"means": means}, rc, None,
            None if light_power is None else jnp.float32(light_power), dists)

    want = jmodel.apply(variables, jrays, jnp.asarray(means), jnp.asarray(dists),
                        method=radiance)
    rc = (types.SimpleNamespace(share_light_power=share, shader=getattr(tmodel, "shader", None))
          if share is not None else None)
    with torch.no_grad():
        got = tmodel.cache.shader._light_radiance(
            trays, {"means": torch.as_tensor(means)}, torch.as_tensor(dists), rc,
            None if light_power is None else torch.tensor(light_power))
    return got, want, dists


@pytest.mark.parametrize("branch", ["own", "own_unshared", "passed"])
def test_shared_light_power_matches_jax(branch):
    """The cache shader's light without a learnable light: its own power
    (no power passed, or a cache that shares none) and the power a material
    shader passes under share_light_power, with cornell's falloff and light
    cut-off near the light."""
    _, jmodel, tt, variables = _bridged()
    jrays, trays = _rays(tt)
    share, power = {"own": (True, None), "own_unshared": (None, 7.5),
                    "passed": (True, 7.5)}[branch]
    got, want, dists = _light_radiance_pair(jmodel, tt.model, variables, jrays, trays, share,
                                            power)
    for g, w, name in zip(got, want, ("radiance", "mult", "before_occ")):
        material_slice._close(g.numpy(), np.asarray(w), *UNIT.values(), name)
    # The power behind the inverse-square falloff, zero within light_near.
    lit = got[2].numpy() > 0
    assert np.array_equal(lit, dists >= tt.config.light_near)
    own = float(torch.exp(tt.model.cache.shader.light_power.detach())[0])
    np.testing.assert_allclose((got[2].numpy() * dists**2)[lit], 7.5 if branch == "passed"
                               else own, rtol=1e-5)
    assert lit.any() and not lit.all()


def test_shared_learnable_light_matches_jax():
    """A material model's learnable light (Config.learnable_light) shared
    with the cache shader: its radiance and multiplier at the samples."""
    jcfg, tcfg, jmodel, tmodel, variables, jbatch, tbatch = transient_material_slice.build()
    trays = tbatch.rays
    jrays = jbatch.rays
    got, want, _ = _light_radiance_pair(jmodel, tmodel, variables, jrays, trays, True, None)
    for g, w, name in zip(got, want, ("radiance", "mult", "before_occ")):
        material_slice._close(g.numpy(), np.asarray(w), 1e-5, 1e-6, name)
    assert not np.allclose(np.asarray(want[1]), 1.0)


@pytest.mark.parametrize("files", [CORNELL, PEPPERS], ids=["cornell", "peppers"])
def test_param_regularizers_match_jax(files):
    """The scene's regularizer dict, with the base config's appearance and
    material grids, a module, a parameter and a name nothing has added: the
    terms JAX adds (a name matching no parameter adds none), their values and
    gradients. The torch names differ (`grid`); the names match on the JAX
    paths."""
    jt, jmodel, tt, variables = _bridged(files=files, table_scale=1.0)
    extra = {"appearance_grid": (1.0, 2, 1), "material_grid": (1.0, 2, 1),
             "Sampler": (1e-3, 2, 1), "light_power": (0.5, 1, 2.0), "absent": (1.0, 2, 1)}
    jregs = dict(jt.config.param_regularizers,
                 **{k: (m, jnp.mean, a, s) for k, (m, a, s) in extra.items()})
    tregs = dict(tt.config.param_regularizers,
                 **{k: (m, torch.mean, a, s) for k, (m, a, s) in extra.items()})
    assert set(jt.config.param_regularizers) == {"density_grid"}
    jcfg = dataclasses.replace(jt.config, param_regularizers=jregs)
    tcfg = dataclasses.replace(tt.config, param_regularizers=tregs)
    (_, want), jgrad = jax.value_and_grad(
        lambda v: (lambda d: (sum(d.values()), d))(jlosses.param_regularizer_loss(v, jcfg)),
        has_aux=True)(variables)
    got = tlosses.param_regularizer_loss(tt.model, tcfg, material=True)
    assert sorted(got) == sorted(want) == ["Sampler", "appearance_grid", "density_grid",
                                           "light_power"]
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k].detach()), float(v), err_msg=k, **UNIT)
    sum(got.values()).backward()
    jg = material_slice._leaves(jgrad["params"])
    for k, p in tt.model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        material_slice._close(g.numpy(), material_slice._tr(k, jg[k]), *UNIT.values(), k)


def test_geometry_smoothness_matches_jax():
    """The loss on the same final samples (every weight of the loss on): its
    value and the gradients of the final density MLP through the jittered
    "geometry" pass (the density normals' second-order graph among them)."""
    weights_on = ["Config.geometry_smoothness_weight_normals_pred = 0.01",
                  "Config.geometry_smoothness_weight_density = 0.001"]
    jt, jmodel, tt, variables = _bridged(weights_on, table_scale=1.0)
    jrays, trays = _rays(tt)
    rng = np.random.RandomState(4)
    t = np.sort(rng.uniform(2.0, 6.0, (16, 9)), axis=-1).astype(np.float32)
    means = trays.origins.numpy()[:, None] + (0.5 * (t[:, 1:] + t[:, :-1]))[..., None] * \
        trays.viewdirs.numpy()[:, None]
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)  # noqa: E731
    geometry = dict(
        means=means, covs=np.broadcast_to(1e-4 * np.eye(3, dtype=np.float32),
                                          (16, 8, 3, 3)).copy(),
        tdist=t, weights=rng.uniform(0.0, 0.3, (16, 8)).astype(np.float32),
        normals=unit(rng.normal(size=(16, 8, 3))).astype(np.float32),
        normals_pred=unit(rng.normal(size=(16, 8, 3))).astype(np.float32),
        density=rng.uniform(0.0, 2.0, (16, 8)).astype(np.float32))
    jgeom = {k: jnp.asarray(v) for k, v in geometry.items()}
    tgeom = {k: torch.as_tensor(v) for k, v in geometry.items()}

    def jloss(v):
        return jextra.geometry_smoothness_loss(jmodel, v, jax.random.PRNGKey(0), jrays,
                                               jt.config, None, {"geometry": jgeom}, {},
                                               train_frac=TRAIN_FRAC)

    with material_slice.injected(5), jhash.xla_encoder_scope():
        want, jgrad = jax.jit(jax.value_and_grad(jloss))(variables)
    with material_slice.injected(5):
        got = textra.geometry_smoothness_loss(tt.model, tt.rng, trays, tt.config, None,
                                              {"geometry": tgeom}, {}, train_frac=TRAIN_FRAC)
    np.testing.assert_allclose(float(got), float(want), **LOSS)
    got.backward()
    jg = material_slice._leaves(jgrad["params"])
    reached = []
    for k, p in tt.model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        material_slice._close(g.numpy(), material_slice._tr(k, jg[k]), *GRAD, k)
        if g.abs().max() > 0:
            reached.append(k)
    assert reached and all(k.startswith("cache.sampler.mlps.2.") for k in reached)


def test_density_radius_filter_and_normal_offset_match_jax():
    """Peppers' secondary-ray density filter (zero density beyond 2.5 at the
    last level) and the near bound of secondary rays that carry the normal
    they leave: the sampler's levels in both packages."""
    _, jmodel, tt, variables = _bridged(files=PEPPERS, table_scale=1.0)
    sampler = tt.model.cache.sampler
    assert sampler.use_density_radius and sampler.density_radius == 2.5
    jrays, trays = _rays(tt)
    normals = np.random.RandomState(6).normal(size=(16, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    jrays, trays = (jrays.replace(normals=jnp.asarray(normals)),
                    trays.replace(normals=torch.as_tensor(normals)))
    strategy = ((0, 0, 8), (1, 1, 8), (2, 2, 8))

    def levels(module, rays):
        return module.cache.sampler(rng=jax.random.PRNGKey(0), rays=rays, train_frac=TRAIN_FRAC,
                                    train=True, sampling_strategy=strategy, is_secondary=True)

    with material_slice.injected(9), jhash.xla_encoder_scope():
        want = jax.jit(lambda v: jmodel.apply(v, jrays, method=levels))(variables)
    with material_slice.injected(9), torch.no_grad():
        got = sampler(tt.rng, trays, train_frac=TRAIN_FRAC, train=True,
                      sampling_strategy=strategy, is_secondary=True)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("tdist", "density", "weights"):
            material_slice._close(g[k].numpy(), np.asarray(w[k]), 1e-4, 1e-6, f"level {i} {k}")
    beyond = np.linalg.norm(got[-1]["means"].numpy(), axis=-1) > 2.5
    assert beyond.any() and not beyond.all()
    assert not got[-1]["density"].numpy()[beyond].any()
    # The offset moved the near bound of the rays leaving a front face.
    facing = (trays.viewdirs.numpy() * normals).sum(-1) > 0
    assert facing.any() and np.all(got[0]["tdist"].numpy()[facing, 0] > tt.config.near)


def test_use_occlusions_field_is_read_by_nothing():
    """TransientNeRFMLP.use_occlusions, as in JAX, is a field nothing reads
    (shadow rays follow Config.use_occlusions): with the config's occlusions
    off, a model built with it on renders exactly what one built with it off
    does."""
    renders = []
    for field in (False, True):
        tt = trainer_test.synthesize("torch", CORNELL, TRANSIENT_TINY + [
            f"TransientNeRFMLP.use_occlusions = {field}"], "cache")
        assert not tt.config.use_occlusions
        model = tconstruct.make_model(tt.config, device="cpu")
        assert model.cache.shader.use_occlusions == field
        if renders:
            model.load_state_dict(state)
        state = model.state_dict()
        tt._setup_rng()
        tt._load_datasets()
        _, trays = _rays(tt)
        with material_slice.injected(2), torch.no_grad():
            renders.append(model(None, trays, train_frac=TRAIN_FRAC, train=True)["render"])
        tgin.clear_config()
    for k, v in renders[0].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, renders[1][k]), k


def test_cornell_entry_point_trains_resumes_and_evaluates(tmp_path):
    """train_with_trainer on the narrow cornell cache stage with the finetune
    stages' occlusion bindings, on the CPU: two steps from Pixels batches,
    the checkpoint, a second run that resumes it and takes no step, and one
    test view cast on the host."""
    ckpt = str(tmp_path / "cornell_cache")
    args = ["--device", "cpu", f"--gin_configs={CORNELL[0]}"] + [
        f"--gin_bindings={b}" for b in TRANSIENT_TINY + OCCLUSIONS + [
            f"Config.checkpoint_dir = '{ckpt}'", "Config.early_exit_steps = 2",
            "Trainer.save_results = False",
            "Config.metric_harness_train_config = {'disable_lpips': True}"]]
    trainer = train_with_trainer.main(args)
    assert trainer.state.step == 2 and tckpt.latest_checkpoint_step(ckpt) == 2
    tgin.clear_config()
    assert train_with_trainer.main(args).state.step == 2
    metrics = trainer.log_test_set_evaluation(2, 1.0)
    assert np.isfinite(metrics["psnr"]) and 0 <= metrics["transient_iou"] <= 1


@pytest.mark.parametrize("scene", ["pots", "kitchen", "peppers"])
def test_simulated_scenes_cache_step_runs(scene):
    """The other simulated scenes' cache stage (their own lights, light
    powers and regularizers; peppers' density radius) at test widths, with
    the occlusion bindings: one port step from a Pixels batch, every loss
    term finite, the appearance grid trained."""
    tt = trainer_test.synthesize(
        "torch", [f"configs/transient_simulation_ngp_yobo_{scene}.gin"],
        TRANSIENT_TINY + OCCLUSIONS, "cache")
    tt._setup_rng()
    tt._load_datasets()
    tt._setup_model()
    before = tt.model.cache.shader.grid.hash_levels.detach().clone()
    _, stats = tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), TRAIN_FRAC)
    losses = {k: float(v) for k, v in stats["losses"].items()}
    assert {"geometry_smoothness", "regularizer_density_grid", "data"} <= set(losses)
    assert np.all(np.isfinite(list(losses.values())))
    assert not torch.equal(tt.model.cache.shader.grid.hash_levels.detach(), before)
