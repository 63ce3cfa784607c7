"""InvProp's remaining scene options against the JAX package's, at test
widths: kettle_fwp's transient ambient term, statue_fwp's vignette map,
temporal filter, single-channel (1-channel) transients and learnable light
in the cache stage, the steady-state iToF data losses of
cornell_steady_state, and cornell_itof's frequency-iToF loss.

statue_fwp runs without its data (SyntheticSpheres) at 96 bins with
``Config.calib_checkpoint = ''``: its 83-tap Gaussian filter (10.21 bins)
is longer than the 24 bins of the other scenes' tests, where both packages
raise.

Tolerances (float32), tightest first: the iToF projection and the vignette
map on the same inputs to 1e-6 of the output's scale (the projection's bin
times and phases are JAX's bit for bit; its cosines differ by an ulp); the
filter and the iToF losses to 1e-5 of it (sums of up to a few hundred
products, the rawnerf scale's division); the ambient shader's outputs to
1e-4 relative with an absolute 1e-5 x the largest entry, as the appearance
grid's shader in `test_torch_transient_trainer.py` (a ~50-op forward
through the hash grids); the vignette map's gradients to rtol 1e-4 with an
absolute 1e-5 x the leaf's largest entry, the shader's as a step's; loss
terms of a train step to 1e-4 relative with an
absolute 1e-7; every gradient leaf of a step to rtol 2e-3 with an absolute
2e-4 x the leaf's largest entry; after the trainer's Adam step a parameter
within 2 x its group's learning rate of optax's (the tolerances of
`test_torch_transient_trainer.py`).
"""

import dataclasses
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_material_slice as material_slice
import test_torch_material_trainer as material_trainer
import test_torch_trainer as trainer_test
import test_torch_transient_material_trainer as transient_material_trainer
import test_torch_transient_trainer as transient_trainer
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.models import construct as jconstruct
from neural_radiance_caching_tpu.models import nerf_model as jnerf_model
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.ops import render as jrender
from neural_radiance_caching_tpu.ops import render_utils as jrender_utils
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.models import construct as tconstruct
from neural_radiance_caching_tpu_torch.models import nerf_model as tnerf_model
from neural_radiance_caching_tpu_torch.ops import render as trender
from neural_radiance_caching_tpu_torch.ops import render_utils as trender_utils
from neural_radiance_caching_tpu_torch.parallel import losses as tlosses
from neural_radiance_caching_tpu_torch.utils import checkpoints as tckpt
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees
from neural_radiance_caching_tpu_torch.utils import weights

KETTLE = ["configs/transient_simulation_ngp_yobo_kettle_fwp.gin"]
STATUE = ["configs/transient_simulation_ngp_yobo_statue_fwp.gin"]
STEADY = ["configs/transient_simulation_ngp_yobo_cornell_steady_state.gin"]
ITOF = ["configs/transient_simulation_ngp_yobo_cornell_itof.gin"]
# statue_fwp without its calibration checkpoint, at bins that its filter fits.
STATUE_BINDINGS = ["Config.n_bins = 96", "Config.calib_checkpoint = ''"]
SCENES = {"kettle_fwp": (KETTLE, []), "statue_fwp": (STATUE, STATUE_BINDINGS),
          "cornell_steady_state": (STEADY, [])}
TRAIN_FRAC = 0.25
# cornell_itof's (frequency, phase) pairs.
ITOF_PAIRS = [[75000000, 0.0], [75000000, 3.14159265359], [425000000, 0.0],
              [425000000, 3.14159265359]]


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(actual, desired, frac):
    desired = np.asarray(desired)
    scale = max(float(np.abs(desired).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0, atol=frac * scale)


# --- the temporal filter -----------------------------------------------------------------

# name: (n_bins, the filter: a Gaussian's sigma, or a length for random taps)
FILTERS = {"gaussian_10.21": (96, 10.21), "asymmetric_even_6": (24, 6), "odd_7": (24, 7)}


@pytest.mark.parametrize("name", sorted(FILTERS))
@pytest.mark.parametrize("filter_indirect", [False, True])
def test_temporal_filter_matches_jax(name, filter_indirect):
    """`volumetric_transient_rendering`'s convolution over the bins: the
    Gaussian of statue's 10.21 bins (83 taps), and random asymmetric taps of
    even and odd length as the rays' impulse response; on the direct
    transient, and on the indirect one under filter_indirect. Outputs and
    the gradients of a probe of the rgb."""
    n_bins, arg = FILTERS[name]
    rng = np.random.RandomState(3)
    r, s, c = 5, 6, 2
    direct = rng.rand(r, s, c).astype(np.float32)
    indirect = rng.rand(r, s, n_bins, c).astype(np.float32)
    w = (rng.rand(r, s) / s).astype(np.float32)
    tdist = np.sort(rng.uniform(1, 10, (r, s + 1)), -1).astype(np.float32)
    extras = dict(ray_dists=rng.uniform(0.5, 5, (r, s, 1)).astype(np.float32),
                  light_dists=rng.uniform(0.5, 5, (r, s, 1)).astype(np.float32))
    impulse = None if name.startswith("gaussian") else rng.uniform(size=arg).astype(np.float32)
    kw = dict(n_bins=n_bins, exposure_time=0.25, filter_indirect=filter_indirect,
              tfilter_sigma=arg if impulse is None else 0.0)
    probe = rng.randn(r, n_bins, c).astype(np.float32)

    def jloss(d, ti):
        out = jrender.volumetric_transient_rendering(
            d, ti, w, w, tdist, 0.0, False, extras=dict(extras, transient_indirect=ti),
            impulse_response=None if impulse is None else jnp.asarray(impulse), **kw)
        return (out["rgb"] * probe).sum(), out

    want = jloss(direct, indirect)[1]
    g_d, g_ti = jax.grad(lambda a, b: jloss(a, b)[0], argnums=(0, 1))(direct, indirect)
    d, ti = _t(direct).requires_grad_(), _t(indirect).requires_grad_()
    got = trender.volumetric_transient_rendering(
        d, ti, _t(w), _t(w), _t(tdist), 0.0, False,
        extras=dict({k: _t(v) for k, v in extras.items()}, transient_indirect=ti),
        impulse_response=None if impulse is None else _t(impulse), shift_form="gather", **kw)
    for k in ("rgb", "transient_direct", "transient_indirect", "transient_direct_no_filter",
              "transient_indirect_no_filter"):
        _close(got[k].detach(), want[k], 1e-5)
    # The filter moved the direct transient (and the indirect one only under
    # filter_indirect).
    assert not torch.allclose(got["transient_direct"], got["transient_direct_no_filter"])
    assert torch.equal(got["transient_indirect"], got["transient_indirect_no_filter"]) == (
        not filter_indirect)
    (got["rgb"] * _t(probe)).sum().backward()
    _close(d.grad, g_d, 1e-5)
    _close(ti.grad, g_ti, 1e-5)


def test_convolve_bins_is_jax_convolve_same():
    """The alignment alone, on a 6-tap asymmetric filter (an off-by-one
    shows here where a symmetric one hides it), and the Gaussian's taps."""
    rng = np.random.RandomState(0)
    x = rng.normal(size=(7, 24, 3)).astype(np.float32)
    for filt in (rng.uniform(size=6).astype(np.float32), np.asarray([0.0, 1.0, 0.0, 0.0])):
        want = jax.scipy.signal.convolve(jnp.asarray(x), jnp.asarray(filt)[None, :, None],
                                         mode="same")
        _close(trender.convolve_bins(_t(x), _t(filt)), want, 1e-6)
    np.testing.assert_allclose(trender.gaussian_filter(10.21).numpy(),
                               np.asarray(jrender._gaussian_filter(10.21)), rtol=1e-5, atol=1e-9)
    assert trender.gaussian_filter(10.21).shape == (83,)


def test_filter_longer_than_the_bins_raises_in_both():
    x = np.ones((4, 24, 1), np.float32)
    filt = np.asarray(jrender._gaussian_filter(10.21))
    with pytest.raises(ValueError, match="smaller than the other"):
        jax.scipy.signal.convolve(jnp.asarray(x), jnp.asarray(filt)[None, :, None], mode="same")
    with pytest.raises(ValueError, match="83 taps .* 24 time bins"):
        trender.convolve_bins(_t(x), _t(filt))


# --- the iToF projection and data losses -------------------------------------------------


@pytest.mark.parametrize("pairs", ["cornell_itof", "none"])
@pytest.mark.parametrize("shape", [(4, 700, 3), (4, 1933, 1)])
def test_dtof_to_itof_matches_jax(pairs, shape):
    """cornell_itof's four (frequency, phase) pairs (the phase reaches ~60
    rad at 425 MHz over 700 bins) and the steady-state configs' none, at
    cornell's [R, 700, 3] and statue's [R, 1933, 1] with their exposures."""
    exposure = 0.01 if shape[1] == 700 else 0.010376310322275158
    fps = ITOF_PAIRS if pairs == "cornell_itof" else []
    x = np.random.RandomState(1).normal(size=shape).astype(np.float32)
    want = jrender_utils.dtof_to_itof(jnp.asarray(x), fps, exposure)
    got = trender_utils.dtof_to_itof(_t(x), fps, exposure)
    assert tuple(got.shape) == tuple(want.shape) == (shape[0], 2 * len(fps) + 1, shape[2])
    _close(got, want, 1e-6)


ITOF_TYPES = ["mse_itof", "mse_itof_unbiased", "rawnerf_transient_itof",
              "rawnerf_transient_itof_unbiased"]


@pytest.mark.parametrize("loss_type", ITOF_TYPES)
@pytest.mark.parametrize("pairs", ["cornell_itof", "none"])
def test_itof_loss_types_match_jax(loss_type, pairs):
    """`select_data_loss_fn` of the four iToF types on the same rendering,
    second estimate and targets: values and the gradient of their sum with
    respect to the rendering."""
    rng = np.random.RandomState(2)
    shape = (4, 32, 3)
    rgb, nocorr, gt, gt_nocorr = (rng.rand(*shape).astype(np.float32) for _ in range(4))
    cfg = types.SimpleNamespace(
        data_loss_type=loss_type, exposure_time=0.5,
        itof_frequency_phase_shifts=ITOF_PAIRS if pairs == "cornell_itof" else [],
        use_gt_rawnerf=False, use_combined_rawnerf=False, use_norm_rawnerf=False)

    def jloss(x):
        return jlosses.select_data_loss_fn(cfg, {"rgb": x, "rgb_nocorr": nocorr}, gt, gt_nocorr,
                                           0.1, 2.0, transient=True)

    want = jloss(jnp.asarray(rgb))
    jgrad = jax.grad(lambda x: jloss(x).sum())(jnp.asarray(rgb))
    x = _t(rgb).requires_grad_()
    got = tlosses.select_data_loss_fn(cfg, {"rgb": x, "rgb_nocorr": _t(nocorr)}, _t(gt),
                                      _t(gt_nocorr), 0.1, 2.0, transient=True)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.detach(), want, 1e-5)
    got.sum().backward()
    _close(x.grad, jgrad, 1e-5)


def _data_losses(files, bindings, n_bins):
    """compute_data_loss of both packages on one rendering and target of
    `n_bins` (the configs' own loss type and weights), or the exception each
    raises."""
    jt = trainer_test.synthesize("jax", files, bindings, "cache")
    tt = trainer_test.synthesize("torch", files, bindings, "cache")
    # The train step takes each output's loss type from the model: the
    # cache's here.
    loss_type = tgin.query_parameter("TransientMaterialModel.cache_loss")
    assert jgin.query_parameter("TransientMaterialModel.cache_loss") == loss_type
    jcfg = dataclasses.replace(jt.config, data_loss_type=loss_type)
    tcfg = dataclasses.replace(tt.config, data_loss_type=loss_type)
    rng = np.random.RandomState(6)
    rgb, gt = (rng.rand(6, n_bins, 3).astype(np.float32) * 0.1 for _ in range(2))
    lossmult = rng.uniform(0.5, 1.0, (6, 1)).astype(np.float32)
    masks = (rng.rand(6, 1) > 0.3).astype(np.float32)
    jrays = dataclasses.replace(jpytrees.dummy_rays(6), lossmult=lossmult)
    trays = tpytrees.Rays(*([None] * 12), lossmult=_t(lossmult), near=None, far=None,
                          cam_idx=None, light_idx=None)
    out = []
    for call in (
            lambda: jlosses.compute_data_loss(
                jpytrees.Batch(rays=jrays, rgb=gt, masks=masks), {"rgb": rgb}, jrays, jcfg,
                main=True, transient=True)[0],
            lambda: tlosses.compute_data_loss(
                tpytrees.Batch(rays=trays, rgb=_t(gt), masks=_t(masks)), {"rgb": _t(rgb)},
                trays, tcfg, main=True, transient=True)[0]):
        try:
            out.append(float(call()))
        except (TypeError, NotImplementedError) as e:
            out.append(e)
    return loss_type, out


def test_cornell_steady_state_cache_data_loss_matches_jax():
    loss_type, (want, got) = _data_losses(STEADY, transient_trainer.TRANSIENT_TINY, 24)
    assert loss_type == "rawnerf_transient_itof"
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("n_bins", [24, 9])
def test_cornell_itof_data_loss_runs_only_where_jax_does(n_bins):
    """cornell_itof's cache loss projects onto 2 x 4 + 1 = 9 iToF rows and
    weighs them by a loss weight per time bin: JAX's compute_data_loss
    raises a TypeError unless the bins broadcast against the 9 rows, and the
    port raises a NotImplementedError naming that failure; at 9 bins both
    run and agree."""
    loss_type, (want, got) = _data_losses(
        ITOF, transient_trainer.TRANSIENT_TINY + [f"Config.n_bins = {n_bins}"], n_bins)
    assert loss_type == "rawnerf_transient_itof"
    if n_bins == 9:
        np.testing.assert_allclose(got, want, rtol=1e-5)
        return
    assert isinstance(want, TypeError) and "incompatible shapes for broadcasting" in str(want)
    assert isinstance(got, NotImplementedError)
    assert "mul got incompatible shapes for broadcasting" in str(got)


def test_cornell_itof_step_raises_in_both_trainers():
    """The whole cache step of cornell_itof at 24 bins: JAX's trace raises
    its TypeError at the data loss, the port's step its NotImplementedError."""
    jt, jmodel, tt = transient_trainer._cornell((), ITOF)
    variables = material_trainer._variables(jmodel, 5)
    jdata = jdatasets.load_dataset("train", None, jt.config)
    with pytest.raises(TypeError, match="incompatible shapes for broadcasting"):
        with material_slice.injected(7), jhash.xla_encoder_scope():
            transient_trainer.jax_step_loss(jmodel, jt.config, jdata, TRAIN_FRAC)(
                variables, jdata.next_train())
    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    with pytest.raises(NotImplementedError, match="rawnerf_transient_itof"):
        with material_slice.injected(7):
            tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), TRAIN_FRAC)


# --- the vignette map and the ambient term -----------------------------------------------


@pytest.mark.parametrize("depth", [2, 5])
def test_vignette_map_matches_jax(depth):
    """`VignetteMap` at its default depth 2 (no skip) and at depth 5, where
    JAX's skip test after the loop (its last index, 4) concatenates the
    encoded input before the output layer: output and every gradient leaf
    of a probe, through the weight bridge."""
    rng = np.random.RandomState(depth)
    viewdirs = rng.normal(size=(9, 3)).astype(np.float32)
    viewdirs /= np.linalg.norm(viewdirs, axis=-1, keepdims=True)
    look = rng.normal(size=(9, 3)).astype(np.float32)
    probe = rng.normal(size=(9, 1)).astype(np.float32)
    jrays = types.SimpleNamespace(viewdirs=jnp.asarray(viewdirs), look=jnp.asarray(look))
    jmap = jnerf_model.VignetteMap(net_depth_vignette=depth, net_width_vignette=16)
    params = material_slice.random_variables(
        jax.eval_shape(lambda: jmap.init(jax.random.PRNGKey(0), jrays)), 3)["params"]
    want, jgrad = jax.value_and_grad(
        lambda p: (jmap.apply({"params": p}, jrays) * probe).sum())(params)
    holder = torch.nn.Module()
    holder.vignette_map = tnerf_model.VignetteMap(net_depth_vignette=depth,
                                                  net_width_vignette=16)
    holder.load_state_dict(weights.state_dict_from_jax({"VignetteMap": params}, holder))
    assert holder.vignette_map.output_layer.in_features == 16 + (5 if depth == 5 else 0)
    trays = types.SimpleNamespace(viewdirs=_t(viewdirs), look=_t(look))
    out = holder.vignette_map(trays)
    assert tuple(out.shape) == (9, 1) and float(out.min()) > 0 and float(out.max()) < 2
    _close(out.detach(), jmap.apply({"params": params}, jrays), 1e-6)
    (out * _t(probe)).sum().backward()
    leaves = material_slice._leaves({"VignetteMap": jgrad})
    assert len(leaves) == 2 * (depth + 1)
    for k, p in holder.named_parameters():
        material_slice._close(p.grad.numpy(), material_slice._tr(k, leaves[k]), 1e-4, 1e-5, k)


def test_transient_ambient_term_matches_jax(monkeypatch):
    """kettle_fwp's cache shader (use_ambient): the ambient head and the
    tinted, integrated-BRDF-weighted ambient radiance of the SLF, clamped to
    rgb_max and folded into the indirect outputs; the outputs, and every
    shader leaf's gradient of a probe of indirect_rgb (the ambient head's
    among them)."""
    jt, jmodel, tt, variables = transient_trainer._bridged(files=KETTLE, appearance_scale=1.0)
    assert tt.model.cache.shader.use_ambient
    jrays, trays = transient_trainer._rays(tt)
    w = np.random.RandomState(0).uniform(size=(16, 8, 3)).astype(np.float32)
    keys = ("rgb", "ambient_rgb", "ambient_diffuse_rgb", "ambient_specular_rgb", "indirect_rgb",
            "diffuse_rgb", "specular_rgb", "indirect_diffuse_rgb", "indirect_specular_rgb")

    def jloss(v):
        shader = jmodel.apply(v, jax.random.PRNGKey(0), jrays, train_frac=TRAIN_FRAC, train=True,
                              compute_extras=False)["main"]["shader"]
        return jnp.sum(shader["indirect_rgb"] * w), {k: shader[k] for k in keys}

    with material_slice.injected(3), jhash.xla_encoder_scope():
        (_, want), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables)
    with material_slice.injected(3):
        shader = tt.model(tt.rng, trays, train_frac=TRAIN_FRAC, train=True,
                          compute_extras=False)["main"]["shader"]
        (shader["indirect_rgb"] * _t(w)).sum().backward()
    assert float(shader["ambient_rgb"].abs().max()) > 0
    transient_trainer._close_tree(shader, want, 1e-4, 1e-5)
    jg = material_slice._leaves(jgrad["params"])
    grads = {k: p.grad for k, p in tt.model.named_parameters()
             if k.startswith("cache.shader.") and p.grad is not None}
    assert float(grads["cache.shader.ambient_irradiance_layer.weight"].abs().max()) > 0
    for k, g in grads.items():
        material_slice._close(g.numpy(), material_slice._tr(k, jg[k]), *material_trainer.GRAD, k)


# --- one step through both trainers ------------------------------------------------------


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_one_cache_step_through_both_trainers(scene, monkeypatch):
    """One cache step of each scene from the same weights and draws: every
    loss term, every gradient leaf, the Adam step; the leveled kernel's one
    launch (the appearance grid). statue_fwp: the vignette on the cache's
    render, 1 channel, the Gaussian filter, shadow rays, and the learnable
    light the cache reads from its material model's shader."""
    files, extra = SCENES[scene]
    jt, jmodel, tt = transient_trainer._cornell(extra, files)
    variables = material_trainer._variables(jmodel, 5)
    got, calls = transient_material_trainer._step_parity(jt, jmodel, tt, variables, monkeypatch)
    assert calls == ["leveled"]
    assert "data" in got and "cache_data" in got
    groups = {weights.jax_path(k)[0] for k in tt.model.state_dict()}
    assert groups == set(variables["params"])
    if scene == "statue_fwp":
        cfg = tt.config
        assert (cfg.num_rgb_channels, cfg.tfilter_sigma, cfg.use_occlusions) == (1, 10.21, True)
        assert groups == {"Cache", "MaterialShader", "VignetteMap"}
        assert got["geometry_smoothness"] > 0


# --- the calibration restore -------------------------------------------------------------


@pytest.mark.parametrize("optimize_calib_on_load", [False, True])
def test_calibration_checkpoint_restores_the_vignette(optimize_calib_on_load, tmp_path):
    """statue_fwp's `Config.calib_checkpoint`, a port checkpoint: its
    VignetteMap, and nothing else, is restored into the stage's model (JAX
    `engine/trainer.py`'s restore with `replace_dict` on
    `params/VignetteMap`), and the stage's step leaves it as it is unless
    `Config.optimize_calib_on_load` (its learning rates are 0, as JAX's
    `disable(["VignetteMap"])` sets them)."""
    files, extra = SCENES["statue_fwp"]
    _, _, source = transient_trainer._cornell(extra, files)
    with torch.no_grad():
        for p in source.model.vignette_map.parameters():
            p.uniform_(-0.5, 0.5)
    tckpt.save_checkpoint(str(tmp_path), source._state_tree(), 1)
    calib = {k: v.clone() for k, v in source.model.state_dict().items()
             if k.startswith("vignette_map.")}
    tgin.clear_config()
    _, _, tt = transient_trainer._cornell(
        extra + [f"Config.calib_checkpoint = '{tmp_path}'",
                 f"Config.optimize_calib_on_load = {optimize_calib_on_load}"], files)
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}
    tt._setup_checkpointing()
    after = tt.model.state_dict()
    assert {k for k in after if not torch.equal(after[k], before[k])} == set(calib)
    for k, v in calib.items():
        assert torch.equal(after[k], v)
    state, _ = tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), TRAIN_FRAC)
    params = dict(tt.model.named_parameters())

    def lr(key):
        return max(g["lr"] for g in state.optimizer.param_groups
                   if any(q is params[key] for q in g["params"]))

    assert lr("cache.shader.bottleneck_layer.weight") > 0
    assert all((lr(k) > 0) == optimize_calib_on_load for k in calib)
    if not optimize_calib_on_load:
        assert all(torch.equal(params[k].detach(), calib[k]) for k in calib)


# --- what the port builds of every transient config --------------------------------------

TRANSIENT_CONFIGS = sorted(p.name for p in pathlib.Path("configs").glob("transient_*.gin"))


@pytest.mark.parametrize("config", TRANSIENT_CONFIGS)
def test_every_transient_config_builds_jax_groups_or_names_its_option(config):
    """The cache stage of every configs/transient_*.gin at test widths (96
    bins, which the captured scenes' 83-tap filter fits, and no calibration
    checkpoint): the port's model holds JAX's parameter groups. None is
    refused any longer: the passive shader of the `_fwp` simulations and
    the shader without indirect light of the `_tnerf` scenes and
    pots_kitchen build too (tests/test_torch_baseline_scenes.py)."""
    bindings = transient_trainer.TRANSIENT_TINY + STATUE_BINDINGS
    tt = trainer_test.synthesize("torch", [f"configs/{config}"], bindings, "cache")
    groups = {weights.jax_path(k)[0] for k in tconstruct.make_model(
        tt.config, device="cpu").state_dict()}
    jt = trainer_test.synthesize("jax", [f"configs/{config}"], bindings, "cache")
    jmodel = jconstruct.make_model(jt.config)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))
    assert groups == set(shapes["params"])
