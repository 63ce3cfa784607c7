"""The transient (InvProp) cache-stage slice end to end: a narrow model with
the flagship transient structure (IPE proposal MLPs, simplex hash pyramid
with a level clamp, the actively lit TransientNeRFMLP with its BRDF net,
time-binned irradiance net and transient surface light field, the transient
integrator and the transient RawNeRF loss) built in both packages with the
same numpy-seeded weights, run on the same transient SyntheticSpheres batch
with the deterministic sampler (rng None), 24 bins of 0.5.

Compared: the batches, the shader's outputs (direct, per-bin indirect
diffuse and specular, the latter through the SLF), the integrated transient
rgb, every loss term, every gradient leaf, the parameters after one Adam
step and the set of parameters no loss reaches; also the SLF alone, the
transient data loss alone and the weights-only rendering. The step runs with
the gather shift (the JAX package's CPU default) and with the FFT shift
(chosen in JAX with ``monkeypatch``) and the port's run-dedup of the table
gradient, which the JAX CPU model's XLA autodiff gradient checks.

Tolerances (float32): values rtol 1e-4 with an atol of 1e-4 x the
output's largest entry. The sampler's compositing weights, which every
transient output inherits, already differ by up to ~5e-5 relative on the
worst ray (the proposal resampling and the density MLP round differently in
the two frameworks), and the direct term's BRDF net amplifies ulp-level
differences of its inputs to ~7e-5 relative in one entry of hundreds; a
wrong term would be off by O(1). Gradients rtol 1e-3 with an atol of 1e-3 x
the leaf's largest entry: sums in another order, with cancelling terms (the
FFT shift's rounding is ~1e-6 of the largest transient per bin). Most
leaves agree to 2.3e-5 of their largest entry; the predicted-normal and
roughness heads reach the loss through the reflected direction, the IDE and
the BRDF net, which amplify the weights' differences, and read up to 4.4e-4.
Adam moves every parameter with a determined gradient sign by exactly
+-lr.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.models import surface_light_field as jslf
from neural_radiance_caching_tpu.models.nerf_model import TransientNeRFModel as JTransientModel
from neural_radiance_caching_tpu.ops import render as jrender
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch import flagship
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.models import surface_light_field as tslf
from neural_radiance_caching_tpu_torch.parallel import losses as tlosses
from neural_radiance_caching_tpu_torch.parallel import train as ttrain
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees
from neural_radiance_caching_tpu_torch.utils import weights

TRAIN_FRAC = 0.5
BATCH = 32
N_BINS = 24
EXPOSURE = 0.5
TRANSIENT = dict(use_transient=True, n_bins=N_BINS, exposure_time=EXPOSURE, learnable_light=True,
                 light_source_position=[0.0, 0.0, 1.0],
                 data_loss_type="rawnerf_transient_unbiased", linear_to_srgb=False)
# No loss reaches these: the ambient term is off (use_ambient=False), so
# neither the shader's ambient irradiance head nor the SLF's ambient head is
# read by the rendering.
UNREACHED = {"shader.ambient_irradiance_layer.weight", "shader.ambient_irradiance_layer.bias",
             "shader.surface_lf.output_ambient_rgb_layer.weight",
             "shader.surface_lf.output_ambient_rgb_layer.bias"}


def narrow(params):
    """The flagship transient structure at test widths (same edits in both
    packages)."""
    p = copy.deepcopy(params)
    sp = p["sampler_params"]
    mlps = [dict(m) for m in sp["mlp_params_per_level"]]
    for m in mlps[:2]:
        m.update(net_width=16, net_depth=2, use_bf16_compute=False)
    mlps[2].update(net_width=16, primary_grid_level_clamp=4)
    sp["mlp_params_per_level"] = tuple(mlps)
    grid = dict(sp["grid_params_per_level"][2], hash_map_size=4096, max_grid_size=128)
    sp["grid_params_per_level"] = (None, None, grid)
    sp["sampling_strategy"] = ((0, 0, 12), (1, 1, 12), (2, 2, 8))
    p["train_sampling_strategy"] = p["render_sampling_strategy"] = sp["sampling_strategy"]
    sh = p["shader_params"]
    sh.update(net_width=16, bottleneck_width=16, net_width_integrated_brdf=8, net_width_brdf=8,
              net_width_irradiance=16, use_bf16_compute=False)
    sh["surface_lf_params"] = dict(sh["surface_lf_params"], net_width_viewdirs=16,
                                   bottleneck_viewdirs=16)
    return p


def jax_params(jcfg):
    """bench.build_flagship_transient_cache_model's parameters, narrowed."""
    p = bench.flagship_cache_params(jcfg)
    p["shader_params"] = dict(p["shader_params"], use_active=True, use_indirect=True,
                              use_ambient=False, net_depth_irradiance=2, net_width_irradiance=64)
    p["resample_secondary"] = False
    return narrow(p)


def jax_forward(self, rays, train_frac):
    """TransientNeRFModel.__call__'s primary-ray path with rng=None
    throughout (the JAX model's own call splits a key for the shader)."""
    sampler = self.sampler(rng=None, rays=rays, train_frac=train_frac, train=True,
                           sampling_strategy=self.train_sampling_strategy, use_raydist_fn=True,
                           is_secondary=False, compute_extras=False)
    filtered, _ = self.maybe_resample(rng=None, resample=False, sampler_results=sampler[-1],
                                      num_resample=1)
    shader = self.shader(rng=None, rays=rays, sampler_results=filtered,
                         filtered_sampler_results=filtered, train_frac=train_frac, train=True,
                         is_secondary=False, compute_extras=False)
    shader.setdefault("weights_no_filter", shader["weights"])
    render = self.integrator(rng=None, rays=rays, shader_results=shader, bg_intensity_range=None,
                             train_frac=train_frac, train=True, is_secondary=False,
                             compute_extras=False)
    main = dict(loss_weight=1.0, sampler=sampler, filtered_sampler_inds=None, shader=shader,
                geometry=sampler[-1], integrator=render)
    return {"main": main, "render": render}


def build(form="gather", scatter_dedup=False, seed=0):
    jcfg = dataclasses.replace(bench._cache_config(), batch_size=BATCH, lr_delay_steps=0,
                               **TRANSIENT)
    tcfg = flagship.transient_config(batch_size=BATCH, lr_delay_steps=0, n_bins=N_BINS,
                                     exposure_time=EXPOSURE, transient_shift_form=form)
    jmodel = JTransientModel(config=jcfg, **jax_params(jcfg))
    tmodel = flagship.build_flagship_transient_cache_model(
        tcfg, narrow(flagship.flagship_transient_cache_params(scatter_dedup)), device="cpu")
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))
    rng = np.random.RandomState(seed)
    variables = jax.tree_util.tree_map(
        lambda s: (rng.uniform(-0.5, 0.5, s.shape)).astype(np.float32), shapes)
    tmodel.load_state_dict(weights.state_dict_from_jax(variables, tmodel))
    jdata = jdatasets.SyntheticSpheres("train", None, jcfg, num_images=3, resolution=16)
    tdata = tdatasets.SyntheticSpheres("train", None, tcfg, num_images=3,
                                       resolution=16, device="cpu")
    return jcfg, tcfg, jmodel, tmodel, variables, jdata.next_train(), tdata.next_train()


def jax_loss(jmodel, jcfg):
    def loss_fn(variables, batch):
        results = jmodel.apply(variables, batch.rays, TRAIN_FRAC, method=jax_forward)
        losses, stats = {}, {}
        jtrain._compute_losses_for_output(None, batch, batch.rays, results, jcfg, TRAIN_FRAC,
                                          "main", losses, stats)
        shader = results["main"]["shader"]
        outs = {k: shader[k] for k in ("direct_rgb", "transient_indirect_diffuse",
                                       "transient_indirect_specular")}
        outs["rgb"] = results["render"]["rgb"]
        return sum(jax.tree_util.tree_leaves(losses)), (losses, outs)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _leaves(tree):
    return {weights.torch_key(tuple(str(getattr(k, "key", k)) for k in path)): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(actual, desired, rtol, atol_frac):
    scale = max(float(np.abs(desired).max()), 1e-30)
    np.testing.assert_allclose(actual, desired, rtol=rtol, atol=atol_frac * scale)


def _tr(key, a):
    return a.T if a.ndim == 2 and key.endswith(".weight") else a


@pytest.mark.parametrize("impulse_sigma", [0.0, 1.5])
def test_transient_batches_are_identical(impulse_sigma):
    jcfg = dataclasses.replace(bench._cache_config(), batch_size=BATCH,
                               synthetic_spheres_impulse_sigma=impulse_sigma, **TRANSIENT)
    tcfg = flagship.transient_config(batch_size=BATCH, n_bins=N_BINS, exposure_time=EXPOSURE,
                                     synthetic_spheres_impulse_sigma=impulse_sigma)
    jbatch = jdatasets.SyntheticSpheres("train", None, jcfg, num_images=3,
                                        resolution=16).next_train()
    tbatch = tdatasets.SyntheticSpheres("train", None, tcfg, num_images=3,
                                        resolution=16, device="cpu").next_train()
    assert tuple(tbatch.rgb.shape) == (BATCH, N_BINS, 3)
    np.testing.assert_array_equal(tbatch.rgb.numpy(), jbatch.rgb)
    np.testing.assert_array_equal(tbatch.masks.numpy(), jbatch.masks)
    assert float(tbatch.rgb.sum()) > 0
    for name in ("origins", "viewdirs", "lights", "cam_origins", "lossmult"):
        np.testing.assert_allclose(getattr(tbatch.rays, name).numpy(),
                                   np.float32(getattr(jbatch.rays, name)), rtol=1e-6, atol=1e-7)
    if impulse_sigma:
        np.testing.assert_array_equal(tbatch.rays.impulse_response.numpy(),
                                      jbatch.rays.impulse_response)
    else:
        assert tbatch.rays.impulse_response is None and jbatch.rays.impulse_response is None


@pytest.mark.parametrize("form,scatter_dedup", [("gather", False), ("fft", True)])
def test_transient_step_matches_jax(form, scatter_dedup, monkeypatch):
    monkeypatch.setattr(jrender, "_FFT_TRANSIENT_SHIFT", form != "gather")
    monkeypatch.setattr(jrender, "_SPECTRAL_BACKEND", "fft")
    jcfg, tcfg, jmodel, tmodel, variables, jbatch, tbatch = build(form, scatter_dedup)
    (jtotal, (jloss_terms, jouts)), jgrad = jax_loss(jmodel, jcfg)(variables, jbatch)

    with torch.no_grad():
        out = tmodel(None, tbatch.rays, train_frac=TRAIN_FRAC, train=True)
    touts = {k: out["main"]["shader"][k] for k in jouts if k != "rgb"}
    touts["rgb"] = out["render"]["rgb"]
    assert tuple(touts["rgb"].shape) == (BATCH, N_BINS, 3)
    assert float(np.abs(np.asarray(jouts["transient_indirect_specular"])).max()) > 0
    for k, v in jouts.items():
        _close(touts[k].numpy(), np.asarray(v), rtol=1e-4, atol_frac=1e-4)

    state, _ = ttrain.create_optimizer(tcfg, tmodel)
    params_before = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    state, stats = ttrain.create_train_step(tmodel, tcfg)(None, state, tbatch, TRAIN_FRAC)
    assert sorted(stats["losses"]) == sorted(jloss_terms)
    for k, v in jloss_terms.items():
        np.testing.assert_allclose(float(torch.as_tensor(stats["losses"][k]).detach()), float(v),
                                   rtol=1e-5, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(float(stats["loss"]), float(jtotal), rtol=1e-5)

    jgrad = jlosses.clip_gradients(jax.tree_util.tree_map(jnp.nan_to_num, jgrad), jcfg)
    jg = _leaves(jgrad["params"])
    tparams = dict(tmodel.named_parameters())
    assert sorted(jg) == sorted(tparams)
    for key, g in jg.items():
        _close(tparams[key].grad.numpy(), _tr(key, g), rtol=1e-3, atol_frac=1e-3)
    assert {k for k, g in jg.items() if not np.any(g)} == UNREACHED

    jstate, _ = jtrain.create_optimizer(jcfg, variables)
    jnew = _leaves(jstate.apply_gradients(grads=jgrad).params["params"])
    lr = float(state.lr_fn(0))
    for key, p_new in jnew.items():
        p_new, g = _tr(key, p_new), _tr(key, jg[key])
        t_new = tparams[key].detach().numpy()
        before = params_before[key].numpy()
        determined = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(t_new[determined], p_new[determined], rtol=0, atol=1e-6,
                                   err_msg=key)
        assert np.all(np.abs(t_new - before) <= lr * (1 + 1e-5) + 1e-7), key


def test_transient_slf_matches_jax():
    jcfg = dataclasses.replace(bench._cache_config(), **TRANSIENT)
    tcfg = flagship.transient_config(n_bins=N_BINS, exposure_time=EXPOSURE)
    slf = dict(narrow(flagship.flagship_transient_cache_params())["shader_params"][
        "surface_lf_params"], distance_near=float("inf"), distance_far=float("inf"))
    rng = np.random.RandomState(3)
    refdirs = rng.randn(4, 5, 3).astype(np.float32)
    refdirs /= np.linalg.norm(refdirs, axis=-1, keepdims=True)
    args = (rng.randn(4, 5, 3).astype(np.float32), refdirs)
    kw = dict(roughness=rng.uniform(0.05, 1.0, (4, 5, 1)).astype(np.float32),
              shader_bottleneck=rng.randn(4, 5, 16).astype(np.float32))
    jmod = jslf.TransientSurfaceLightFieldMLP(config=jcfg, use_env_alpha=True, **slf)
    variables = jax.tree_util.tree_map(
        lambda s: rng.uniform(-0.5, 0.5, s.shape).astype(np.float32),
        jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), None, None, {}, *args, **kw)))
    want = jmod.apply(variables, None, None, {}, *args, **kw)
    tmod = tslf.TransientSurfaceLightFieldMLP(config=tcfg, use_env_alpha=True,
                                              shader_bottleneck_dim=16, **slf)
    tmod.load_state_dict(weights.state_dict_from_jax(variables, tmod))
    got = tmod(None, None, {}, *map(torch.as_tensor, args),
               **{k: torch.as_tensor(v) for k, v in kw.items()})
    assert tuple(got["incoming_rgb"].shape) == (4, 5, 3 * N_BINS)
    for k in ("incoming_rgb", "incoming_ambient_rgb", "incoming_alpha", "incoming_acc"):
        _close(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-5, atol_frac=1e-6)


@pytest.mark.parametrize("loss_thresh,masked", [(float("inf"), False), (0.05, True)])
def test_transient_data_loss_matches_jax(loss_thresh, masked):
    jcfg = dataclasses.replace(bench._cache_config(), loss_thresh=loss_thresh, **TRANSIENT)
    tcfg = flagship.transient_config(loss_thresh=loss_thresh, n_bins=N_BINS)
    rng = np.random.RandomState(4)
    rgb = rng.rand(6, N_BINS, 3).astype(np.float32) * 0.1
    gt = rng.rand(6, N_BINS, 3).astype(np.float32) * 0.1
    lossmult = rng.uniform(0.5, 1.0, (6, 1)).astype(np.float32)
    masks = (rng.rand(6, 1) > 0.3).astype(np.float32) if masked else None
    jloss, _ = jlosses.compute_data_loss(
        jpytrees.Batch(rays=dataclasses.replace(jpytrees.dummy_rays(6), lossmult=lossmult),
                       rgb=gt, masks=masks),
        {"rgb": rgb}, dataclasses.replace(jpytrees.dummy_rays(6), lossmult=lossmult), jcfg,
        main=True, transient=True)
    trays = tpytrees.Rays(*([None] * 12), lossmult=torch.as_tensor(lossmult), near=None,
                          far=None, cam_idx=None, light_idx=None)
    tgt = tpytrees.Batch(rays=trays, rgb=torch.as_tensor(gt),
                         masks=None if masks is None else torch.as_tensor(masks))
    trgb = torch.as_tensor(rgb).requires_grad_()
    tloss, _ = tlosses.compute_data_loss(tgt, {"rgb": trgb}, trays, tcfg, main=True,
                                         transient=True)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    jgrad = jax.grad(lambda r: jlosses.compute_data_loss(
        jpytrees.Batch(rays=dataclasses.replace(jpytrees.dummy_rays(6), lossmult=lossmult),
                       rgb=gt, masks=masks),
        {"rgb": r}, dataclasses.replace(jpytrees.dummy_rays(6), lossmult=lossmult), jcfg,
        main=True, transient=True)[0])(rgb)
    tloss.backward()
    _close(trgb.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol_frac=1e-6)


def test_weights_only_rendering_matches_jax():
    """The weights-only pass (the shadow rays') renders the opacity alone,
    the one output its caller reads: JAX's."""
    jcfg, tcfg, jmodel, tmodel, variables, jbatch, tbatch = build()
    want = jmodel.apply(variables, None, jbatch.rays, train_frac=TRAIN_FRAC, train=True,
                        weights_only=True, compute_extras=False)["render"]
    with torch.no_grad():
        got = tmodel(None, tbatch.rays, train_frac=TRAIN_FRAC, train=True, weights_only=True,
                     compute_extras=False)["render"]
    assert sorted(got) == ["acc"]
    _close(got["acc"].numpy(), np.asarray(want["acc"]), rtol=1e-4, atol_frac=1e-4)


def test_port_trains_transient_steps():
    _, tcfg, _, tmodel, _, _, _ = build(form="fft", scatter_dedup=True)
    data = tdatasets.SyntheticSpheres("train", None, tcfg, num_images=3,
                                      resolution=16, device="cpu")
    state, _ = ttrain.create_optimizer(tcfg, tmodel)
    step = ttrain.create_train_step(tmodel, tcfg)
    rng = torch.Generator().manual_seed(7)
    before = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    losses = []
    for _ in range(3):
        state, stats = step(rng, state, data.next_train(), TRAIN_FRAC)
        losses.append(float(stats["loss"]))
    assert state.step == 3 and np.all(np.isfinite(losses))
    assert {k for k, v in tmodel.state_dict().items() if torch.equal(v, before[k])} == UNREACHED


def test_unported_transient_options_raise():
    """Cone lights and the canonical light frame once raised here; they
    build now, the canonical frame's irradiance net reading 5 light channels
    (both held against JAX in tests/test_torch_shader_fields.py), as does
    the ambient term (use_ambient, tests/test_torch_invprop_scenes.py)."""
    cfg = flagship.transient_config()
    params = flagship.flagship_transient_cache_params()
    ambient = dict(params, shader_params=dict(params["shader_params"], use_ambient=True))
    assert flagship.build_flagship_transient_cache_model(cfg, ambient, device="cpu").shader.use_ambient
    p = dict(params, shader_params=dict(params["shader_params"], light_max_angle=30.0))
    cone = flagship.build_flagship_transient_cache_model(cfg, p, device="cpu")
    assert cone.shader.light_max_angle == 30.0
    plain = flagship.build_flagship_transient_cache_model(cfg, params, device="cpu").shader
    canonical = flagship.build_flagship_transient_cache_model(
        flagship.transient_config(light_canonical_frame=True), params, device="cpu").shader
    def in_dim(shader):
        return next(iter(shader.irradiance_layers.children())).in_features

    assert in_dim(canonical) - in_dim(plain) == 2 * (1 + 2 * plain.deg_lights)
