"""The cache-stage slice end to end: a narrow model with the flagship's
structure (IPE proposal MLPs, simplex hash pyramid with a level clamp,
shared density feature, reflections, surface light field) built in both
packages with the same numpy-seeded weights, run on the same batch with the
deterministic sampler (rng None).

Compared: the batches the two SyntheticSpheres produce, the rendered rgb,
every loss term, every gradient leaf, and the parameters after one Adam
step.

Tolerances (float32): the forward is a chain of ~40 ops whose sample
positions feed later levels, so values agree to 1e-5. Gradients are sums
taken in another order (the table gradient by scatter, the biases over every
sample) whose terms cancel: a bias gradient of 3.5e-5 is the sum of
contributions ~100x larger, and a coarse grid cell sums hundreds of updates
of both signs. So gradients are held to rtol 1e-3 with an atol of 1e-4 x the
leaf's largest entry; a wrong term would be off by O(1). The first Adam step moves every
parameter by lr * g / (|g| + 1e-15), i.e. by exactly +-lr wherever the
gradient is not zero, so new parameters agree to float32 rounding of p +- lr
wherever the gradient's sign is determined (|g| above 1e-3 of the leaf's
largest entry); below that, the step is only required to be at most lr.
With bf16 trunks the two frameworks round at different places, and a bf16
ulp in a proposal density can move a ray's samples: rgb errors are bounded
in mean (5e-3) and 95th percentile (2e-2), loss terms to 5e-2 relative.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.models.nerf_model import NeRFModel as JNeRFModel
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch import flagship
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.parallel import train as ttrain
from neural_radiance_caching_tpu_torch.utils import weights

TRAIN_FRAC = 0.5
BATCH = 48


def narrow(params, bf16=False):
    """The flagship structure at test widths (same edits in both packages)."""
    p = copy.deepcopy(params)
    sp = p["sampler_params"]
    mlps = [dict(m) for m in sp["mlp_params_per_level"]]
    for m in mlps[:2]:
        m.update(net_width=16, net_depth=2, use_bf16_compute=bf16)
    mlps[2].update(net_width=16, primary_grid_level_clamp=4)
    sp["mlp_params_per_level"] = tuple(mlps)
    grid = dict(sp["grid_params_per_level"][2], hash_map_size=4096, max_grid_size=128)
    sp["grid_params_per_level"] = (None, None, grid)
    sp["sampling_strategy"] = ((0, 0, 12), (1, 1, 12), (2, 2, 8))
    p["train_sampling_strategy"] = p["render_sampling_strategy"] = sp["sampling_strategy"]
    sh = p["shader_params"]
    sh.update(net_width=16, bottleneck_width=16, net_width_integrated_brdf=8,
              use_bf16_compute=bf16)
    sh["surface_lf_params"] = dict(sh["surface_lf_params"], net_width_viewdirs=16,
                                   bottleneck_viewdirs=16)
    return p


def jax_forward(self, rays, train_frac):
    """NeRFModel.__call__'s primary-ray path with rng=None throughout (the
    JAX model's own call splits a key for the shader pass)."""
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


def build(bf16=False, lr_delay_steps=0, seed=0):
    jcfg = bench._cache_config()
    jcfg.batch_size = BATCH
    jcfg.lr_delay_steps = lr_delay_steps
    tcfg = flagship.cache_config(batch_size=BATCH, lr_delay_steps=lr_delay_steps)
    jmodel = JNeRFModel(config=jcfg, **narrow(bench.flagship_cache_params(jcfg), bf16))
    tmodel = flagship.build_flagship_cache_model(
        tcfg, narrow(flagship.flagship_cache_params(), bf16), device="cpu")
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
        return sum(jax.tree_util.tree_leaves(losses)), (losses, results["render"]["rgb"])

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _leaves(tree):
    return {weights.torch_key(tuple(str(getattr(k, "key", k)) for k in path)): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _num(v):
    return float(v.detach()) if isinstance(v, torch.Tensor) else float(v)


def _close(actual, desired, rtol, atol_frac):
    scale = max(float(np.abs(desired).max()), 1e-30)
    np.testing.assert_allclose(actual, desired, rtol=rtol, atol=atol_frac * scale)


def _assert_same_batch(tbatch, jbatch):
    np.testing.assert_array_equal(tbatch.rgb.numpy(), jbatch.rgb)
    np.testing.assert_array_equal(tbatch.masks.numpy(), jbatch.masks)
    for name in ("origins", "directions", "viewdirs", "radii", "lights", "near", "far",
                 "lossmult", "cam_idx"):
        np.testing.assert_allclose(getattr(tbatch.rays, name).numpy(),
                                   np.float32(getattr(jbatch.rays, name)), rtol=1e-6, atol=1e-7)


def test_batches_are_identical():
    jcfg, tcfg, _, _, _, jbatch, tbatch = build()
    _assert_same_batch(tbatch, jbatch)
    jdata = jdatasets.SyntheticSpheres("train", None, jcfg, num_images=3, resolution=16)
    tdata = tdatasets.SyntheticSpheres("train", None, tcfg, num_images=3,
                                       resolution=16, device="cpu")
    _assert_same_batch(tdata.generate_ray_batch(2), jdata.generate_ray_batch(2))


def test_dataset_serves_on_the_card_unless_told_otherwise():
    # The card is the default device of the port's datasets; without one they
    # raise rather than serve CPU batches. device="cpu" serves the JAX batches
    # (test_batches_are_identical).
    tcfg = flagship.cache_config(batch_size=BATCH)
    if torch.cuda.is_available():
        data = tdatasets.SyntheticSpheres("train", None, tcfg, num_images=3, resolution=16)
        assert data.next_train().rays.origins.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdatasets.SyntheticSpheres("train", None, tcfg, num_images=3, resolution=16)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdatasets.SyntheticSpheres("train", None, tcfg, num_images=3, resolution=16,
                                       device="cuda:0")


@pytest.mark.parametrize("max_val,max_norm", [(1e-3, 0.0), (0.0, 1e-2), (1e-3, 1e-2)])
def test_gradient_clipping_matches_jax(max_val, max_norm):
    jcfg, tcfg, _, tmodel, variables, _, _ = build()
    jcfg.grad_max_val = tcfg.grad_max_val = max_val
    jcfg.grad_max_norm = tcfg.grad_max_norm = max_norm
    rng = np.random.RandomState(3)
    grads = jax.tree_util.tree_map(lambda v: (rng.randn(*v.shape) * 0.01).astype(np.float32),
                                   variables)
    for key, g in _leaves(grads["params"]).items():
        tparam = dict(tmodel.named_parameters())[key]
        tparam.grad = torch.as_tensor(np.ascontiguousarray(
            g.T if g.ndim == 2 and key.endswith(".weight") else g))
    jclipped = _leaves(jlosses.clip_gradients(grads, jcfg)["params"])
    ttrain.losses_lib.clip_gradients(tmodel, tcfg)
    for key, p in tmodel.named_parameters():
        want = jclipped[key].T if jclipped[key].ndim == 2 and key.endswith(".weight") \
            else jclipped[key]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-5, atol=1e-9, err_msg=key)


def test_loss_gradients_and_adam_step_match_jax():
    jcfg, tcfg, jmodel, tmodel, variables, jbatch, tbatch = build()
    (jtotal, (jloss_terms, jrgb)), jgrad = jax_loss(jmodel, jcfg)(variables, jbatch)

    state, _ = ttrain.create_optimizer(tcfg, tmodel)
    step = ttrain.create_train_step(tmodel, tcfg)
    params_before = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    with torch.no_grad():
        trgb = tmodel(None, tbatch.rays, train_frac=TRAIN_FRAC, train=True)["render"]["rgb"]
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), rtol=1e-5, atol=1e-5)
    state, stats = step(None, state, tbatch, TRAIN_FRAC)

    # Every loss term, by name.
    tloss_terms = stats["losses"]
    assert sorted(tloss_terms) == sorted(jloss_terms)
    for k, v in jloss_terms.items():
        np.testing.assert_allclose(_num(tloss_terms[k]), float(v), rtol=1e-5, atol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(float(stats["loss"]), float(jtotal), rtol=1e-5)

    # Every gradient leaf (nan_to_num'd and clipped as the train steps do).
    jgrad = jlosses.clip_gradients(jax.tree_util.tree_map(jnp.nan_to_num, jgrad), jcfg)
    jg = _leaves(jgrad["params"])
    tparams = dict(tmodel.named_parameters())
    assert sorted(jg) == sorted(tparams)
    for key, g in jg.items():
        g = g.T if g.ndim == 2 and key.endswith(".weight") else g
        _close(tparams[key].grad.numpy(), g, rtol=1e-3, atol_frac=1e-4)

    # Parameters after one Adam step.
    jstate, _ = jtrain.create_optimizer(jcfg, variables)
    jnew = _leaves(jstate.apply_gradients(grads=jgrad).params["params"])
    lr = float(state.lr_fn(0))
    for key, p_new in jnew.items():
        tr = lambda a: a.T if a.ndim == 2 and key.endswith(".weight") else a  # noqa: E731
        p_new, g = tr(p_new), tr(jg[key])
        t_new = tparams[key].detach().numpy()
        before = params_before[key].numpy()
        determined = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(t_new[determined], p_new[determined], rtol=0, atol=1e-6,
                                   err_msg=key)
        assert np.all(np.abs(t_new - before) <= lr * (1 + 1e-5) + 1e-7), key


def test_bf16_trunks_match_at_bf16_tolerance():
    jcfg, tcfg, jmodel, tmodel, variables, jbatch, tbatch = build(bf16=True, seed=1)
    (jtotal, (jloss_terms, jrgb)), _ = jax_loss(jmodel, jcfg)(variables, jbatch)
    state, _ = ttrain.create_optimizer(tcfg, tmodel)
    with torch.no_grad():
        trgb = tmodel(None, tbatch.rays, train_frac=TRAIN_FRAC, train=True)["render"]["rgb"]
    # One bf16 ulp in a proposal density can move a ray's samples, so the
    # bound is on the distribution of errors: mean below 5e-3 and 95% of
    # entries within 2e-2.
    err = np.abs(trgb.numpy() - np.asarray(jrgb))
    assert err.mean() < 5e-3 and np.quantile(err, 0.95) < 2e-2, (err.mean(), err.max())
    _, stats = ttrain.create_train_step(tmodel, tcfg)(None, state, tbatch, TRAIN_FRAC)
    for k, v in jloss_terms.items():
        np.testing.assert_allclose(_num(stats["losses"][k]), float(v), rtol=5e-2, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("rng_seed", [None, 7])
def test_port_trains_a_few_steps(rng_seed):
    _, tcfg, _, tmodel, _, _, _ = build()
    data = tdatasets.SyntheticSpheres("train", None, tcfg, num_images=3,
                                      resolution=16, device="cpu")
    state, _ = ttrain.create_optimizer(tcfg, tmodel)
    step = ttrain.create_train_step(tmodel, tcfg)
    rng = None if rng_seed is None else torch.Generator().manual_seed(rng_seed)
    before = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    losses = []
    for _ in range(3):
        state, stats = step(rng, state, data.next_train(), TRAIN_FRAC)
        losses.append(float(stats["loss"]))
    assert state.step == 3 and np.all(np.isfinite(losses))
    unchanged = {k for k, v in tmodel.state_dict().items() if torch.equal(v, before[k])}
    # The passive shader reads neither the light power nor the SLF's rgba
    # head (only its ambient head): their gradients are zero, as in JAX.
    assert unchanged == {"shader.light_power", "shader.surface_lf.output_rgba_layer.weight",
                         "shader.surface_lf.output_rgba_layer.bias"}
