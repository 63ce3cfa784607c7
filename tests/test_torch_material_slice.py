"""The material-stage slice end to end: a narrow material model with the
flagship's structure (the cache with secondary-ray resampling and level
clamps, the vMF LightMLP, the MaterialMLP with the flagship BRDF head and
fused specular + diffuse secondary rays) built in both packages with the same
numpy-seeded weights and fed the same random numbers: every uniform, normal
and categorical draw of both packages comes from one numpy stream, in the
order both take them (JAX's `jax.random` functions and the port's
`torchutil` draw functions are replaced for the test).

Compared: the secondary-ray machinery at the unit level (frames, samplers,
MIS weights, the fan-out, the lobe, the estimators, the vMF mixture), the
LightMLP forward, and the whole train step against the JAX package's loss
assembly with the gradient-debias pass: rendered rgb, material outputs, each
loss term of `main` and `cache_main`, every gradient leaf, the parameters
after one Adam step, and the set of parameters no loss reaches.

Tolerances (float32): unit-level values agree to 1e-5 relative (1e-6
absolute), the same ops in the same order; vMF draws to 1e-4 relative,
through their exp/log/sqrt chain, and LightMLP outputs to 1e-5 absolute, its
lobe means being ~20x its unit-scale head. The model forward is a chain of
~100 ops through two sampler hierarchies, so rendered values agree to 1e-4
(rtol) / 1e-5 (atol). Per-secondary-ray statistics (irradiance, the
indirect occlusion) are held to 1e-3 / 1e-4: a 1e-5 difference in a
predicted normal turns a GGX direction by ~4e-5 near grazing angles, which
moves that ray's samples along its 4-unit length. Gradients are sums in
another order whose terms cancel
(scatter sums of table updates, bias gradients over every secondary sample):
rtol 2e-3 with an atol of 2e-4 x the leaf's largest entry, a wrong term
being off by O(1). The Adam step moves a parameter by exactly +-lr where the
gradient's sign is determined (|g| above 1e-3 of the leaf's largest entry),
held to 1e-6; elsewhere the step is only required to be at most lr.
"""

import contextlib
import copy
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.models import light_sampler as jlight
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.ops import render_utils as jru
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch import flagship
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.models import light_sampler as tlight
from neural_radiance_caching_tpu_torch.ops import hashgrid as thash
from neural_radiance_caching_tpu_torch.ops import render_utils as tru
from neural_radiance_caching_tpu_torch.ops import scatter_cuda
from neural_radiance_caching_tpu_torch.parallel import losses as tlosses
from neural_radiance_caching_tpu_torch.parallel import train as ttrain
from neural_radiance_caching_tpu_torch.utils import torchutil, weights

# The suite runs as several xdist workers on one host's cores. At torch's
# default of one intra-op thread per core every worker's torch ops contend
# with the others' for all the cores, and a whole run takes about 1.6x as
# long. The test processes run torch on one thread: a whole run imports
# every test module before its first test, so this holds for all of them.
torch.set_num_threads(1)

TRAIN_FRAC = 0.5
BATCH = 8
STRATEGY = ((0, 0, 8), (1, 1, 8), (2, 2, 8))
FWD = dict(rtol=1e-4, atol=1e-5)
SEC = dict(rtol=1e-3, atol=1e-4)
UNIT = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_encoder_switch_restored():
    """The JAX package's encoder switch as the module found it, once the
    module is done: JAX's mesh on the CPU (`parallel/mesh.create_mesh`,
    which a JAX trainer or render function builds) turns the switch to the
    XLA encoder for the whole process, and a JAX test later in the same
    worker reads it (`tests/test_hashgrid.py::test_pallas_fault_shape_guard`)."""
    saved = jhash._FORCE_XLA_ENCODER
    yield
    jhash._FORCE_XLA_ENCODER = saved


# --- shared random numbers ------------------------------------------------------


class Draws:
    """One numpy stream feeding both packages' random draws."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)

    def uniform(self, shape):
        return self.rng.random_sample(tuple(shape)).astype(np.float32)

    def normal(self, shape):
        return self.rng.standard_normal(tuple(shape)).astype(np.float32)


@contextlib.contextmanager
def injected(seed):
    """Both packages draw from Draws(seed): jax.random's uniform/normal/
    categorical and the port's torchutil.uniform/normal (categorical is
    Gumbel-max over uniform noise [..., num, K] in both)."""
    jd, td = Draws(seed), Draws(seed)

    def j_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if sys._getframe(1).f_code.co_filename.endswith(os.path.join("models", "grids.py")):
            # Flax re-traces a parameter's initializer to check its shape
            # when the model is applied; that is no draw of the model's.
            return jnp.zeros(shape, dtype)
        return jnp.asarray(jd.uniform(shape) * (maxval - minval) + minval)

    def j_normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(jd.normal(shape))

    def j_categorical(key, logits, axis=-1, shape=None):
        lg = jnp.moveaxis(logits, axis, -1)
        shape = lg.shape[:-1] if shape is None else tuple(shape)
        u = jd.uniform(shape + (lg.shape[-1],))
        return jnp.argmax(lg + jnp.asarray(-np.log(-np.log(u))), axis=-1)

    def t_uniform(rng, shape, device, dtype=torch.float32):
        return torch.as_tensor(td.uniform(shape), device=device).to(dtype)

    def t_normal(rng, shape, device, dtype=torch.float32):
        return torch.as_tensor(td.normal(shape), device=device).to(dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", j_uniform)
        mp.setattr(jax.random, "normal", j_normal)
        mp.setattr(jax.random, "categorical", j_categorical)
        mp.setattr(torchutil, "uniform", t_uniform)
        mp.setattr(torchutil, "normal", t_normal)
        yield


# --- models -----------------------------------------------------------------------


def narrow_cache(params):
    """The flagship cache structure at test widths (same edits in both packages)."""
    p = copy.deepcopy(params)
    sp = p["sampler_params"]
    mlps = [dict(m) for m in sp["mlp_params_per_level"]]
    for m in mlps[:2]:
        m.update(net_width=16, net_depth=2, use_bf16_compute=False)
    mlps[2].update(net_width=16, primary_grid_level_clamp=4, secondary_grid_level_clamp=3)
    sp["mlp_params_per_level"] = tuple(mlps)
    sp["grid_params_per_level"] = (None, None, dict(sp["grid_params_per_level"][2],
                                                    hash_map_size=4096, max_grid_size=128))
    sp["sampling_strategy"] = STRATEGY
    p["train_sampling_strategy"] = p["render_sampling_strategy"] = STRATEGY
    sh = p["shader_params"]
    sh.update(net_width=16, bottleneck_width=16, net_width_integrated_brdf=8,
              use_bf16_compute=False)
    sh["surface_lf_params"] = dict(sh["surface_lf_params"], net_width_viewdirs=16,
                                   bottleneck_viewdirs=16)
    return p


def narrow_material(cache_model_params, light_sampler_params, shader_params):
    """The flagship material structure at test widths: 8 secondary rays per
    surface point (4 GGX+cosine, 4 cosine), 8 vMF components, 4-level grids."""
    grid = dict(hash_map_size=4096, max_grid_size=128)
    ls = dict(light_sampler_params, net_width=16, num_components=8,
              grid_params=dict(light_sampler_params["grid_params"], **grid))
    sh = dict(shader_params, bottleneck_width=16, num_secondary_samples=8,
              render_num_secondary_samples=8, cache_train_sampling_strategy=STRATEGY,
              cache_render_sampling_strategy=STRATEGY,
              grid_params=dict(shader_params["grid_params"], **grid))
    return dict(cache_model_params=narrow_cache(cache_model_params), light_sampler_params=ls,
                shader_params=sh)


def random_variables(shapes, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda s: rng.uniform(-0.5, 0.5, s.shape).astype(np.float32),
                                  shapes)


def build(seed=0, **cfg_overrides):
    jcfg = dataclasses.replace(
        bench._cache_config(), batch_size=BATCH, lr_delay_steps=0, secondary_far=4.0,
        material_loss_radius=4.0, data_loss_type="rawnerf_unbiased", use_gradient_debias=True,
        gradient_checkpointing=False, distortion_loss_mult=0.0,
        predicted_normal_loss_mult=0.0, predicted_normal_reverse_loss_mult=0.0)
    tcfg = flagship.material_config(batch_size=BATCH, lr_delay_steps=0, **cfg_overrides)
    jfull = bench.build_flagship_material_model(jcfg)
    jmodel = jfull.clone(**narrow_material(
        jfull.cache_model_params, jfull.light_sampler_params, jfull.shader_params))
    tparams = flagship.flagship_material_params()
    tparams.update(narrow_material(tparams["cache_model_params"],
                                   tparams["light_sampler_params"], tparams["shader_params"]))
    tmodel = flagship.build_flagship_material_model(tcfg, tparams, device="cpu")
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))
    variables = random_variables(shapes, seed)
    tmodel.load_state_dict(weights.state_dict_from_jax(variables, tmodel))
    jdata = jdatasets.SyntheticSpheres("train", None, jcfg, num_images=3, resolution=16)
    tdata = tdatasets.SyntheticSpheres("train", None, tcfg, num_images=3,
                                       resolution=16, device="cpu")
    return jcfg, tcfg, jmodel, tmodel, variables, jdata.next_train(), tdata.next_train()


def jax_loss(jmodel, jcfg):
    """The JAX train step's loss: forward, the gradient-debias forward over
    the same cache samples, and the loss assembly over every *main output."""

    def loss_fn(variables, batch):
        rng = jax.random.PRNGKey(0)
        kw = dict(train_frac=TRAIN_FRAC, train=True, compute_extras=False)
        results = jmodel.apply(variables, rng, batch.rays, **kw)
        nocorr = jmodel.apply(
            variables, jax.random.fold_in(rng, 0x5EED), batch.rays,
            cache_outputs={"sampler": results["cache_main"]["sampler"]},
            filtered_sampler_inds=results["cache_main"]["filtered_sampler_inds"], **kw)
        results["render"]["rgb_nocorr"] = nocorr["render"]["rgb"]
        losses, stats = {}, {}
        for key in sorted(k for k in results if k.endswith("main")):
            jtrain._compute_losses_for_output(None, batch, batch.rays, results, jcfg, TRAIN_FRAC,
                                              key, losses, stats)
        shader = results["main"]["shader"]
        out = dict(rgb=results["render"]["rgb"], rgb_nocorr=nocorr["render"]["rgb"],
                   cache_rgb=results["render"]["cache_rgb"],
                   **{k: shader[k] for k in ("material_albedo", "material_roughness",
                                            "material_metalness", "lighting_irradiance",
                                            "indirect_occ")})
        return sum(jax.tree_util.tree_leaves(losses)), (losses, out)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _leaves(tree):
    return {weights.torch_key(tuple(str(getattr(k, "key", k)) for k in path)): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tr(key, a):
    return a.T if a.ndim == 2 and key.endswith(".weight") else a


def _close(actual, desired, rtol, atol_frac, err_msg=""):
    scale = max(float(np.abs(desired).max()), 1e-30)
    np.testing.assert_allclose(actual, desired, rtol=rtol, atol=atol_frac * scale,
                               err_msg=err_msg)


# No loss reads these: the light sampler's outputs feed only the (unused on
# this path) light importance sampler, under a stop-gradient; the passive
# shaders read no light power; the cache SLF's rgba head is unread.
UNREACHED = {
    "cache.shader.light_power", "cache.shader.surface_lf.output_rgba_layer.weight",
    "cache.shader.surface_lf.output_rgba_layer.bias", "shader.light_power",
    "light_sampler.layers.0.weight", "light_sampler.layers.0.bias",
    "light_sampler.layers.1.weight", "light_sampler.layers.1.bias",
    "light_sampler.output_layer.weight", "light_sampler.output_layer.bias",
    "light_sampler.grid.dense_levels", "light_sampler.grid.hash_levels",
}


def _counting_scatters(mp, calls):
    for kind in ("leveled", "planes"):
        fn = getattr(scatter_cuda, f"scatter_add_weighted_{kind}")

        def wrapped(*args, _fn=fn, _kind=kind, **kwargs):
            calls.append(_kind)
            return _fn(*args, **kwargs)

        mp.setattr(scatter_cuda, f"scatter_add_weighted_{kind}", wrapped)


def run_port_step(tmodel, tcfg, tbatch, draws_seed):
    """One port train step with injected draws; the secondary-ray encoder
    (512 points here) takes the planes layout, the rest the leveled one."""
    calls = []
    state, _ = ttrain.create_optimizer(tcfg, tmodel)
    step = ttrain.create_train_step(tmodel, tcfg)
    with injected(draws_seed), pytest.MonkeyPatch.context() as mp:
        mp.setattr(thash, "PLANES_MIN_POINTS", 256)
        _counting_scatters(mp, calls)
        state, stats = step(torch.Generator().manual_seed(1), state, tbatch, TRAIN_FRAC)
    return state, stats, calls


@pytest.fixture(scope="module")
def parity():
    jcfg, tcfg, jmodel, tmodel, variables, jbatch, tbatch = build()
    with injected(11), jhash.xla_encoder_scope():
        (jtotal, (jloss_terms, jout)), jgrad = jax_loss(jmodel, jcfg)(variables, jbatch)
    params_before = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    with injected(11), torch.no_grad():
        tout = tmodel(torch.Generator(), tbatch.rays, train_frac=TRAIN_FRAC, train=True)
    state, stats, calls = run_port_step(tmodel, tcfg, tbatch, 11)
    return dict(jcfg=jcfg, jmodel=jmodel, tmodel=tmodel, variables=variables, jtotal=jtotal,
                jloss_terms=jloss_terms, jout=jout, jgrad=jgrad, tout=tout, state=state,
                stats=stats, calls=calls, params_before=params_before)


# --- the train step ------------------------------------------------------------------


def test_forward_matches_jax(parity):
    jout, tout = parity["jout"], parity["tout"]
    np.testing.assert_allclose(tout["render"]["rgb"].numpy(), np.asarray(jout["rgb"]), **FWD)
    np.testing.assert_allclose(tout["render"]["cache_rgb"].numpy(), np.asarray(jout["cache_rgb"]),
                               **FWD)
    shader = tout["main"]["shader"]
    for k in ("material_albedo", "material_roughness", "material_metalness"):
        np.testing.assert_allclose(shader[k].numpy(), np.asarray(jout[k]), err_msg=k, **FWD)
    for k in ("lighting_irradiance", "indirect_occ"):
        np.testing.assert_allclose(shader[k].numpy(), np.asarray(jout[k]), err_msg=k, **SEC)


def test_loss_terms_match_jax(parity):
    tloss_terms = parity["stats"]["losses"]
    assert sorted(tloss_terms) == sorted(parity["jloss_terms"]) == [
        "cache_data", "cache_interlevel_0", "cache_interlevel_1", "data"]
    for k, v in parity["jloss_terms"].items():
        np.testing.assert_allclose(float(tloss_terms[k].detach()), float(v), rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(float(parity["stats"]["loss"]), float(parity["jtotal"]), rtol=1e-4)


def test_gradients_and_adam_step_match_jax(parity):
    jcfg, tmodel = parity["jcfg"], parity["tmodel"]
    jgrad = jlosses.clip_gradients(jax.tree_util.tree_map(jnp.nan_to_num, parity["jgrad"]), jcfg)
    jg = _leaves(jgrad["params"])
    tparams = dict(tmodel.named_parameters())
    assert sorted(jg) == sorted(tparams)
    for key, g in jg.items():
        _close(tparams[key].grad.numpy(), _tr(key, g), rtol=2e-3, atol_frac=2e-4, err_msg=key)

    jstate, _ = jtrain.create_optimizer(jcfg, parity["variables"])
    jnew = _leaves(jstate.apply_gradients(grads=jgrad).params["params"])
    lr = float(parity["state"].lr_fn(0))
    for key, p_new in jnew.items():
        p_new, g = _tr(key, p_new), _tr(key, jg[key])
        t_new = tparams[key].detach().numpy()
        before = parity["params_before"][key].numpy()
        determined = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(t_new[determined], p_new[determined], rtol=0, atol=1e-6,
                                   err_msg=key)
        assert np.all(np.abs(t_new - before) <= lr * (1 + 1e-5) + 1e-7), key


def test_unreached_parameters_and_scatter_layouts(parity):
    jg = _leaves(parity["jgrad"]["params"])
    assert {k for k, g in jg.items() if not np.any(g)} == UNREACHED
    unchanged = {k for k, v in parity["tmodel"].state_dict().items()
                 if torch.equal(v, parity["params_before"][k])}
    assert unchanged == UNREACHED
    # One backward per encoder a loss reaches: the cache's primary samples
    # and the material grid (leveled), the secondary samples (planes). The
    # light sampler's grid gets no gradient and the debias pass no graph.
    assert sorted(parity["calls"]) == ["leveled", "leveled", "planes"]


@pytest.mark.parametrize("draws_seed", [5, 6])
def test_checkpointing_gives_the_same_gradients(draws_seed):
    # Recomputed activations take no random draws, so checkpointing the
    # density MLPs changes no gradient bit.
    grads = {}
    for ckpt in (False, True):
        _, tcfg, _, tmodel, _, _, tbatch = build(seed=2, gradient_checkpointing=ckpt)
        run_port_step(tmodel, tcfg, tbatch, draws_seed)
        grads[ckpt] = {k: p.grad.clone() for k, p in tmodel.named_parameters()}
    for k in grads[False]:
        torch.testing.assert_close(grads[True][k], grads[False][k], rtol=0, atol=0, msg=k)


def test_debias_pass_keeps_no_graph(parity):
    # With no extra loss configured nothing differentiates the second
    # forward: its rgb carries no graph.
    assert parity["stats"]["loss"].requires_grad is False
    _, tcfg, _, tmodel, _, _, tbatch = build(seed=4)
    seen = {}
    real = ttrain._debias_forward

    def spy(model, rng, rays, train_frac, model_results):
        real(model, rng, rays, train_frac, model_results)
        seen["nocorr"] = model_results["render"]["rgb_nocorr"]
        seen["rgb"] = model_results["render"]["rgb"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "_debias_forward", spy)
        run_port_step(tmodel, tcfg, tbatch, 8)
    assert seen["rgb"].requires_grad and not seen["nocorr"].requires_grad


def test_port_trains_a_few_steps_on_real_draws():
    _, tcfg, _, tmodel, _, _, _ = build(seed=3)
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
    unchanged = {k for k, v in tmodel.state_dict().items() if torch.equal(v, before[k])}
    assert unchanged == UNREACHED


# --- unit level ----------------------------------------------------------------------------


def _unit_inputs(seed, n=6, s=4):
    rng = np.random.RandomState(seed)
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    viewdirs = rng.randn(n, 3).astype(np.float32)
    viewdirs /= np.linalg.norm(viewdirs, axis=-1, keepdims=True)
    material = {
        "albedo": rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
        "roughness": rng.uniform(0.05, 0.9, (n, 1)).astype(np.float32),
        "F_0": np.full((n, 1), 0.04, np.float32),
        "metalness": rng.uniform(0, 1, (n, 1)).astype(np.float32),
        "specular_albedo": rng.uniform(0, 1, (n, 1)).astype(np.float32),
        "diffuseness": np.zeros((n, 1), np.float32), "mirrorness": np.zeros((n, 1), np.float32),
    }
    return normals, viewdirs, material


SAMPLER_SETS = {
    "specular": ((("microfacet", 1), ("cosine", 1)), 8),
    "diffuse": ((("cosine", 1),), 8),
    "uniform": ((("uniform", 1), ("cosine", 3)), 8),
}


def _samplers(names, lib):
    return [(lib.IMPORTANCE_SAMPLER_BY_NAME[name](), count) for name, count in names]


def test_importance_resampling_raises():
    normals, viewdirs, material = _unit_inputs(1)
    with pytest.raises(NotImplementedError):
        tru.importance_sample_rays(
            torch.Generator(), torch.as_tensor(-viewdirs), torch.as_tensor(normals),
            {k: torch.as_tensor(v) for k, v in material.items()},
            random_generator_2d=tru.RandomGenerator2D(1, 1, False),
            samplers=_samplers(SAMPLER_SETS["specular"][0], tru), num_secondary_samples=1)


@pytest.mark.parametrize("variant", ["use_gt_rawnerf", "use_combined_rawnerf", "use_norm_rawnerf"])
def test_unported_rawnerf_scalings_raise(variant):
    cfg = flagship.material_config(**{variant: True})
    rgb = torch.full((4, 3), 0.5)
    with pytest.raises(NotImplementedError):
        tlosses.compute_unbiased_loss_rawnerf({"rgb": rgb, "rgb_nocorr": rgb}, rgb, cfg)


@pytest.mark.parametrize("which", sorted(SAMPLER_SETS))
def test_importance_sample_rays_matches_jax(which):
    names, n_sec = SAMPLER_SETS[which]
    normals, viewdirs, material = _unit_inputs(1)
    with injected(3):
        want = jru.importance_sample_rays(
            jax.random.PRNGKey(0), jnp.asarray(-viewdirs), jnp.asarray(normals),
            {k: jnp.asarray(v) for k, v in material.items()},
            random_generator_2d=jru.RandomGenerator2D(1, 1, False), samplers=_samplers(names, jru),
            num_secondary_samples=n_sec)
        got = tru.importance_sample_rays(
            torch.Generator(), torch.as_tensor(-viewdirs), torch.as_tensor(normals),
            {k: torch.as_tensor(v) for k, v in material.items()},
            random_generator_2d=tru.RandomGenerator2D(1, 1, False),
            samplers=_samplers(names, tru), num_secondary_samples=n_sec)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **UNIT)


def _unit_rays(n, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    kw = dict(origins=f(n, 3), directions=f(n, 3), viewdirs=f(n, 3), radii=f(n, 1) ** 2,
              lights=f(n, 3), imageplane=f(n, 2), look=f(n, 3), up=f(n, 3), cam_origins=f(n, 3),
              vcam_look=f(n, 3), vcam_up=f(n, 3), vcam_origins=f(n, 3),
              lossmult=np.ones((n, 1), np.float32), near=np.full((n, 1), 2.0, np.float32),
              far=np.full((n, 1), 6.0, np.float32), cam_idx=np.arange(n, dtype=np.int32)[:, None],
              light_idx=np.zeros((n, 1), np.int32))
    from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees

    jrays = jpytrees.Rays(**{k: jnp.asarray(v) for k, v in kw.items()})
    trays = tpytrees.Rays(**{k: torch.as_tensor(v) for k, v in kw.items()})
    return jrays, trays


@pytest.mark.parametrize("far", [None, 4.0])
def test_secondary_rays_match_jax(far):
    normals, viewdirs, material = _unit_inputs(2)
    n = normals.shape[0]
    jrays, trays = _unit_rays(n, 4)
    means = np.random.RandomState(5).randn(n, 1, 3).astype(np.float32)
    names = SAMPLER_SETS["specular"][0]
    kw = dict(normal_eps=1e-2, refdir_eps=0.1, num_secondary_samples=8, far=far)
    with injected(6):
        jr, js = jru.get_secondary_rays(
            jax.random.PRNGKey(0), jrays, jnp.asarray(means), jnp.asarray(viewdirs),
            jnp.asarray(normals[:, None]),
            {k: jnp.asarray(v[:, None]) for k, v in material.items()},
            random_generator_2d=jru.RandomGenerator2D(1, 1, False),
            samplers=_samplers(names, jru), **kw)
        tr, ts = tru.get_secondary_rays(
            torch.Generator(), trays, torch.as_tensor(means), torch.as_tensor(viewdirs),
            torch.as_tensor(normals[:, None]),
            {k: torch.as_tensor(v[:, None]) for k, v in material.items()},
            random_generator_2d=tru.RandomGenerator2D(1, 1, False),
            samplers=_samplers(names, tru), **kw)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), err_msg=k, **UNIT)
    for f in ("origins", "directions", "viewdirs", "radii", "near", "far", "lights", "imageplane",
              "look", "up", "cam_origins", "vcam_look", "vcam_up", "vcam_origins", "lossmult",
              "cam_idx", "light_idx"):
        np.testing.assert_allclose(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)),
                                   err_msg=f, **UNIT)


@pytest.mark.parametrize("shading", ["microfacet", "microfacet_specular", "microfacet_diffuse"])
@pytest.mark.parametrize("metal_flags", [(False, False, False), (True, True, True)])
def test_lobe_and_reflection_estimates_match_jax(shading, metal_flags):
    normals, viewdirs, material = _unit_inputs(7)
    n, s = normals.shape[0], 5
    rng = np.random.RandomState(8)
    lightdirs = rng.randn(n, s, 3).astype(np.float32)
    lightdirs /= np.linalg.norm(lightdirs, axis=-1, keepdims=True)
    samples = {
        "local_lightdirs": lightdirs,
        "local_viewdirs": np.repeat(viewdirs[:, None], s, axis=1),
        "brdf_correction": rng.uniform(0.5, 1.5, (n, s, 2)).astype(np.float32),
        "radiance_in": rng.uniform(0, 2, (n, s, 3)).astype(np.float32),
        "weight": rng.uniform(0, 2, (n, s, 1)).astype(np.float32),
        "pdf": rng.uniform(0, 1, (n, s, 1)).astype(np.float32),
        "indirect_occ": rng.uniform(0, 1, (n, s, 1)).astype(np.float32),
    }
    use_d, use_m, use_s = metal_flags
    for corr in (False, True):
        want = jru.integrate_reflect_rays(
            shading, corr, {k: jnp.asarray(v) for k, v in material.items()},
            {k: jnp.asarray(v) for k, v in samples.items()}, use_diffuseness=use_d,
            use_mirrorness=use_m, use_specular_albedo=use_s, max_radiance=1.5)
        got = tru.integrate_reflect_rays(
            shading, corr, {k: torch.as_tensor(v) for k, v in material.items()},
            {k: torch.as_tensor(v) for k, v in samples.items()}, use_diffuseness=use_d,
            use_mirrorness=use_m, use_specular_albedo=use_s, max_radiance=1.5)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **UNIT)
    np.testing.assert_allclose(
        tru.integrate_irradiance({k: torch.as_tensor(v) for k, v in samples.items()}).numpy(),
        np.asarray(jru.integrate_irradiance({k: jnp.asarray(v) for k, v in samples.items()})),
        **UNIT)


def test_vmf_mixture_matches_jax():
    rng = np.random.RandomState(9)
    n, k, n_dirs = 5, 6, 7
    vmf = {"vmf_means": rng.randn(n, k, 3).astype(np.float32) * 3,
           "vmf_kappas": rng.uniform(0.5, 20, (n, k, 1)).astype(np.float32),
           "vmf_logits": rng.randn(n, k, 1).astype(np.float32)}
    normals, viewdirs, _ = _unit_inputs(10, n=n)
    wo = np.repeat(viewdirs[:, None], n_dirs, axis=1)
    jvmf = {key: jnp.asarray(v) for key, v in vmf.items()}
    tvmf = {key: torch.as_tensor(v) for key, v in vmf.items()}
    with injected(12):
        jdirs, jpdf = jru.LightSampler().sample_directions(
            jax.random.PRNGKey(0), jnp.zeros((n, n_dirs)), None, jnp.asarray(wo), None, None, jvmf)
        tdirs, tpdf = tru.LightSampler().sample_directions(
            torch.Generator(), torch.zeros((n, n_dirs)), None, torch.as_tensor(wo), None, None,
            tvmf)
    np.testing.assert_allclose(tdirs.numpy(), np.asarray(jdirs), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        tru.LightSampler().pdf(None, tdirs, None, tvmf).numpy(),
        np.asarray(jru.LightSampler().pdf(None, jnp.asarray(tdirs.numpy()), None, jvmf)),
        rtol=1e-4, atol=1e-6)
    vars_ = (vmf["vmf_means"], vmf["vmf_kappas"][..., 0], vmf["vmf_logits"][..., 0])
    jf = jru.filter_vmf_vars(tuple(jnp.asarray(v) for v in vars_), jnp.asarray(normals))
    tf = tru.filter_vmf_vars(tuple(torch.as_tensor(v) for v in vars_), torch.as_tensor(normals))
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **UNIT)


def test_light_mlp_forward_matches_jax():
    jcfg = bench._cache_config()
    tcfg = flagship.cache_config()
    grid = dict(hash_map_size=4096, max_grid_size=128, num_features=4, scale_supersample=1.0,
                interpolation="simplex", bbox_scaling=2.0)
    common = dict(net_depth=2, net_width=16, bottleneck_width=128, num_components=8,
                  vmf_scale=20.0, use_density_feature=False, use_grid=True, grid_params=grid)
    from neural_radiance_caching_tpu.ops import coord as jcoord
    from neural_radiance_caching_tpu_torch.ops import coord as tcoord

    jm = jlight.LightMLP(config=jcfg, warp_fn=jcoord.contract_radius_2, **common)
    tm = tlight.LightMLP(config=tcfg, warp_fn=tcoord.contract_radius_2, **common)
    rng = np.random.RandomState(13)
    n = 6
    sr = {"means": rng.randn(n, 1, 3).astype(np.float32),
          "covs": np.tile(np.eye(3, dtype=np.float32) * 1e-3, (n, 1, 1, 1)),
          "tdist": np.tile(np.linspace(2, 6, 9, dtype=np.float32), (n, 1)),
          "normals_to_use": rng.randn(n, 1, 3).astype(np.float32),
          "weights": rng.rand(n, 1).astype(np.float32)}
    jrays, trays = _unit_rays(n, 14)
    jsr = {k: jnp.asarray(v) for k, v in sr.items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), None, jrays, jsr))
    variables = random_variables(shapes, 15)
    tm.load_state_dict(weights.state_dict_from_jax(variables, tm))
    with injected(16):  # the lobe-mean jitter
        want = jm.apply(variables, None, jrays, jsr)
        got = tm(None, trays, {k: torch.as_tensor(v) for k, v in sr.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), err_msg=k,
                                   rtol=1e-5, atol=1e-5)
