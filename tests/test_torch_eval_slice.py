"""The eval path end to end: narrow cache, material and transient cache
models with the flagship structures, built in both packages with the same
numpy-seeded weights (bridged by ``utils/weights.state_dict_from_jax``),
rendered whole by ``create_render_fn`` + ``render_image`` with
``train=False`` and every extra, and fed the same random numbers.

The render sampling strategies differ from the train ones (and the material
shader renders 4 secondary rays where it trains with 8), so the eval
branches of both packages are the ones compared. The eval sampler jitters,
so every uniform, normal and categorical draw of both packages comes from
one numpy stream in the order both take them. The JAX render function is
jitted and called once per chunk and repeat: its draws are ordered host
callbacks (on a one-device mesh, where ordered effects are allowed), so
each call draws anew, as the port's does. The ray count is one the chunk
divides (2 chunks), so JAX pads nothing and both packages draw the same
numbers; the ragged last chunk is held with a synthetic render function in
``tests/test_torch_renderer.py``.

Tolerances (float32): the cache and transient outputs to rtol 1e-4 with an
atol of 1e-4 x the output's largest entry (the proposal resampling and the
density MLP round differently in the two frameworks, ~5e-5 relative on the
worst ray, see ``test_torch_transient_slice.py``); the material outputs to
1e-3 / 1e-3 x the largest entry, since they average secondary rays whose
directions a 1e-5 difference in a predicted normal turns near grazing
angles (see ``test_torch_material_slice.py``). A wrong term is off by O(1).
"""

import contextlib
import dataclasses
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback

import bench
import test_torch_cache_slice as cache_slice
import test_torch_material_slice as material_slice
import test_torch_transient_slice as transient_slice
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import renderer as jrenderer
from neural_radiance_caching_tpu.models.nerf_model import NeRFModel as JNeRFModel
from neural_radiance_caching_tpu.models.nerf_model import TransientNeRFModel as JTransientModel
from neural_radiance_caching_tpu.parallel import mesh as jmesh
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch import flagship
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.engine import renderer as trenderer
from neural_radiance_caching_tpu_torch.engine import trainer as ttrainer
from neural_radiance_caching_tpu_torch.ops import image as timage
from neural_radiance_caching_tpu_torch.ops import scatter_cuda
from neural_radiance_caching_tpu_torch.parallel import train as ttrain
from neural_radiance_caching_tpu_torch.utils import torchutil, weights
from test_torch_material_slice import jax_encoder_switch_restored  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("jax_encoder_switch_restored")

RES = 8  # 64 rays: two chunks of 32
CHUNK = 32
REPEATS = 2
RENDER_STRATEGY = ((0, 0, 6), (1, 1, 6), (2, 2, 4))
TIGHT = 1e-4
LOOSE = 1e-3


# --- shared random numbers ------------------------------------------------------


@contextlib.contextmanager
def injected(seed):
    """Both packages draw from one numpy stream (material_slice.Draws); the
    JAX draws are ordered host callbacks, so a jitted function called again
    draws anew instead of replaying the numbers it was traced with."""
    jd, td = material_slice.Draws(seed), material_slice.Draws(seed)

    def draw(fn, shape):
        shape = tuple(shape)
        return io_callback(lambda: fn(shape), jax.ShapeDtypeStruct(shape, jnp.float32),
                           ordered=True)

    def j_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if sys._getframe(1).f_code.co_filename.endswith(os.path.join("models", "grids.py")):
            # Flax re-traces a parameter's initializer when the model is
            # applied; that is no draw of the model's.
            return jnp.zeros(shape, dtype)
        return draw(jd.uniform, shape) * (maxval - minval) + minval

    def j_normal(key, shape=(), dtype=jnp.float32):
        return draw(jd.normal, shape)

    def j_categorical(key, logits, axis=-1, shape=None):
        lg = jnp.moveaxis(logits, axis, -1)
        shape = lg.shape[:-1] if shape is None else tuple(shape)
        u = draw(jd.uniform, shape + (lg.shape[-1],))
        return jnp.argmax(lg - jnp.log(-jnp.log(u)), axis=-1)

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


def _render_strategy(params):
    return dict(params, render_sampling_strategy=RENDER_STRATEGY)


def _bridge(jmodel, tmodel, seed):
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))
    variables = material_slice.random_variables(shapes, seed)
    tmodel.load_state_dict(weights.state_dict_from_jax(variables, tmodel))
    return variables


def build(kind, seed=0):
    """(jcfg, tcfg, jmodel, tmodel, variables) of a narrow `kind` model with
    bridged weights and the eval chunk size."""
    chunk = dict(render_chunk_size=CHUNK)
    if kind == "cache":
        jcfg = dataclasses.replace(bench._cache_config(), **chunk)
        tcfg = flagship.cache_config(**chunk)
        jmodel = JNeRFModel(config=jcfg, **_render_strategy(
            cache_slice.narrow(bench.flagship_cache_params(jcfg))))
        tmodel = flagship.build_flagship_cache_model(tcfg, _render_strategy(
            cache_slice.narrow(flagship.flagship_cache_params())), device="cpu")
    elif kind == "transient":
        jcfg = dataclasses.replace(bench._cache_config(), **transient_slice.TRANSIENT, **chunk)
        tcfg = flagship.transient_config(n_bins=transient_slice.N_BINS,
                                         exposure_time=transient_slice.EXPOSURE, **chunk)
        jmodel = JTransientModel(config=jcfg,
                                 **_render_strategy(transient_slice.jax_params(jcfg)))
        tmodel = flagship.build_flagship_transient_cache_model(tcfg, _render_strategy(
            transient_slice.narrow(flagship.flagship_transient_cache_params())), device="cpu")
    else:
        jcfg = dataclasses.replace(bench._cache_config(), secondary_far=4.0,
                                   material_loss_radius=4.0, **chunk)
        tcfg = flagship.material_config(**chunk)

        def narrow(cache, light, shader):
            p = material_slice.narrow_material(cache, light, shader)
            p["cache_model_params"] = _render_strategy(p["cache_model_params"])
            p["shader_params"] = dict(p["shader_params"], render_num_secondary_samples=4,
                                      cache_render_sampling_strategy=RENDER_STRATEGY)
            return p

        jfull = bench.build_flagship_material_model(jcfg)
        jmodel = jfull.clone(**narrow(jfull.cache_model_params, jfull.light_sampler_params,
                                      jfull.shader_params))
        tparams = flagship.flagship_material_params()
        tparams.update(narrow(tparams["cache_model_params"], tparams["light_sampler_params"],
                              tparams["shader_params"]))
        tmodel = flagship.build_flagship_material_model(tcfg, tparams, device="cpu")
    return jcfg, tcfg, jmodel, tmodel, _bridge(jmodel, tmodel, seed)


def _port_view(tcfg):
    return tdatasets.SyntheticSpheres("test", None, tcfg, num_images=2, resolution=RES,
                                      device="cpu").generate_ray_batch(0)


@contextlib.contextmanager
def counting_scatters(calls):
    """Every table-gradient scatter call (kernel or plain) appended to `calls`."""
    with pytest.MonkeyPatch.context() as mp:
        material_slice._counting_scatters(mp, calls)
        yield


# --- tests ------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["cache", "material", "transient"])
def test_eval_render_matches_jax(kind):
    jcfg, tcfg, jmodel, tmodel, variables = build(kind)
    jview = jdatasets.SyntheticSpheres("test", None, jcfg, num_images=2,
                                       resolution=RES).generate_ray_batch(0)
    tview = _port_view(tcfg)
    assert jview.rays.origins.shape[0] == 2 * CHUNK
    kw = dict(height=RES, width=RES, render_repeats=REPEATS)
    calls = []
    with injected(3):
        one_device = jmesh.create_mesh(jax.devices()[:1])
        want = jrenderer.render_image(jtrain.create_render_fn(jmodel, mesh=one_device), variables,
                                      jview.rays, jax.random.PRNGKey(0), jcfg, **kw)
        with counting_scatters(calls):
            got = trenderer.render_image(ttrain.create_render_fn(tmodel), tview.rays,
                                         torch.Generator().manual_seed(0), tcfg, device="cpu",
                                         **kw)
    # Every output both emit, extras and the rgb variance over the repeats.
    assert sorted(got) == sorted(want)
    for key in ("rgb", "acc", "distance_median", "distance_mean", "rgb_variance",
                "normals_to_use"):
        assert key in got, key
    frac = LOOSE if kind == "material" else TIGHT
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=frac,
                                   atol=frac * max(float(np.abs(w).max()), 1e-30), err_msg=key)
    assert float(got["rgb_variance"].max()) > 0  # the two repeats drew different jitter
    assert calls == []  # no backward: the eval render launches no table-gradient scatter


def test_render_fn_builds_no_graph_and_scatters_nothing():
    _, tcfg, _, tmodel, _ = build("cache")
    tview = _port_view(tcfg)
    launches = dict(scatter_cuda.launches)
    calls = []
    with counting_scatters(calls):
        for compute_extras in (True, False):
            out = ttrain.create_render_fn(tmodel, compute_extras=compute_extras)(
                torch.Generator().manual_seed(1), 1.0, tview.rays)
            tensors = [v for v in out.values() if isinstance(v, torch.Tensor)]
            assert tensors and not any(v.requires_grad for v in tensors)
    assert calls == [] and scatter_cuda.launches == launches
    # The train step, by contrast, scatters its table gradient.
    state, _ = ttrain.create_optimizer(tcfg, tmodel)
    batch = tdatasets.SyntheticSpheres("train", None, dataclasses.replace(tcfg, batch_size=32),
                                       num_images=2, resolution=8, device="cpu").next_train()
    with counting_scatters(calls):
        ttrain.create_train_step(tmodel, tcfg)(None, state, batch, 0.5)
    assert calls == ["leveled"]


def test_trained_psnr_matches_bench():
    jcfg, tcfg, jmodel, tmodel, variables = build("cache")
    res = 16
    # One chunk of the view's own size: JAX pads nothing, and its jitted
    # render function is traced once, so its draws (taken at trace time) are
    # the stream's first, as the port's are.
    jcfg = dataclasses.replace(jcfg, render_chunk_size=res * res)
    tcfg = dataclasses.replace(tcfg, render_chunk_size=res * res)
    with material_slice.injected(5):
        want = bench.trained_psnr(jmodel, jcfg, types.SimpleNamespace(params=variables),
                                  resolution=res)
        got = flagship.trained_psnr(tmodel, tcfg, resolution=res, device="cpu")
    # Both round to 2 places; values ~1e-5 dB apart may round one step apart.
    assert abs(got - want) <= 0.01 + 1e-9, (got, want)
    assert 0 < got < 60


def test_trained_psnr_gate_schedule_and_batches(monkeypatch):
    """The gate's config, step count, train fractions and batch cycling; its
    reading is ``trained_psnr`` of the trained model."""
    _, tcfg, _, tmodel, _ = build("cache")
    tcfg = dataclasses.replace(tcfg, batch_size=32, render_chunk_size=256)
    dataset = tdatasets.SyntheticSpheres("train", None, tcfg, num_images=2, resolution=8,
                                         device="cpu")
    drawn, seen = [], {}
    real_next, real_step = dataset.next_train, ttrain.create_train_step

    def next_train():
        drawn.append(real_next())
        return drawn[-1]

    def create_train_step(model, config):
        seen["config"] = config
        step = real_step(model, config)

        def wrapped(rng, state, batch, train_frac):
            index = next(i for i, b in enumerate(drawn) if b is batch)
            seen.setdefault("calls", []).append((index, train_frac))
            return step(rng, state, batch, train_frac)

        return wrapped

    monkeypatch.setattr(dataset, "next_train", next_train)
    monkeypatch.setattr(ttrain, "create_train_step", create_train_step)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    steps = 18
    db = flagship.trained_psnr_gate(tmodel, tcfg, dataset, steps=steps, resolution=16)
    cfg = seen["config"]
    assert (cfg.lr_init, cfg.lr_final, cfg.lr_delay_steps, cfg.max_steps) == (0.01, 0.003, 50,
                                                                              steps)
    assert cfg.lr_delay_mult == tcfg.lr_delay_mult == 1e-8
    assert len(drawn) == 16
    assert seen["calls"] == [(i % 16, i / (steps - 1)) for i in range(steps)]
    assert any(not torch.equal(v, before[k]) for k, v in tmodel.state_dict().items())
    assert db == flagship.trained_psnr(tmodel, cfg, resolution=16, device="cpu")


def test_bench_eval_render_and_test_view_metrics():
    _, tcfg, _, tmodel, _ = build("cache")
    tcfg = dataclasses.replace(tcfg, render_chunk_size=48)  # 64 rays: a ragged second chunk
    dataset = tdatasets.SyntheticSpheres("test", None, tcfg, num_images=2, resolution=RES,
                                         device="cpu")
    dt, detail = flagship.bench_eval_render(tmodel, tcfg, dataset, n_images=2)
    assert detail["rays_per_image"] == RES * RES and detail["render_chunk_size"] == 48
    assert len(detail["image_secs"]) == len(detail["rgb_only_image_secs"]) == 2
    assert dt == pytest.approx(np.mean(detail["image_secs"]))
    assert detail["rays_per_sec"] == pytest.approx(RES * RES / dt)
    assert detail["rgb_only_rays_per_sec"] > 0 and np.isfinite(detail["untrained_psnr"])

    rendering, batch = ttrainer.render_test_view(ttrain.create_render_fn(tmodel), dataset, 1,
                                                 torch.Generator().manual_seed(2), tcfg)
    assert rendering["rgb"].shape == (RES, RES, 3) and "rgb_variance" not in rendering
    metrics = ttrainer.compute_eval_metrics(
        rendering, batch, RES, RES, tcfg, timage.MetricHarness(disable_lpips=True),
        lambda x: np.clip(x, 0, 1))
    # SyntheticSpheres serves no depth, normals or albedo: PSNR and SSIM only.
    assert sorted(metrics) == ["psnr", "ssim"]
    gt = batch.rgb.numpy().reshape(RES, RES, 3)
    mse = np.mean((np.clip(rendering["rgb"], 0, 1) - np.clip(gt, 0, 1)) ** 2)
    np.testing.assert_allclose(metrics["psnr"], -10 * np.log10(mse), rtol=1e-5)


def test_eval_entry_points_raise_on_the_cpu_unless_asked():
    _, tcfg, _, tmodel, _ = build("cache")
    tview = _port_view(tcfg)
    render_fn = ttrain.create_render_fn(tmodel)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="rays lie on cpu"):
            trenderer.render_image(render_fn, tview.rays, None, tcfg)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trenderer.render_image(render_fn, tview.rays, None, tcfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            flagship.trained_psnr(tmodel, tcfg, resolution=RES)
