"""The port's eval metrics against the JAX package's: ``ops/image``
(``mse_to_psnr``, ``psnr``, ``ssim`` with and without ``return_map``,
``MetricHarness`` without and with LPIPS) and
``engine/trainer.compute_eval_metrics`` against
``Trainer._compute_eval_metrics`` (the shift-invariant PSNR among them),
called unbound on a stub that carries what the method reads from the
trainer.

Inputs are made from a seed with numpy. Tolerances: float32 math in both,
the SSIM blur's sums in another order (a depthwise convolution against
JAX's ``convolve``), so values agree to rtol 1e-5 with an atol of 1e-6,
LPIPS and its avg_err to rtol 1e-4 (float32 convolutions in another
order);
the metrics computed in float64 numpy by both functions (normal MAE, depth
L1, albedo PSNR, transient IoU) to rtol 1e-6.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_radiance_caching_tpu.engine import configs as jconfigs
from neural_radiance_caching_tpu.engine.trainer import Trainer as JTrainer
from neural_radiance_caching_tpu.ops import image as jimage
from neural_radiance_caching_tpu.ops import lpips as jlpips
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch.engine import configs as tconfigs
from neural_radiance_caching_tpu_torch.engine import trainer as ttrainer
from neural_radiance_caching_tpu_torch.ops import image as timage
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees

TOL = dict(rtol=1e-5, atol=1e-6)
LPIPS_TOL = dict(rtol=1e-4, atol=1e-7)


def _images(seed, shape):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(16, 16, 3), (13, 21, 3), (9, 7, 1), (12, 12, 5, 3)])
def test_psnr_and_ssim_match_jax(shape):
    a, b = _images(sum(shape), shape)
    mse = float(np.mean((a - b) ** 2))
    np.testing.assert_allclose(float(timage.mse_to_psnr(mse)), float(jimage.mse_to_psnr(mse)),
                               **TOL)
    np.testing.assert_allclose(float(timage.psnr(torch.as_tensor(a), torch.as_tensor(b))),
                               float(jimage.psnr(jnp.asarray(a), jnp.asarray(b))), **TOL)
    np.testing.assert_allclose(float(timage.ssim(a, b)), float(jimage.ssim(a, b)), **TOL)
    got = timage.ssim(torch.as_tensor(a), torch.as_tensor(b), return_map=True)
    want = np.asarray(jimage.ssim(jnp.asarray(a), jnp.asarray(b), return_map=True))
    assert tuple(got.shape) == want.shape == shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # Another window and constants.
    kw = dict(max_val=2.0, filter_size=7, filter_sigma=1.0, k1=0.02, k2=0.05)
    np.testing.assert_allclose(float(timage.ssim(2 * a, 2 * b, **kw)),
                               float(jimage.ssim(2 * a, 2 * b, **kw)), **TOL)


def test_metric_harness_matches_jax_and_lpips_raises(monkeypatch, tmp_path):
    """Without LPIPS, psnr and ssim; with it (the uncalibrated fallback: no
    weights file where either package looks) lpips, lpips_calibrated and
    avg_err too, JAX's values; the port's LPIPS runs on the device it is
    given and raises for a card that is not there."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("NRC_LPIPS_WEIGHTS", "")
    monkeypatch.setattr(jlpips, "_DEFAULT_PATHS", ("", str(tmp_path / "none.npz")))
    a, b = _images(3, (20, 24, 3))
    want = jimage.MetricHarness(disable_lpips=True)(a, b, name_fn=lambda s: "test_" + s)
    got = timage.MetricHarness(disable_lpips=True)(a, b, name_fn=lambda s: "test_" + s)
    assert sorted(got) == sorted(want) == ["test_psnr", "test_ssim"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    # float64 host images compute in float32, as in JAX.
    got64 = timage.MetricHarness(disable_lpips=True)(a.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(got64["psnr"], want["test_psnr"], **TOL)
    a, b = _images(4, (40, 48, 3))
    want = jimage.MetricHarness()(a, b)
    got = timage.MetricHarness(device="cpu")(a, b)
    assert sorted(got) == sorted(want) == ["avg_err", "lpips", "lpips_calibrated", "psnr", "ssim"]
    assert got["lpips_calibrated"] == want["lpips_calibrated"] == 0.0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LPIPS_TOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="LPIPS"):
            timage.MetricHarness()


@pytest.mark.parametrize("radius", [1, 3])
def test_shift_invariant_metrics_raise(radius):
    """Under use_shift_invariance the port's eval metrics add JAX's
    psnr_shift_invariant (the best-shift MSE over a window of the config's
    radius, pooled over 5x5), on a rendering shifted by one pixel."""
    rng = np.random.RandomState(radius)
    gt = rng.uniform(0, 1, (H * W, 3)).astype(np.float32)
    rendering = {"rgb": np.roll(gt.reshape(H, W, 3), 1, axis=1)}
    cfg = dict(use_shift_invariance=True, shift_invariant_start=-radius,
               shift_invariant_end=radius)
    stub = types.SimpleNamespace(
        config=jconfigs.Config(**cfg), metric_harness=jimage.MetricHarness(disable_lpips=True),
        postprocess_fn=_postprocess, albedo_ratio=None, albedo_clip=1.0)
    want = JTrainer._compute_eval_metrics(
        stub, rendering, jpytrees.Batch(rays=jpytrees.dummy_rays(4), rgb=gt), H, W)
    got = ttrainer.compute_eval_metrics(
        rendering, tpytrees.Batch(rays=None, rgb=torch.as_tensor(gt)), H, W,
        tconfigs.Config(**cfg), timage.MetricHarness(disable_lpips=True), _postprocess)
    assert sorted(got) == sorted(want) == ["psnr", "psnr_shift_invariant", "ssim"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    assert got["psnr_shift_invariant"] > got["psnr"] + 5


H, W, T = 10, 12, 6


def _postprocess(x):
    """The JAX trainer's postprocess in numpy: transients integrated over
    time, then clipped and gamma-encoded."""
    if x.ndim == 4:
        x = x.sum(-2)
    return np.clip(x, 0, 1) ** (1 / 2.2)


def _unit(rng, shape):
    v = rng.normal(size=shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _case(name, seed=0):
    """(config overrides, rendering, batch fields, albedo_ratio) of one case."""
    rng = np.random.RandomState(seed)
    n = H * W
    masks = (rng.uniform(size=(n, 1)) > 0.3).astype(np.float32)
    rgb_gt = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rendering = {"rgb": np.clip(rgb_gt.reshape(H, W, 3) + rng.normal(0, 0.05, (H, W, 3)), 0, 1)
                 .astype(np.float32),
                 "acc": rng.uniform(0.5, 1, (H, W)).astype(np.float32)}
    batch = dict(rgb=rgb_gt, masks=masks)
    cfg, ratio = {}, None
    if name.startswith("normals"):
        batch["normals"] = _unit(rng, (n, 3))
        rendering["normals"] = _unit(rng, (H, W, 3))
        rendering["normals_to_use"] = _unit(rng, (H, W, 3))
        cfg = {"normals_unmasked": dict(evaluate_without_masks=True),
               "normals_target_normals": dict(material_normals_target="normals")}.get(name, {})
    elif name.startswith("depth"):
        batch["depth"] = rng.uniform(2, 6, (n, 1)).astype(np.float32)
        rendering["distance_median"] = rng.uniform(2, 6, (H, W)).astype(np.float32)
        rendering["distance_mean"] = rng.uniform(2, 6, (H, W)).astype(np.float32)
        cfg = dict(evaluate_without_masks=name == "depth_unmasked")
    elif name.startswith("albedo"):
        batch["albedos"] = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        rendering["material_albedo"] = rng.uniform(0, 1.3, (H, W, 3)).astype(np.float32)
        if name == "albedo_given_ratio":
            ratio = np.array([[0.9, 1.1, 1.05]], np.float32)
    elif name == "transient_iou":
        batch["rgb"] = rng.uniform(0, 0.3, (n, T, 3)).astype(np.float32)
        rendering["rgb"] = rng.uniform(0, 0.3, (H, W, T, 3)).astype(np.float32)
        rendering["cache_rgb"] = rng.uniform(0, 0.3, (H, W, T, 3)).astype(np.float32)
        cfg = dict(use_transient=True)
    elif name == "rgb_no_masks":
        batch["masks"] = None
    return cfg, rendering, batch, ratio


CASES = ["rgb_no_masks", "normals_masked", "normals_unmasked", "normals_target_normals",
         "depth_masked", "depth_unmasked", "albedo_per_image_ratio", "albedo_given_ratio",
         "transient_iou"]


@pytest.mark.parametrize("name", CASES)
def test_compute_eval_metrics_matches_jax(name):
    cfg, rendering, fields, ratio = _case(name, seed=CASES.index(name))
    jcfg = jconfigs.Config(**cfg)
    tcfg = tconfigs.Config(**cfg)
    stub = types.SimpleNamespace(
        config=jcfg, metric_harness=jimage.MetricHarness(disable_lpips=True),
        postprocess_fn=_postprocess, albedo_ratio=ratio, albedo_clip=0.95)
    rays = jpytrees.dummy_rays(4)
    want = JTrainer._compute_eval_metrics(
        stub, rendering, jpytrees.Batch(rays=rays, **fields), H, W)
    tbatch = tpytrees.Batch(rays=None, **{k: None if v is None else torch.as_tensor(v)
                                          for k, v in fields.items()})
    got = ttrainer.compute_eval_metrics(
        rendering, tbatch, H, W, tcfg, timage.MetricHarness(disable_lpips=True), _postprocess,
        albedo_ratio=ratio, albedo_clip=0.95)
    expected = {"rgb_no_masks": set(), "transient_iou": {"transient_iou"},
                "albedo_per_image_ratio": {"albedo_psnr"}, "albedo_given_ratio": {"albedo_psnr"}}
    extra = expected.get(name, {"mae"} if name.startswith("normals") else
                         {"l1_median", "l1_mean"})
    assert sorted(got) == sorted(want) == sorted({"psnr", "ssim"} | extra)
    for k in want:
        tol = TOL if k in ("psnr", "ssim") else dict(rtol=1e-6)
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
