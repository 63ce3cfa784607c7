"""The port's LPIPS and E-LPIPS (``ops/lpips``), its metric harness with
LPIPS on, and its offline evaluator against the JAX package's, on images
made from a seed with numpy.

Tolerances: the parameters (fallback, synthesized, read from a file) are
equal bit for bit. LPIPS to rtol 1e-4 (float32 convolutions in another
order: cuDNN-free CPU conv2d in NCHW against XLA's NHWC; the two images
of a pair share one batched pass here). E-LPIPS without dropout to the
same rtol (the transformations are numpy's draws in both). With dropout
the masks are not JAX's threefry bits, so the port's mean over 8 seeds
lies within the spread of JAX's value over 8 seeds: its mean give or take
its range (the range of 8 draws is about 2.8 standard deviations of one,
the difference of two means of 8 has 0.5; one draw moves the value by
about 0.3%). The harness's psnr and ssim to rtol
1e-5, its lpips and avg_err to rtol 1e-4. The evaluator's JSON equals
JAX's to the same tolerances, its E-LPIPS (dropout on) to 5% relative.
Each file of weights is written by the test; HOME and NRC_LPIPS_WEIGHTS
point where no real file is.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from neural_radiance_caching_tpu.ops import image as jimage
from neural_radiance_caching_tpu.ops import lpips as jlpips
from neural_radiance_caching_tpu_torch.evaluation import run_evaluation as trun
from neural_radiance_caching_tpu_torch.ops import image as timage
from neural_radiance_caching_tpu_torch.ops import lpips as tlpips
from neural_radiance_caching_tpu_torch.utils import weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LPIPS_TOL = dict(rtol=1e-4, atol=1e-7)
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
ELPIPS_DROPOUT_RTOL = 0.05


@pytest.fixture(autouse=True)
def no_weights_file(tmp_path, monkeypatch):
    """No calibrated weights anywhere the search looks (either package)."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("NRC_LPIPS_WEIGHTS", "")
    monkeypatch.setattr(jlpips, "_DEFAULT_PATHS", ("", str(tmp_path / "home" / "none.npz"),
                                                   str(tmp_path / "none.npz")))
    assert tlpips.find_weights() is None


def _pair(seed, shape):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


def _assert_params_equal(got, want):
    assert got["calibrated"] == want["calibrated"]
    assert len(got["convs"]) == len(want["convs"]) == 13
    for (gw, gb), (ww, wb) in zip(got["convs"], want["convs"]):
        np.testing.assert_array_equal(gw, np.asarray(ww))
        np.testing.assert_array_equal(gb, np.asarray(wb))
    for g, w in zip(got["lins"], want["lins"]):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("which", ["fallback", "synthesize_0", "synthesize_5"])
def test_params_equal_jax(which):
    if which == "fallback":
        _assert_params_equal(tlpips.fallback_params(), jlpips.fallback_params())
        _assert_params_equal(tlpips.default_params(), jlpips.default_params())
    else:
        seed = int(which.split("_")[1])
        _assert_params_equal(tlpips.synthesize_params(seed), jlpips.synthesize_params(seed))
    assert tlpips.VGG_CONVS == jlpips.VGG_CONVS and tlpips.SLICE_ENDS == jlpips.SLICE_ENDS
    np.testing.assert_array_equal(tlpips._SHIFT, jlpips._SHIFT)
    np.testing.assert_array_equal(tlpips._SCALE, jlpips._SCALE)


LPIPS_CASES = [(pool, shape) for pool in ("max", "avg")
               for shape in ((64, 64, 3), (96, 128, 3), (2, 64, 64, 3))]


@pytest.mark.parametrize("pool,shape", LPIPS_CASES)
def test_lpips_matches_jax(pool, shape):
    a, b = _pair(sum(shape), shape)
    jparams = jlpips.fallback_params()
    want = np.asarray(jlpips.lpips(jparams, jnp.asarray(a), jnp.asarray(b), pool=pool))
    host = tlpips.fallback_params()
    got = tlpips.lpips(host, a, b, pool=pool)
    assert tuple(got.shape) == want.shape == shape[:-3]
    np.testing.assert_allclose(got.numpy(), want, **LPIPS_TOL)
    # Tensors on the device, the parameters moved once.
    on_device = weights.lpips_params_to_torch(host, "cpu")
    got2 = tlpips.lpips(on_device, torch.as_tensor(a), torch.as_tensor(b), pool=pool)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())
    assert float(tlpips.lpips(host, a, a, pool=pool).max()) == 0.0


@pytest.mark.parametrize("shape", [(12, 12, 3), (15, 40, 3), (2, 16, 9, 3)])
def test_lpips_under_16_pixels_is_nan_as_in_jax(shape):
    """A view under 16 pixels on a side leaves the fifth tap no pixel: the
    mean over none is NaN in both packages."""
    a, b = _pair(sum(shape), shape)
    want = np.asarray(jlpips.lpips(jlpips.fallback_params(), jnp.asarray(a), jnp.asarray(b)))
    got = tlpips.lpips(tlpips.fallback_params(), a, b).numpy()
    assert got.shape == want.shape and np.isnan(want).all() and np.isnan(got).all()


def test_elpips_equals_jax_without_dropout():
    a, b = _pair(11, (96, 80, 3))
    jparams, tparams = jlpips.fallback_params(), tlpips.fallback_params()
    for seed, n in ((0, 3), (4, 2)):
        want = jlpips.elpips(jparams, a, b, num_samples=n, seed=seed, dropout_keep=1.0)
        got = tlpips.elpips(tparams, a, b, num_samples=n, seed=seed, dropout_keep=1.0)
        np.testing.assert_allclose(got, want, **LPIPS_TOL)
    # The transformations themselves are numpy's draws, equal.
    rng_j, rng_t = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(4):
        tj, tt = jlpips._sample_transform(rng_j, 96, 80, 2), tlpips._sample_transform(rng_t, 96,
                                                                                     80, 2)
        np.testing.assert_array_equal(tlpips._apply_transform(a, tt),
                                      jlpips._apply_transform(a, tj))


def test_elpips_dropout_shares_masks_and_lies_within_jax_spread():
    a, b = _pair(12, (64, 64, 3))
    jparams, tparams = jlpips.fallback_params(), tlpips.fallback_params()
    # One mask per convolution for both images: equal images stay at 0.
    gen = torch.Generator().manual_seed(5)
    assert float(tlpips.lpips(tparams, a, a, pool="avg", dropout_rng=gen)) == 0.0
    assert float(jlpips.lpips(jparams, jnp.asarray(a), jnp.asarray(a), pool="avg",
                              dropout_rng=jax.random.PRNGKey(5))) == 0.0
    want = [float(jlpips.lpips(jparams, jnp.asarray(a), jnp.asarray(b), pool="avg",
                               dropout_rng=jax.random.PRNGKey(s), dropout_keep=0.99))
            for s in range(8)]
    got = [float(tlpips.lpips(tparams, a, b, pool="avg",
                              dropout_rng=torch.Generator().manual_seed(s), dropout_keep=0.99))
           for s in range(8)]
    spread = max(want) - min(want)
    assert abs(np.mean(got) - np.mean(want)) <= spread, (got, want)
    # Dropout moves the value; a seed repeats it.
    no_drop = float(tlpips.lpips(tparams, a, b, pool="avg"))
    assert len(set(got)) == 8 and no_drop not in got
    assert got[3] == float(tlpips.lpips(tparams, a, b, pool="avg",
                                        dropout_rng=torch.Generator().manual_seed(3)))


def _write_weights(path, seed=7):
    """A weights file in the converter's layout, some head entries negative
    (both loaders clip them at 0)."""
    p = jlpips.synthesize_params(seed)
    arrays = {}
    for i, (w, b) in enumerate(p["convs"]):
        arrays[f"conv{i}_w"] = np.asarray(w)
        arrays[f"conv{i}_b"] = np.asarray(b) + 0.01 * i
    for j, lin in enumerate(p["lins"]):
        arrays[f"lin{j}"] = (np.asarray(lin) - 0.5 / lin.shape[0])[None]
    np.savez(path, **arrays)


def test_weights_file_loads_in_both_packages(tmp_path, monkeypatch):
    path = str(tmp_path / "lpips_vgg16.npz")
    _write_weights(path)
    assert tlpips.load_params() is None and jlpips.load_params() is None
    got, want = tlpips.load_params(path), jlpips.load_params(path)
    _assert_params_equal(got, want)
    assert got["calibrated"] and min(float(lin.min()) for lin in got["lins"]) == 0.0
    # Found by the environment variable, and in the user cache under HOME.
    monkeypatch.setenv("NRC_LPIPS_WEIGHTS", path)
    assert tlpips.find_weights() == path
    monkeypatch.setenv("NRC_LPIPS_WEIGHTS", "")
    cache = tmp_path / "home" / ".cache" / "neural_radiance_caching_tpu"
    cache.mkdir(parents=True)
    _write_weights(str(cache / "lpips_vgg16.npz"))
    assert tlpips.find_weights() == str(cache / "lpips_vgg16.npz")
    _assert_params_equal(tlpips.default_params(), want)
    # Both harnesses report the calibrated file.
    a, b = _pair(2, (32, 48, 3))
    jh = jimage.MetricHarness(lpips_weights_path=path)(a, b)
    th = timage.MetricHarness(lpips_weights_path=path, device="cpu")(a, b)
    assert th["lpips_calibrated"] == jh["lpips_calibrated"] == 1.0
    np.testing.assert_allclose(th["lpips"], jh["lpips"], **LPIPS_TOL)


@pytest.mark.parametrize("shape", [(48, 64, 3), (64, 64, 3)])
def test_metric_harness_matches_jax(shape):
    a, b = _pair(sum(shape) + 1, shape)
    name = lambda s: "test_" + s  # noqa: E731
    want = jimage.MetricHarness()(a, b, name_fn=name)
    got = timage.MetricHarness(device="cpu")(a, b, name_fn=name)
    assert sorted(got) == sorted(want) == sorted(
        "test_" + k for k in ("psnr", "ssim", "lpips", "lpips_calibrated", "avg_err"))
    assert got["test_lpips_calibrated"] == want["test_lpips_calibrated"] == 0.0
    for k in ("test_psnr", "test_ssim"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **METRIC_TOL)
    for k in ("test_lpips", "test_avg_err"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LPIPS_TOL)
    # Injected params, and the harness's device check.
    synth = tlpips.synthesize_params(1)
    got = timage.MetricHarness(lpips_params=synth, device="cpu")(a, b)
    want = jimage.MetricHarness(lpips_params=jlpips.synthesize_params(1))(a, b)
    np.testing.assert_allclose(got["lpips"], want["lpips"], **LPIPS_TOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            timage.MetricHarness()


def _render_dirs(root, kind, n=3, shape=(40, 56, 3)):
    gt_dir, pred_dir = os.path.join(root, "gt"), os.path.join(root, "pred")
    os.makedirs(gt_dir)
    os.makedirs(pred_dir)
    for i in range(n):
        a, b = _pair(30 + i, shape)
        if kind == "npy":
            b[0, 0, 0] = np.nan  # zeroed by both loaders
            np.save(os.path.join(gt_dir, f"{i:06d}.npy"), a)
            np.save(os.path.join(pred_dir, f"{i:06d}.npy"), b)
        else:
            Image.fromarray((a * 255).astype(np.uint8)).save(os.path.join(gt_dir, f"{i}.png"))
            Image.fromarray((b * 255).astype(np.uint8)).save(os.path.join(pred_dir, f"{i}.png"))
    return gt_dir, pred_dir


def _jax_evaluation(argv, monkeypatch, capsys):
    sys.path.insert(0, os.path.join(REPO, "evaluation"))
    try:
        import run_evaluation as jrun
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(sys, "argv", ["run_evaluation.py"] + argv)
    capsys.readouterr()
    jrun.main()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("kind,elpips", [("npy", 0), ("png", 0), ("npy", 2)])
def test_run_evaluation_matches_jax(kind, elpips, tmp_path, monkeypatch, capsys):
    gt_dir, pred_dir = _render_dirs(str(tmp_path), kind)
    argv = ["--gt_dir", gt_dir, "--pred_dir", pred_dir, "--elpips_samples", str(elpips)]
    want_lines = _jax_evaluation(argv + ["--out", str(tmp_path / "jax.json")], monkeypatch,
                                 capsys)
    got = trun.main(argv + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    got_lines = capsys.readouterr().out.splitlines()
    want = json.loads(want_lines[-1])
    assert json.loads(got_lines[-1]) == got == json.load(open(tmp_path / "port.json"))
    assert sorted(got) == sorted(want)
    assert got["count"] == want["count"] == 3
    assert got["lpips_calibrated"] is want["lpips_calibrated"] is False
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **METRIC_TOL)
    np.testing.assert_allclose(got["lpips"], want["lpips"], **LPIPS_TOL)
    if elpips:
        assert got["elpips_caveat"] == want["elpips_caveat"]
        np.testing.assert_allclose(got["elpips"], want["elpips"], rtol=ELPIPS_DROPOUT_RTOL)
    else:
        assert got["elpips"] is want["elpips"] is None
        # The per-image lines, as JAX prints them.
        assert [ln for ln in got_lines if ": psnr=" in ln] == [
            ln for ln in want_lines if ": psnr=" in ln]
