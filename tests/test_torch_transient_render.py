"""The transient half of the PyTorch port's ``ops/render.py`` and
``ops/render_utils.zero_invalid_bins``, held against the JAX package on the
same numpy-seeded inputs (a few rays, 8 samples, 24 bins).

Tolerances (float32): binning and the two-tap gather are sums of at most a
few products per output, so they agree to 1e-5 of the output's scale. The
spectral forms (the JAX form chosen with ``monkeypatch`` on
``render._SPECTRAL_BACKEND``) run DFTs of length 64 ("fft") and 50
("matmul") whose rounding errors reach ~1e-6 of the largest input for every
output bin, and are held to 1e-4 of the output's scale. The spectral forms
against the gather reference, in the port alone, are held to the same 1e-4.
Gradients of the full rendering are held to 1e-4 of each gradient's scale.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_radiance_caching_tpu.ops import render as jrender
from neural_radiance_caching_tpu.ops import render_utils as jrender_utils
from neural_radiance_caching_tpu_torch.ops import render as trender
from neural_radiance_caching_tpu_torch.ops import render_utils as trender_utils

R, S, BINS, C = 5, 8, 24, 3


def _close(actual, desired, frac):
    desired = np.asarray(desired)
    scale = max(float(np.abs(desired).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0, atol=frac * scale)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    w = rng.rand(R, S).astype(np.float32) / S
    return dict(
        transient=rng.rand(R, S, BINS, C).astype(np.float32),
        # Shifts across the window, past both of its ends, and integral ones.
        bins_move=np.concatenate([rng.uniform(-30, 30, (R, S - 2)),
                                  np.array([[3.0, -2.0]] * R)], axis=1).astype(np.float32),
        weights=w,
        dists=rng.uniform(-2, BINS + 2, (R, S)).astype(np.float32),
        rgbs=rng.rand(R, S, C).astype(np.float32),
    )


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_bin_direct_pulses_matches_jax():
    a = _inputs(0)
    want = jrender.bin_direct_pulses(a["dists"], a["rgbs"], a["weights"], BINS)
    got = trender.bin_direct_pulses(_t(a["dists"]), _t(a["rgbs"]), _t(a["weights"]), BINS)
    _close(got, want, 1e-6)


def test_shift_transient_matches_jax():
    a = _inputs(1)
    ti = a["transient"].reshape(R * S, BINS, C)
    move = a["bins_move"].reshape(-1)
    want = jrender.shift_transient(ti, move, BINS)
    got = trender.shift_transient(_t(ti), _t(move), BINS)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("form", ["fft", "matmul"])
def test_shift_and_integrate_matches_jax_and_gather(form, monkeypatch):
    a = _inputs(2)
    monkeypatch.setattr(jrender, "_SPECTRAL_BACKEND", form)
    want = jrender.shift_and_integrate_transient(a["transient"], a["bins_move"], a["weights"],
                                                 BINS)
    got = trender.shift_and_integrate_transient(
        _t(a["transient"]), _t(a["bins_move"]), _t(a["weights"]), BINS, form)
    _close(got, want, 1e-4)
    shifted = trender.shift_transient(_t(a["transient"]).reshape(R * S, BINS, C),
                                      _t(a["bins_move"]).reshape(-1), BINS)
    gathered = (shifted.reshape(R, S, BINS, C) * _t(a["weights"])[..., None, None]).sum(1)
    _close(got, gathered.numpy(), 1e-4)


def test_unknown_shift_form_raises():
    a = _inputs(3)
    with pytest.raises(ValueError, match="spectral form"):
        trender.shift_and_integrate_transient(
            _t(a["transient"]), _t(a["bins_move"]), _t(a["weights"]), BINS, "dct")


def _render_inputs(seed):
    rng = np.random.RandomState(seed)
    tdist = np.sort(rng.uniform(2, 6, (R, S + 1)), axis=-1).astype(np.float32)
    ti = rng.rand(R, S, BINS, C).astype(np.float32)
    return dict(
        direct_rgbs=rng.rand(R, S, C).astype(np.float32),
        transient_indirect=ti,
        weights=(rng.rand(R, S) / S).astype(np.float32),
        tdist=tdist,
        extras={
            "ray_dists": rng.uniform(2, 6, (R, S, 1)).astype(np.float32),
            "light_dists": rng.uniform(1, 4, (R, S, 1)).astype(np.float32),
            "transient_indirect": ti,
            "diffuse_rgb": rng.rand(R, S, C).astype(np.float32),
        },
    )


@pytest.mark.parametrize("form,filter_median,no_shift_direct", [
    ("gather", False, False), ("fft", False, False), ("matmul", False, False),
    ("gather", True, False), ("fft", False, True)])
def test_volumetric_transient_rendering_matches_jax(form, filter_median, no_shift_direct,
                                                    monkeypatch):
    a = _render_inputs(4)
    monkeypatch.setattr(jrender, "_FFT_TRANSIENT_SHIFT", form != "gather")
    monkeypatch.setattr(jrender, "_SPECTRAL_BACKEND", "fft" if form == "gather" else form)
    kw = dict(n_bins=BINS, shift=0.3, dark_level=0.01, exposure_time=0.5,
              filter_median=filter_median, filter_median_thresh=1.0,
              no_shift_direct=no_shift_direct)
    rng = np.random.RandomState(5)
    probe = rng.randn(R, BINS, C).astype(np.float32)

    def jloss(ti, w):
        extras = dict(a["extras"], transient_indirect=ti)
        out = jrender.volumetric_transient_rendering(
            a["direct_rgbs"], ti, w, w, a["tdist"], 0.0, False, extras=extras, **kw)
        return (out["rgb"] * probe).sum(), out

    want = jloss(a["transient_indirect"], a["weights"])[1]
    g_ti, g_w = jax.grad(lambda t, w_: jloss(t, w_)[0], argnums=(0, 1))(
        a["transient_indirect"], a["weights"])
    ti = _t(a["transient_indirect"]).requires_grad_()
    w = _t(a["weights"]).requires_grad_()
    extras = {k: _t(v) for k, v in a["extras"].items()}
    extras["transient_indirect"] = ti
    got = trender.volumetric_transient_rendering(
        _t(a["direct_rgbs"]), ti, w, w, _t(a["tdist"]), 0.0, False, extras=extras,
        shift_form=form, **kw)
    assert set(got) == set(want)
    for k in ("rgb", "transient_direct", "transient_indirect", "direct_rgb", "indirect_rgb",
              "diffuse_rgb", "distance_median", "acc", "weights", "dists"):
        _close(got[k].detach(), want[k], 1e-4)
    (got["rgb"] * _t(probe)).sum().backward()
    _close(ti.grad, g_ti, 1e-4)
    _close(w.grad, g_w, 1e-4)


def test_transient_rendering_impulse_filter_raises():
    """The temporal filter is ported (held against JAX in
    tests/test_torch_invprop_scenes.py); a filter longer than the bins (a
    Gaussian of 4 bins has 33 taps) raises, as JAX's convolution does."""
    a = _render_inputs(6)
    with pytest.raises(ValueError, match="33 taps is longer than the 24 time bins"):
        trender.volumetric_transient_rendering(
            _t(a["direct_rgbs"]), _t(a["transient_indirect"]), _t(a["weights"]),
            _t(a["weights"]), _t(a["tdist"]), 0.0, False,
            extras={k: _t(v) for k, v in a["extras"].items()}, n_bins=BINS, tfilter_sigma=4.0)
    with pytest.raises(ValueError, match="smaller than the other"):
        jrender.volumetric_transient_rendering(
            a["direct_rgbs"], a["transient_indirect"], a["weights"], a["weights"], a["tdist"],
            0.0, False, extras=a["extras"], n_bins=BINS, tfilter_sigma=4.0)


@pytest.mark.parametrize("light_zero,light_near", [(True, 0.0), (True, 2.5), (False, 2.5)])
def test_zero_invalid_bins_matches_jax(light_zero, light_near):
    rng = np.random.RandomState(7)
    cfg = types.SimpleNamespace(n_bins=BINS, exposure_time=0.5, bin_zero_threshold_light=2.0,
                                light_zero=light_zero, light_near=light_near)
    diffuse = rng.rand(R, S, BINS, C).astype(np.float32)
    specular = rng.rand(R, S, BINS, C).astype(np.float32)
    means = rng.uniform(-1, 1, (R, S, 3)).astype(np.float32)
    rays = dict(lights=rng.uniform(-3, 3, (R, 3)).astype(np.float32),
                origins=rng.uniform(-4, 4, (R, 3)).astype(np.float32),
                cam_origins=rng.uniform(-4, 4, (R, 3)).astype(np.float32))
    want = jrender_utils.zero_invalid_bins(
        jnp.asarray(diffuse), jnp.asarray(specular), types.SimpleNamespace(**rays), means, cfg)
    got = trender_utils.zero_invalid_bins(
        _t(diffuse), _t(specular), types.SimpleNamespace(**{k: _t(v) for k, v in rays.items()}),
        _t(means), cfg)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    # The masks zero some bins and keep others.
    assert 0 < float((got[0] == 0).float().mean()) < 1
