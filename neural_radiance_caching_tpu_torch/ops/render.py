"""Ray casting, alpha compositing, steady-state and transient volumetric
rendering (counterpart of ``ops/render.py``).

The transient half: direct pulses are binned by a two-tap matrix contracted
against the sample colours (``bin_direct_pulses``), and each sample's stored
indirect transient is shifted later by its camera distance and summed with
the sample weights. The shift-and-sum has three forms, chosen per call:
``"gather"`` (``shift_transient``, the two-tap gather, then the weighted
sum: the plain reference), ``"fft"`` (phase ramps on ``torch.fft.rfft`` of
the zero-padded transients, at the next power of two >= 2 n_bins + 2) and
``"matmul"`` (the same real DFT as two dense products, at length
2 n_bins + 2). The rendered transients are then convolved over their bins
with the rays' impulse response or a Gaussian of ``tfilter_sigma`` bins
(``convolve_bins``, ``jax.scipy.signal.convolve(mode="same")``'s alignment).
"""

from __future__ import annotations

import math as pymath

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from neural_radiance_caching_tpu_torch.ops import stepfun

_F32_EPS = float(np.finfo(np.float32).eps)


def lift_gaussian(d, t_mean, t_var, r_var, diag):
    """Lift a 1D Gaussian along ray direction d into 3D mean/cov."""
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d**2, dim=-1, keepdim=True), min=1e-10)
    if diag:
        d_outer_diag = d**2
        null_outer_diag = 1 - d_outer_diag / d_mag_sq
        cov_diag = (
            t_var[..., None] * d_outer_diag[..., None, :]
            + r_var[..., None] * null_outer_diag[..., None, :]
        )
        return mean, cov_diag
    d_outer = d[..., :, None] * d[..., None, :]
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
    null_outer = eye - d[..., :, None] * (d / d_mag_sq)[..., None, :]
    cov = (
        t_var[..., None, None] * d_outer[..., None, :, :]
        + r_var[..., None, None] * null_outer[..., None, :, :]
    )
    return mean, cov


def gaussianize_frustum(t0, t1):
    """Stable mean/variance of a conical frustum (arxiv/2103.13415 Eq. 7)."""
    s = t0 + t1
    d = t1 - t0
    eps = _F32_EPS**2
    ratio = d**2 / torch.clamp(3 * s**2 + d**2, min=eps)
    t_mean = s * (1 / 2 + ratio)
    t_var = (1 / 12) * d**2 - (1 / 15) * ratio**2 * (12 * s**2 - d**2)
    r_var = (1 / 16) * s**2 + d**2 * (5 / 48 - (1 / 15) * ratio)
    return t_mean, t_var, r_var


def conical_frustum_to_gaussian(d, t0, t1, base_radius, diag):
    t_mean, t_var, r_var = gaussianize_frustum(t0, t1)
    r_var = r_var * base_radius**2
    return lift_gaussian(d, t_mean, t_var, r_var, diag)


def cylinder_to_gaussian(d, t0, t1, radius, diag):
    t_mean = (t0 + t1) / 2
    r_var = radius**2 / 4
    t_var = (t1 - t0) ** 2 / 12
    return lift_gaussian(d, t_mean, t_var, r_var, diag)


def cast_rays(tdist, origins, directions, radii, ray_shape, diag=True):
    """Turn ray intervals into per-sample Gaussians (means, covs)."""
    t0, t1 = tdist[..., :-1], tdist[..., 1:]
    if ray_shape == "cone":
        gaussian_fn = conical_frustum_to_gaussian
    elif ray_shape == "cylinder":
        gaussian_fn = cylinder_to_gaussian
    else:
        raise ValueError("ray_shape must be 'cone' or 'cylinder'")
    means, covs = gaussian_fn(directions, t0, t1, radii, diag)
    return means + origins[..., None, :], covs


def compute_alpha_weights(density, tdist, dirs, opaque_background=False, delta=None):
    """Per-sample compositing weights w = alpha * transmittance."""
    if delta is None:
        t_delta = tdist[..., 1:] - tdist[..., :-1]
        delta = t_delta * torch.linalg.norm(dirs[..., None, :], dim=-1)
    density_delta = density * torch.abs(delta)
    if opaque_background:
        density_delta = torch.cat(
            [density_delta[..., :-1], torch.full_like(density_delta[..., -1:], float("inf"))],
            dim=-1,
        )
    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat(
        [torch.zeros_like(density_delta[..., :1]), torch.cumsum(density_delta[..., :-1], dim=-1)],
        dim=-1,
    ))
    weights = alpha * trans
    return weights, alpha, trans


def volumetric_rendering(
    rgbs,
    weights,
    weights_no_filter,
    tdist,
    bg_rgbs,
    compute_extras,
    extras=None,
    normalize_weights_for_extras=False,
    percentiles=(5, 50, 95),
    compute_distance=True,
):
    """Composite per-sample values into per-ray buffers.

    `weights` may be resampled-estimator weights while `weights_no_filter`
    carries the full unfiltered weights used for acc/depth statistics.
    """
    del compute_extras
    eps = _F32_EPS
    rendering = {}

    acc = weights_no_filter.sum(dim=-1)
    # maximum, not clamp: at an opacity of exactly 1 (weights normalised to
    # sum to one) the gradient splits between the two sides, as JAX's does.
    bg_w = torch.maximum(1 - acc[..., None], torch.zeros_like(acc[..., None]))
    rendering["rgb"] = (
        (weights[..., None] * rgbs).sum(dim=-2) + bg_w * bg_rgbs if rgbs is not None else None
    )
    rendering["acc"] = acc

    weights_norm = weights / torch.clamp(acc[..., None], min=eps)
    weights_norm_no_filter = weights_no_filter / torch.clamp(acc[..., None], min=eps)

    if extras is not None:
        w_ex = weights_norm if normalize_weights_for_extras else weights
        for k, v in extras.items():
            if v is not None:
                rendering[k] = (w_ex[..., None] * v).sum(dim=-2)

    if compute_distance:
        rendering.update(_distance_stats(tdist, weights_no_filter, weights_norm_no_filter, acc,
                                         percentiles))
    return rendering


def _distance_stats(tdist, weights_no_filter, weights_norm_no_filter, acc, percentiles):
    """Per-ray distance mean (in log space, for stability) and percentiles."""
    out = {}
    t_mids = 0.5 * (tdist[..., :-1] + tdist[..., 1:])
    expectation = (weights_no_filter * torch.log(t_mids)).sum(dim=-1) / torch.clamp(
        acc, min=_F32_EPS)
    out["distance_mean"] = torch.minimum(torch.maximum(
        torch.nan_to_num(torch.exp(expectation)), tdist[..., 0]), tdist[..., -1])
    distance_percentiles = stepfun.weighted_percentile(tdist, weights_norm_no_filter, percentiles)
    for i, p in enumerate(percentiles):
        name = "median" if p == 50 else "percentile_" + str(p)
        out["distance_" + name] = distance_percentiles[..., i]
    return out


# --- Transient (time-resolved) rendering ------------------------------------


def bin_direct_pulses(dists_in_bins, direct_rgbs, weights, n_bins):
    """Direct-pulse energy in time bins: each (ray, sample) with fractional
    arrival bin d adds w * rgb * (1 - frac) to bin floor(d) and w * rgb * frac
    to bin ceil(d), as a [S, n_bins] two-tap matrix per ray contracted with
    the [S, C] colours (a float32 product; TF32 is not used).

    Args:
      dists_in_bins: [R, S] arrival times in bins (shift included).
      direct_rgbs: [R, S, C]; weights: [R, S].

    Returns [R, n_bins, C]. Taps outside [0, n_bins) vanish.
    """
    lo = torch.clamp(torch.floor(dists_in_bins), min=0)
    hi = torch.ceil(dists_in_bins)
    w_hi = dists_in_bins - lo
    w_lo = 1.0 - w_hi
    bins = torch.arange(n_bins, dtype=dists_in_bins.dtype, device=dists_in_bins.device)
    taps = (w_lo[..., None] * (bins == lo[..., None])
            + w_hi[..., None] * (bins == hi[..., None]))  # [R, S, n_bins]
    weighted_rgb = weights[..., None] * direct_rgbs  # [R, S, C]
    return torch.einsum("rsb,rsc->rbc", taps, weighted_rgb.to(taps.dtype))


def shift_transient(transient, bins_move, n_bins):
    """Shift each transient later in time by a fractional number of bins:
    linear interpolation at (bin - bins_move) with zero padding, as two
    gathers of whole bins.

    Args:
      transient: [N, n_bins, C]; bins_move: [N].

    Returns [N, n_bins, C].
    """
    lo = torch.floor(bins_move)
    frac = (bins_move - lo)[..., None, None]
    bins = torch.arange(n_bins, device=transient.device)
    src0 = bins[None, :] - lo[..., None].to(torch.int64)
    src1 = src0 - 1
    c = transient.shape[-1]

    def tap(src):
        valid = ((src >= 0) & (src < n_bins))[..., None]
        g = torch.gather(transient, -2, torch.clamp(src, 0, n_bins - 1)[..., None].expand(
            src.shape + (c,)))
        return torch.where(valid, g, torch.zeros_like(g))

    return (1 - frac) * tap(src0) + frac * tap(src1)


def _rdft_matrices(n_in, length, device):
    """Real-DFT basis: [n_in, F] cos / -sin matrices for zero-padded inputs."""
    b = np.arange(n_in)[:, None]
    f = np.arange(length // 2 + 1)[None, :]
    ang = 2.0 * np.pi * b * f / length
    return (torch.as_tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.as_tensor(-np.sin(ang), dtype=torch.float32, device=device))


def _irdft_matrices(length, n_out, device):
    """Inverse real-DFT basis: [F, n_out] matrices with x = Xr @ Cr + Xi @ Ci
    (interior frequencies count twice, DC and an even length's Nyquist once)."""
    n_freqs = length // 2 + 1
    f = np.arange(n_freqs)[:, None]
    b = np.arange(n_out)[None, :]
    ang = 2.0 * np.pi * f * b / length
    scale = np.full((n_freqs, 1), 2.0 / length)
    scale[0] = 1.0 / length
    if length % 2 == 0:
        scale[-1] = 1.0 / length
    return (torch.as_tensor(scale * np.cos(ang), dtype=torch.float32, device=device),
            torch.as_tensor(-scale * np.sin(ang), dtype=torch.float32, device=device))


SHIFT_FORMS = ("gather", "fft", "matmul")


# Complex elements of per-sample spectra the FFT shift forms at once (1 GiB).
_FFT_CHUNK_ELEMENTS = 1 << 27


def shift_and_integrate_transient(transient, bins_move, weights, n_bins, form="fft"):
    """sum_s weights[r, s] * shift_transient(transient[r, s], bins_move[r, s])
    in the Fourier domain: a shift by a fractional offset is a circular
    convolution with a two-tap kernel, whose DFT is a phase ramp, so

        out[r] = irfft( sum_s w[r, s] * rfft(T_pad)[r, s] * phase(delta[r, s]) )

    with zero padding to L >= 2 n_bins + 2, which keeps the circular
    convolution exact on the [0, n_bins) window over every shift that can
    reach it (shifts are clamped into the alias-free band).

    Args:
      transient: [R, S, n_bins, C]; bins_move: [R, S] (or [R*S]);
      weights: [R, S].
      form: "fft" (torch.fft at the next power of two >= 2 n_bins + 2) or
        "matmul" (the real DFT as dense float32 products at 2 n_bins + 2).

    Returns [R, n_bins, C].
    """
    r, s, b, c = transient.shape
    if b != n_bins:
        raise ValueError(f"transient has {b} bins, n_bins={n_bins}")
    if form == "fft":
        length = 1 << int(2 * n_bins + 1).bit_length()
    elif form == "matmul":
        length = 2 * n_bins + 2
    else:
        raise ValueError(f"unknown spectral form {form!r}")
    half = length - n_bins  # alias-free shift bound (> n_bins)
    delta = torch.clamp(bins_move.reshape(r, s), -(half - 1.0), half - 2.0)
    lo = torch.floor(delta)
    frac = delta - lo

    # Weighted per-sample phase ramp, real and imaginary parts [R, S, F]:
    # w * exp(-i f lo) * ((1 - frac) + frac * exp(-i f)).
    freqs = torch.arange(length // 2 + 1, dtype=torch.float32, device=transient.device) * (
        2.0 * pymath.pi / length)
    ang = -freqs * lo[..., None]
    br, bi = torch.cos(ang), torch.sin(ang)
    fr = frac[..., None]
    tr = (1.0 - fr) + fr * torch.cos(freqs)
    ti = -fr * torch.sin(freqs)
    wt = weights[..., None]
    pr = (br * tr - bi * ti) * wt
    pi = (br * ti + bi * tr) * wt

    t = transient.to(torch.float32).movedim(-2, -1)  # [R, S, C, B]
    if form == "fft":
        def spectrum_sum(t, pr, pi):
            ft = torch.fft.rfft(t, n=length, dim=-1)  # [R, S, C, F]
            return (ft * torch.complex(pr, pi)[:, :, None, :]).sum(dim=1)  # [R, C, F]

        # The per-sample spectra (complex, ~3x the transient's size) are
        # formed a chunk of rays at a time, and recomputed in the backward
        # rather than kept; each ray's sum is the same in any chunking.
        chunk = max(1, _FFT_CHUNK_ELEMENTS // (s * c * (length // 2 + 1)))
        parts = zip(t.split(chunk), pr.split(chunk), pi.split(chunk))
        if torch.is_grad_enabled():
            acc = torch.cat([torch.utils.checkpoint.checkpoint(
                spectrum_sum, *part, use_reentrant=False) for part in parts])
        else:
            acc = torch.cat([spectrum_sum(*part) for part in parts])
        out = torch.fft.irfft(acc, n=length, dim=-1)[..., :n_bins]
    else:
        dc, ds = _rdft_matrices(n_bins, length, transient.device)
        ftr, fti = t @ dc, t @ ds
        accr = (ftr * pr[:, :, None, :] - fti * pi[:, :, None, :]).sum(dim=1)
        acci = (ftr * pi[:, :, None, :] + fti * pr[:, :, None, :]).sum(dim=1)
        icr, ici = _irdft_matrices(length, n_bins, transient.device)
        out = accr @ icr + acci @ ici
    return out.movedim(-1, -2).to(transient.dtype)  # [R, n_bins, C]


def gaussian_filter(tfilter_sigma, device=None):
    """The unit-mass Gaussian of `tfilter_sigma` bins over taps
    [round(-4 sigma), round(4 sigma)], its tails lowered by exp(-8), in
    float32 (83 taps at InvProp's captured scenes' 10.21)."""
    taps = torch.arange(round(-4 * tfilter_sigma), round(4 * tfilter_sigma) + 1,
                        dtype=torch.float32, device=device)
    f = torch.exp(-(taps**2) / (2 * tfilter_sigma**2)) - float(np.exp(-8))
    return f / f.sum()


def _correlate_bins(x, taps, left):
    """Cross-correlate rows [N, B] with `taps` [K], zero-padded by `left`
    bins before and K - 1 - left after, in full float32 (cuDNN's TF32 off)."""
    k = taps.shape[0]
    y = F.pad(x[:, None], (left, k - 1 - left))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv1d(y, taps.to(x.dtype).reshape(1, 1, k))[:, 0]


class _ConvolveRows(torch.autograd.Function):
    """Rows [N, B] convolved with a constant filter [K] (K <= B), "same"
    size: out[n] = sum_k x[n + (K - 1) // 2 - k] f[k]. The backward is the
    correlation with the filter unflipped and the padding mirrored."""

    @staticmethod
    def forward(ctx, x, filt):
        ctx.save_for_backward(filt)
        k = filt.shape[0]
        return _correlate_bins(x, filt.flip(0), k - 1 - (k - 1) // 2)

    @staticmethod
    def backward(ctx, grad):
        (filt,) = ctx.saved_tensors
        return _correlate_bins(grad, filt, (filt.shape[0] - 1) // 2), None


def convolve_bins(x, filt):
    """``jax.scipy.signal.convolve(x, filt[None, :, None], mode="same")``
    over the bins of x [R, B, C]: one ``conv1d`` of the R x C rows against
    the filter flipped (``conv1d`` correlates), padded (K - 1) - (K - 1) // 2
    bins before and (K - 1) // 2 after, as JAX pads an even-length filter
    too. A filter longer than the bins raises, as JAX's does."""
    r, b, c = x.shape
    k = filt.shape[-1]
    if k > b:
        raise ValueError(f"a temporal filter of {k} taps is longer than the {b} time bins it "
                         "convolves (jax.scipy.signal.convolve raises there too)")
    rows = x.movedim(-1, -2).reshape(r * c, b)
    out = _ConvolveRows.apply(rows, filt.detach().to(device=x.device, dtype=torch.float32))
    return out.reshape(r, c, b).movedim(-1, -2)


def volumetric_transient_rendering(
    direct_rgbs,
    transient_indirect,
    weights,
    weights_no_filter,
    tdist,
    bg_rgbs,
    compute_extras,
    extras=None,
    normalize_weights_for_extras=False,
    percentiles=(5, 50, 95),
    compute_distance=True,
    n_bins=700,
    shift=0.0,
    dark_level=0.0,
    impulse_response=None,
    tfilter_sigma=0.0,
    exposure_time=0.01,
    filter_indirect=False,
    filter_median=False,
    filter_median_thresh=0.0,
    no_shift_direct=False,
    shift_form="fft",
):
    """Time-resolved volume rendering.

    Direct light arrives after the light->point->camera path and is binned as
    a pulse; indirect light is each sample's stored transient shifted by its
    point->camera distance. Both are composited with the sample weights.
    ``shift_form`` picks the indirect shift-and-sum ("gather", "fft" or
    "matmul"). The distance statistics are always computed, as in the JAX
    function; ``bg_rgbs`` and ``compute_extras`` are not read.
    """
    del bg_rgbs, compute_extras, compute_distance
    if shift_form not in SHIFT_FORMS:
        raise ValueError(f"unknown transient shift form {shift_form!r}")
    rendering = {}
    acc = weights_no_filter.sum(dim=-1)
    weights_norm = weights / torch.clamp(acc[..., None], min=_F32_EPS)
    weights_norm_no_filter = weights_no_filter / torch.clamp(acc[..., None], min=_F32_EPS)

    w_ex = weights_norm if normalize_weights_for_extras else weights
    for k, v in (extras or {}).items():
        if v is None:
            continue
        if v.dim() == weights.dim() + 2:
            rendering[k] = (w_ex[..., None, None] * v).sum(dim=-3)
        else:
            rendering[k] = (w_ex[..., None] * v).sum(dim=-2)
    rendering.update(_distance_stats(tdist, weights_no_filter, weights_norm_no_filter, acc,
                                     percentiles))

    num_rgb_channels = direct_rgbs.shape[-1]
    n_samples = weights.shape[-1]
    weights_sq = weights.reshape(-1, n_samples)
    n_rays = weights_sq.shape[0]
    dists_ray = extras["ray_dists"].reshape(n_rays, n_samples)
    dists_light = extras["light_dists"].reshape(n_rays, n_samples)
    dists_direct = dists_light + dists_ray

    if filter_median and transient_indirect is not None:
        # Drop the samples in front of the median surface.
        distance_median = rendering["distance_median"].reshape(n_rays, 1)
        effective_depth = dists_ray + filter_median_thresh * exposure_time
        weights_sq = torch.where(effective_depth < distance_median,
                                 torch.zeros_like(weights_sq), weights_sq)
        weights_sq = weights_sq / (weights_sq.sum(dim=-1, keepdim=True) + 1e-5)

    # no_shift_direct removes the per-sample camera-distance shift.
    offset = dists_ray if no_shift_direct else 0.0
    direct_rgbs_sq = direct_rgbs.reshape(n_rays, n_samples, num_rgb_channels)
    direct_bins = (dists_direct + shift - offset) / exposure_time
    transient_direct = bin_direct_pulses(direct_bins, direct_rgbs_sq, weights_sq, n_bins)

    if transient_indirect is not None:
        ti = transient_indirect.reshape(n_rays, n_samples, n_bins, num_rgb_channels)
        bins_move = (dists_ray + shift - offset) / exposure_time
        if shift_form == "gather":
            ti = shift_transient(ti.reshape(n_rays * n_samples, n_bins, num_rgb_channels),
                                 bins_move.reshape(-1), n_bins)
            transient_indirect_out = (ti.reshape(n_rays, n_samples, n_bins, num_rgb_channels)
                                      * weights_sq[..., None, None]).sum(dim=1)
        else:
            transient_indirect_out = shift_and_integrate_transient(
                ti, bins_move, weights_sq, n_bins, shift_form)
        rendering["transient_indirect_no_integration"] = transient_indirect
    else:
        transient_indirect_out = torch.zeros((n_rays, n_bins, num_rgb_channels),
                                             dtype=transient_direct.dtype,
                                             device=transient_direct.device)

    rendering["transient_indirect_no_filter"] = transient_indirect_out
    rendering["transient_direct_no_filter"] = transient_direct
    if impulse_response is not None or tfilter_sigma != 0.0:
        filt = (impulse_response if impulse_response is not None
                else gaussian_filter(tfilter_sigma, transient_direct.device))
        transient_direct = convolve_bins(transient_direct, filt)
        if filter_indirect:
            transient_indirect_out = convolve_bins(transient_indirect_out, filt)
    integrated_shape = weights.shape[:-1]
    transient_direct = transient_direct.reshape(integrated_shape + transient_direct.shape[-2:])
    transient_indirect_out = transient_indirect_out.reshape(
        integrated_shape + transient_indirect_out.shape[-2:])

    rendering["transient_direct_viz"] = transient_direct + dark_level
    rendering["transient_indirect_viz"] = transient_indirect_out
    rendering["dists"] = direct_bins
    rendering["weights"] = weights_sq
    rendering["direct_rgb_viz"] = direct_rgbs_sq.sum(dim=-2)
    rendering["rgb"] = transient_direct + transient_indirect_out + dark_level
    rendering["acc"] = acc
    rendering["direct_rgb"] = transient_direct.sum(dim=-2)
    rendering["indirect_rgb"] = transient_indirect_out.sum(dim=-2)
    rendering["integrated_rgb"] = rendering["rgb"].sum(dim=-2)
    rendering["transient_indirect"] = transient_indirect_out
    rendering["transient_direct"] = transient_direct
    return rendering
