"""Ray casting, alpha compositing and steady-state volumetric rendering
(counterpart of ``ops/render.py`` up to ``volumetric_rendering``; the
transient half is not ported yet)."""

from __future__ import annotations

import numpy as np
import torch

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
    bg_w = torch.clamp(1 - acc[..., None], min=0)
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
        t_mids = 0.5 * (tdist[..., :-1] + tdist[..., 1:])
        expectation = (weights_no_filter * torch.log(t_mids)).sum(dim=-1) / torch.clamp(acc, min=eps)
        # Log-space distance mean for numerical stability.
        rendering["distance_mean"] = torch.minimum(torch.maximum(
            torch.nan_to_num(torch.exp(expectation)), tdist[..., 0]), tdist[..., -1])
        distance_percentiles = stepfun.weighted_percentile(
            tdist, weights_norm_no_filter, percentiles
        )
        for i, p in enumerate(percentiles):
            s = "median" if p == 50 else "percentile_" + str(p)
            rendering["distance_" + s] = distance_percentiles[..., i]
    return rendering
