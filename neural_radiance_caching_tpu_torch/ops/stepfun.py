"""Piecewise-constant step-function toolkit (counterpart of ``ops/stepfun.py``).

Conventions match: `t` are the N+1 bin endpoints, `w` N bin weights summing
to <= 1, `p` a PDF integrating to <= 1, logits unconstrained bin values.
"""

from __future__ import annotations

import numpy as np
import torch

from neural_radiance_caching_tpu_torch.ops import math
from neural_radiance_caching_tpu_torch.utils import torchutil

_F32_EPS = float(np.finfo(np.float32).eps)
_INF = float("inf")


def check_stepfun(t, y):
    if t.shape[-1] != y.shape[-1] + 1:
        raise ValueError(f"Invalid stepfun shapes ({t.shape}, {y.shape}).")


def weight_to_pdf(t, w):
    """Weights (sum to 1) -> PDF (integrates to 1)."""
    check_stepfun(t, w)
    td = torch.diff(t)
    return torch.where(td < math.F32_TINY, torch.zeros_like(td), math.safe_div(w, td))


def pdf_to_weight(t, p):
    check_stepfun(t, p)
    return p * torch.diff(t)


def integrate_weights(w):
    """CDF at the N+1 endpoints of a weight vector; endpoints pinned to 0 and 1."""
    cw = torch.clamp(torch.cumsum(w[..., :-1], dim=-1), max=1)
    pad = cw.shape[:-1] + (1,)
    return torch.cat([torch.zeros(pad, dtype=w.dtype, device=w.device), cw,
                      torch.ones(pad, dtype=w.dtype, device=w.device)], dim=-1)


def invert_cdf(u, t, w_logits):
    """Inverse-CDF lookup of u in the step function defined by (t, softmax(w))."""
    check_stepfun(t, w_logits)
    w = torch.softmax(w_logits, dim=-1)
    cw = integrate_weights(w)
    return math.sorted_interp(u, cw, t)


def sample(rng, t, w_logits, num_samples, single_jitter=False,
           deterministic_center=False, eps=_F32_EPS):
    """Draw point samples from a step-function PDF.

    With rng=None, returns a deterministic linspace over the inverse CDF;
    `single_jitter` shares one jitter across all samples of a ray.
    """
    check_stepfun(t, w_logits)
    kw = dict(dtype=t.dtype, device=t.device)
    if rng is None:
        if deterministic_center:
            pad = 1 / (2 * num_samples)
            u = torch.linspace(pad, 1.0 - pad - eps, num_samples, **kw)
        else:
            u = torch.linspace(0, 1.0 - eps, num_samples, **kw)
        u = torch.broadcast_to(u, t.shape[:-1] + (num_samples,))
    else:
        # Stratified draw over [0, 1): evenly spaced anchors, each jittered
        # uniformly within a stratum that never reaches the next anchor.
        span = 1.0 - (eps + (1.0 - eps) / num_samples)
        stride = span / (num_samples - 1)
        anchors = stride * torch.arange(num_samples, **kw)
        jitter_shape = t.shape[:-1] + ((1,) if single_jitter else (num_samples,))
        u = anchors + torchutil.uniform(rng, jitter_shape, t.device, t.dtype) * (stride - eps)
    return invert_cdf(u, t, w_logits)


def sample_intervals(rng, t, w_logits, num_samples, single_jitter=False,
                     domain=(-_INF, _INF)):
    """Sample N intervals (N+1 sorted fenceposts) from a step-function PDF."""
    check_stepfun(t, w_logits)
    if num_samples <= 1:
        raise ValueError(f"num_samples must be > 1, is {num_samples}.")
    centers = sample(rng, t, w_logits, num_samples, single_jitter, deterministic_center=True)
    mid = (centers[..., 1:] + centers[..., :-1]) / 2
    first = 2 * centers[..., :1] - mid[..., :1]
    last = 2 * centers[..., -1:] - mid[..., -1:]
    fence = torch.cat([first, mid, last], dim=-1)
    return torch.sort(torch.clamp(fence, *domain), dim=-1).values


def max_dilate(t, w, dilation, domain=(-_INF, _INF)):
    """Max-pool dilation of a non-negative step function."""
    check_stepfun(t, w)
    t0 = t[..., :-1] - dilation
    t1 = t[..., 1:] + dilation
    t_d = torch.sort(torch.cat([t, t0, t1], dim=-1), dim=-1).values
    t_d = torch.clamp(t_d, *domain)
    covered = (t0[..., None, :] <= t_d[..., None]) & (t1[..., None, :] > t_d[..., None])
    w_d = torch.amax(torch.where(covered, w[..., None, :], torch.zeros_like(w[..., None, :])),
                     dim=-1)[..., :-1]
    return t_d, w_d


def max_dilate_weights(t, w, dilation, domain=(-_INF, _INF), renormalize=False,
                       eps=_F32_EPS**2):
    """Dilate weights via the PDF domain."""
    check_stepfun(t, w)
    p = weight_to_pdf(t, w)
    t_d, p_d = max_dilate(t, p, dilation, domain=domain)
    w_d = pdf_to_weight(t_d, p_d)
    if renormalize:
        w_d = w_d / torch.clamp(torch.sum(w_d, dim=-1, keepdim=True), min=eps)
    return t_d, w_d


def lossfun_distortion(t, w, normalize=False):
    """mip-NeRF 360 distortion: sum_ij w_i w_j |t_i - t_j| + intra-interval term."""
    check_stepfun(t, w)
    if normalize:
        w = w + _F32_EPS**2
        w = w / torch.sum(w, dim=-1, keepdim=True)
    ut = (t[..., 1:] + t[..., :-1]) / 2
    dut = torch.abs(ut[..., :, None] - ut[..., None, :])
    loss_inter = torch.sum(w * torch.sum(w[..., None, :] * dut, dim=-1), dim=-1)
    loss_intra = torch.sum(w**2 * torch.diff(t), dim=-1) / 3
    return loss_inter + loss_intra


def weighted_percentile(t, w, ps):
    """Percentiles of a step function; w must sum to 1."""
    check_stepfun(t, w)
    cw = integrate_weights(w)
    qs = torch.as_tensor(np.asarray(ps, np.float32) / 100, dtype=t.dtype, device=t.device)
    qs = torch.broadcast_to(qs, t.shape[:-1] + (len(ps),))
    return math.sorted_interp(qs, cw, t)


def inner_outer(t0, t1, y1):
    """The inner and outer measures of the step function (t1, y1) on the
    intervals t0."""
    check_stepfun(t1, y1)
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)], dim=-1)
    (idx_lo, idx_hi), ((cy1_lo, cy1_hi),) = math.sorted_lookup(t0, t1, (cy1,))
    y0_outer = cy1_hi[..., 1:] - cy1_lo[..., :-1]
    y0_inner = torch.where(idx_hi[..., :-1] <= idx_lo[..., 1:],
                           cy1_lo[..., 1:] - cy1_hi[..., :-1], torch.zeros_like(y0_outer))
    return y0_inner, y0_outer


def lossfun_outer(t, w, t_env, w_env, eps=_F32_EPS):
    """The proposal loss of mip-NeRF 360: w beyond the envelope's outer
    measure, squared, over w."""
    check_stepfun(t, w)
    check_stepfun(t_env, w_env)
    _, w_outer = inner_outer(t, t_env, w_env)
    return torch.clamp(w - w_outer, min=0) ** 2 / (w + eps)


def blur_and_resample_weights(tq, t, w, blur_halfwidth):
    """Blur histogram (t, w) with a box of half-width `blur_halfwidth`, re-bin
    to tq. Backs the spline interlevel loss."""
    from neural_radiance_caching_tpu_torch.ops import linspline

    check_stepfun(t, w)
    p = weight_to_pdf(t, w)
    t_lin, p_lin = linspline.blur_stepfun(t, p, blur_halfwidth)
    quad = linspline.compute_integral(t_lin, p_lin)
    acc_wq = linspline.interpolate_integral(tq, t_lin, *quad)
    return torch.clamp(torch.diff(acc_wq, dim=-1), min=0)
