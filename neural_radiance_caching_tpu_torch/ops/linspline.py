"""Piecewise-linear spline utilities behind the spline interlevel loss
(counterpart of ``ops/linspline.py``; only what that loss reaches)."""

from __future__ import annotations

import numpy as np
import torch

from neural_radiance_caching_tpu_torch.ops import math

EPS2 = float(np.float32(np.finfo(np.float32).eps ** 2))


def check_linspline(t, y):
    if t.shape[-1] != y.shape[-1]:
        raise ValueError(f"Invalid linspline shapes ({t.shape}, {y.shape}).")


def compute_integral(t, y):
    """Integrate a linear spline into per-interval quadratic coefficients.

    Returns (a, b, c) with the integral on interval i given by
    a[i]*(t-t[i])^2 + b[i]*(t-t[i]) + c[i].
    """
    check_linspline(t, y)
    dt = torch.diff(t)
    a = torch.diff(y) / torch.clamp(2 * dt, min=EPS2)
    b = y[..., :-1]
    c1 = 0.5 * torch.cumsum(dt[..., :-1] * (y[..., :-2] + y[..., 1:-1]), dim=-1)
    c = torch.cat([torch.zeros_like(y[..., :1]), c1], dim=-1)
    return a, b, c


def interpolate_integral(tq, t, a, b, c):
    """Evaluate the piecewise quadratic from compute_integral at tq."""
    tq = torch.minimum(torch.maximum(tq, t[..., :1]), math.minus_eps(t[..., -1:]))
    idx0, _ = math.searchsorted(t, tq)
    take = lambda v: math.take_along_last(v, idx0)
    td = tq - take(t)
    return take(a) * td**2 + take(b) * td + take(c)


def blur_stepfun(ts, ys, halfwidth):
    """Box-blur a step function into a linear spline.

    Each step edge becomes a ramp of width 2*halfwidth: second-derivative
    deltas are splatted at the ramp ends, sorted with their knots, and
    integrated twice.
    """
    if ts.shape[-1] != ys.shape[-1] + 1:
        raise ValueError(f"Invalid stepfun shapes ({ts.shape}, {ys.shape}).")
    ts_lo = torch.minimum(math.minus_eps(ts), ts - halfwidth)
    ts_hi = torch.maximum(math.plus_eps(ts), ts + halfwidth)

    ys0 = torch.cat([torch.zeros_like(ys[..., :1]), ys, torch.zeros_like(ys[..., :1])], dim=-1)
    dy = torch.diff(ys0) / (ts_hi - ts_lo)

    tp = torch.cat([ts_lo, ts_hi], dim=-1)
    dyp = torch.cat([dy, -dy], dim=-1)
    tp, order = torch.sort(tp, dim=-1, stable=True)
    dyp = torch.gather(dyp, -1, order)[..., :-2]

    yp = torch.cumsum(torch.diff(tp)[..., :-1] * torch.cumsum(dyp, dim=-1), dim=-1)
    yp = torch.cat([torch.zeros_like(yp[..., :1]), yp, torch.zeros_like(yp[..., -1:])], dim=-1)
    return tp, yp
