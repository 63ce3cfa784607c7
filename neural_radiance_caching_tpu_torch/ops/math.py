"""Numerically-safe math primitives (counterpart of ``ops/math.py``).

The JAX ``custom_vjp``/``custom_jvp`` ops become ``torch.autograd.Function``s
with the same forward values and the same gradients. The TPU mask-reduction
lookups (``take_along_last``, ``sorted_lookup``) become ``torch.gather`` and
``torch.searchsorted``; their outputs are identical.
"""

from __future__ import annotations

import functools
import math as pymath

import numpy as np
import torch

F32_TINY = float(np.finfo(np.float32).tiny)
F32_MIN = float(np.finfo(np.float32).min)
F32_MAX = float(np.finfo(np.float32).max)
F32_EPS = float(np.finfo(np.float32).eps)


def _t(x, like=None):
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.as_tensor(x, dtype=torch.float32)


def dot(x, y, axis=-1, keepdims=True):
    return (x * y).sum(dim=axis, keepdim=keepdims)


def normalize(x, eps=0.0):
    denom = torch.linalg.norm(x, dim=-1, keepdim=True)
    if eps:
        denom = torch.clamp(denom, min=eps)
    return x / denom


def safe_sign(x):
    """sign(x) with sign(0) := +1."""
    return torch.where(x < 0, -1.0, 1.0).to(x.dtype)


def remove_zero(x):
    """Replace values within [-tiny, tiny] by tiny."""
    return torch.where(torch.abs(x) < F32_TINY, torch.full_like(x, F32_TINY), x)


def _trig_safe(x, fn, period=100 * pymath.pi):
    # Wrap huge arguments into a finite range before the transcendental.
    return fn(torch.nan_to_num(torch.where(torch.abs(x) < period, x, torch.remainder(x, period))))


def safe_sin(x):
    return _trig_safe(x, torch.sin)


def _nextafter(x, direction):
    return torch.nextafter(x, torch.full_like(x, direction))


class _StraightThrough(torch.autograd.Function):
    """Forward value fn(x), gradient passed through unchanged (custom_jvp
    identity tangent in the JAX package)."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _plus_eps_value(x):
    return torch.where(torch.abs(x) < F32_TINY, torch.full_like(x, F32_TINY),
                       _nextafter(x, float("inf")))


def _minus_eps_value(x):
    return torch.where(torch.abs(x) < F32_TINY, torch.full_like(x, -F32_TINY),
                       _nextafter(x, float("-inf")))


def plus_eps(x):
    return _StraightThrough.apply(_t(x), _plus_eps_value)


def minus_eps(x):
    return _StraightThrough.apply(_t(x), _minus_eps_value)


def _make_clip_nograd(lo, hi):
    def f(x):
        return _StraightThrough.apply(_t(x), lambda v: torch.clamp(v, lo, hi))

    return f


clip_finite_nograd = _make_clip_nograd(F32_MIN, F32_MAX)
clip_pos_finite_nograd = _make_clip_nograd(F32_TINY, F32_MAX)


class _SafeDiv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, d):
        dz = remove_zero(d)
        r = torch.clamp(n / dz, F32_MIN, F32_MAX)
        ctx.save_for_backward(dz, r)
        ctx.shapes = (n.shape, d.shape)
        return torch.where(torch.abs(d) < F32_TINY, torch.zeros_like(r), r)

    @staticmethod
    def backward(ctx, g):
        dz, r = ctx.saved_tensors
        dn = torch.clamp(g / dz, F32_MIN, F32_MAX)
        dd = torch.clamp(-g * r / dz, F32_MIN, F32_MAX)
        n_shape, d_shape = ctx.shapes
        return dn.sum_to_size(n_shape), dd.sum_to_size(d_shape)


def safe_div(n, d):
    """n/d whose value and gradients never produce NaN/Inf."""
    n = _t(n, d if isinstance(d, torch.Tensor) else None)
    d = _t(d, n)
    return _SafeDiv.apply(n, d)


class _SafeFn(torch.autograd.Function):
    """fn(clip(x, lo, hi)) with gradient grad_fn(clip(x), y, g): the clip
    applies in the backward pass too (the JAX custom_jvp)."""

    @staticmethod
    def forward(ctx, x, fn, grad_fn, lo, hi):
        xc = torch.clamp(x, lo, hi)
        y = fn(xc)
        ctx.save_for_backward(xc, y)
        ctx.grad_fn = grad_fn
        return y

    @staticmethod
    def backward(ctx, g):
        xc, y = ctx.saved_tensors
        return ctx.grad_fn(xc, y, g), None, None, None, None


def _make_safe_fn(fn, grad_fn, lo, hi):
    def f(x):
        return _SafeFn.apply(_t(x), fn, grad_fn, lo, hi)

    return f


safe_log = _make_safe_fn(torch.log, lambda x, _, dx: dx / x, F32_TINY, F32_MAX)
safe_exp = _make_safe_fn(torch.exp, lambda _, y, dx: y * dx, F32_MIN, 70.0)
safe_sqrt = _make_safe_fn(
    torch.sqrt, lambda x, _, dx: 0.5 * dx / torch.sqrt(torch.clamp(x, min=F32_TINY)),
    0.0, F32_MAX,
)
safe_log1p = _make_safe_fn(
    torch.log1p, lambda x, _, dx: dx / (1 + x),
    float(np.nextafter(np.float32(-1), np.float32(0))), F32_MAX,
)
safe_expm1 = _make_safe_fn(
    torch.expm1, lambda x, _, dx: torch.exp(x) * dx,
    F32_MIN, float(np.nextafter(np.log1p(np.float32(F32_MAX)), np.float32(0))),
)


def override_gradient(fval, bval):
    """Forward value = fval, gradient flows through bval."""
    return fval.detach() + (bval - bval.detach())


def select(cond_pairs, default):
    """First matching (condition, value) pair wins, like jnp.select."""
    out = default
    for cond, val in reversed(cond_pairs):
        out = torch.where(cond, _t(val, out), out)
    return out


def power_ladder(x, p, premult=None, postmult=None):
    """Tukey's power ladder curve with special cases at p in {1, 0, +-inf}."""
    if premult is not None:
        x = x * premult
    p = _t(p, x)
    xp = torch.abs(x)
    xs = xp / torch.clamp(torch.abs(p - 1), min=F32_TINY)
    p_safe = clip_finite_nograd(remove_zero(p))
    y = safe_sign(x) * select(
        [
            (p == 1, xp),
            (p == 0, safe_log1p(xp)),
            (p == -float("inf"), -safe_expm1(-xp)),
            (p == float("inf"), safe_expm1(xp)),
        ],
        clip_finite_nograd(torch.abs(p_safe - 1) / p_safe * ((xs + 1) ** p_safe - 1)),
    )
    if postmult is not None:
        y = y * postmult
    return y


def power_ladder_max_output(p):
    """Limit of power_ladder(x, p) as x -> inf."""
    p = _t(p)
    return select([(p == -float("inf"), 1.0), (p >= 0, float("inf"))], safe_div(p - 1, p))


def inv_power_ladder(y, p, premult=None, postmult=None):
    """Exact inverse of power_ladder."""
    if postmult is not None:
        y = y / postmult
    p = _t(p, y)
    yp = torch.abs(y)
    p_safe = clip_finite_nograd(remove_zero(p))
    y_max = minus_eps(power_ladder_max_output(p))
    yp = override_gradient(torch.maximum(torch.minimum(yp, y_max), -y_max), yp)
    x = safe_sign(y) * select(
        [
            (p == 1, yp),
            (p == 0, safe_expm1(yp)),
            (p == -float("inf"), -safe_log1p(-yp)),
            (p == float("inf"), safe_log1p(yp)),
        ],
        torch.abs(p_safe - 1) * ((safe_div(p_safe, torch.abs(p_safe - 1)) * yp + 1)
                                 ** (1 / p_safe) - 1),
    )
    if premult is not None:
        x = x / premult
    return x


def abs_(x):
    """The gin files' ``math.abs``."""
    return torch.abs(x)


def safe_tanh(x):
    return torch.tanh(x)


def power_3(x, exponent=3.0):
    return torch.pow(torch.abs(x), exponent) * safe_sign(x)


def laplace_cdf(x, beta):
    alpha = 1 / beta
    return alpha * (0.5 + 0.5 * safe_sign(x) * (torch.exp(-torch.abs(x) / beta) - 1))


def scaled_softplus(x, scale=100.0):
    return (1.0 / scale) * torch.logaddexp(scale * x, torch.zeros_like(x))


def sine_plus(x):
    return (torch.sin(x) + 1.0) / 2.0


def approx_erf(x):
    """erf approximation accurate to ~0.007."""
    return torch.sign(x) * torch.sqrt(1 - torch.exp(-(4 / pymath.pi) * x**2))


def learning_rate_decay(step, lr_init, lr_final, max_steps, lr_delay_steps=0, lr_delay_mult=1):
    """Log-linear lr decay with an optional warmup ease-in; a host float.

    Evaluated in float32 like the JAX schedule, so both packages set the same
    learning rate at every step.
    """
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    f32 = np.float32
    step = f32(step)
    if lr_delay_steps > 0:
        delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
            f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps), f32(0), f32(1))
        )
    else:
        delay_rate = f32(1.0)
    t = np.clip(step / f32(max_steps), f32(0), f32(1))
    lv0, lv1 = f32(np.log(lr_init)), f32(np.log(lr_final))
    return float(f32(delay_rate) * np.exp(t * (lv1 - lv0) + lv0, dtype=f32))


def create_learning_rate_decay(**kwargs):
    return functools.partial(learning_rate_decay, **kwargs)


def take_along_last(v, idx):
    """v[..., idx] along the last axis (a gather; same values as the JAX
    one-hot reduction)."""
    return torch.gather(v.expand(idx.shape[:-1] + v.shape[-1:]), -1, idx)


def sorted_lookup(x, xp, fps=()):
    """For each x find its bracketing knots in sorted xp; gather fp values.

    Returns ((idx0, idx1), [(fp0, fp1) for fp in fps]) with
    count = #{n : x >= xp[n]}, idx0 = clip(count - 1, 0, N-1) and
    idx1 = min(count, N-1), exactly as the JAX mask reduction computes them.
    """
    if not isinstance(fps, tuple):
        raise ValueError(f"`fps` must be a tuple, got {type(fps)}.")
    n = xp.shape[-1]
    lead = torch.broadcast_shapes(x.shape[:-1], xp.shape[:-1])
    xp_b = xp.expand(lead + xp.shape[-1:]).contiguous()
    x_b = x.expand(lead + x.shape[-1:]).contiguous()
    count = torch.searchsorted(xp_b, x_b, right=True)
    idx0 = torch.clamp(count - 1, 0, n - 1)
    idx1 = torch.clamp(count, max=n - 1)
    vals = []
    for fp in fps:
        fp_b = fp.expand(lead + fp.shape[-1:])
        vals.append((torch.gather(fp_b, -1, idx0), torch.gather(fp_b, -1, idx1)))
    return (idx0, idx1), vals


def sorted_interp(x, xp, fp, eps=F32_EPS**2):
    """Piecewise-linear interp where xp and fp are sorted along the last axis."""
    (xp0, xp1), (fp0, fp1) = sorted_lookup(x, xp, (xp, fp))[1]
    offset = torch.clamp((x - xp0) / torch.clamp(xp1 - xp0, min=eps), 0, 1)
    return fp0 + offset * (fp1 - fp0)


def searchsorted(a, v):
    """Bracketing indices of v in sorted a (boundary-free searchsorted)."""
    return sorted_lookup(v, a)[0]


def interp(x, xp, fp):
    """np.interp vectorized over leading batch dims."""
    (xp0, xp1), (fp0, fp1) = sorted_lookup(x, xp, (xp, fp))[1]
    denom = xp1 - xp0
    offset = torch.clamp(
        torch.where(torch.abs(denom) < F32_TINY, torch.zeros_like(denom),
                    (x - xp0) / remove_zero(denom)), 0, 1)
    return fp0 + offset * (fp1 - fp0)


def average_across_multisamples(x):
    return torch.mean(x, dim=-2)


def concat_across_multisamples(x):
    """[..., M, F] -> [..., M * F], multisample-major."""
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


class _NanGradToZero(torch.autograd.Function):
    """Identity whose gradient goes through nan_to_num."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.nan_to_num(g)


def nangrad_to_zero(x):
    return _NanGradToZero.apply(x)


def power_iteration(a_mat, n):
    """n rounds of power iteration -> (top eigenvalue, eigenvector)."""
    vec = torch.sum(a_mat, dim=-1) / pymath.sqrt(a_mat.shape[-1])
    val = None
    for i in range(n):
        if i > 0:
            vec = torch.matmul(a_mat, vec[..., None])[..., 0]
        val = torch.sqrt(torch.sum(vec**2, dim=-1))
        vec = vec / val[..., None]
    return val, vec


def cholesky3(a, symmetrize_input=True):
    """Closed-form 3x3 Cholesky factor built from the safe ops."""
    if tuple(a.shape[-2:]) != (3, 3):
        raise ValueError(f"input must be (..., 3, 3), got {tuple(a.shape)}")
    a11, a12, a13, a21, a22, a23, a31, a32, a33 = torch.unbind(
        a.reshape(a.shape[:-2] + (9,)), dim=-1)
    if symmetrize_input:
        a21 = (a12 + a21) / 2
        a31 = (a13 + a31) / 2
        a32 = (a23 + a32) / 2
    l11 = safe_sqrt(a11)
    l21 = safe_div(a21, l11)
    l22 = safe_sqrt(a22 - safe_div(a21, l11) ** 2)
    l31 = safe_div(a31, l11)
    l32 = safe_div(a32 - l31 * l21, l22)
    l33 = safe_sqrt(a33 - safe_div(a31**2, a11) - safe_div(a32 - l31 * l21, l22) ** 2)
    z = torch.zeros_like(a11)
    return torch.stack([l11, z, z, l21, l22, z, l31, l32, l33], dim=-1).reshape(a.shape)


def safe_cholesky(a, symmetrize_input=True):
    """Cholesky factor with NaN gradients zeroed and NaN values replaced
    (the closed form for 3x3 inputs)."""
    a = nangrad_to_zero(a)
    if tuple(a.shape[-2:]) == (3, 3):
        out = cholesky3(a, symmetrize_input=symmetrize_input)
    else:
        if symmetrize_input:
            a = (a + a.transpose(-1, -2)) / 2
        out = torch.linalg.cholesky_ex(a)[0]
    return torch.nan_to_num(out)
