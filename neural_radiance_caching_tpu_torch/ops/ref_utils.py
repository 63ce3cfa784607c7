"""Reflection directions and (integrated) directional encodings (counterpart
of ``ops/ref_utils.py``)."""

from __future__ import annotations

import math as pymath

import numpy as np
import torch

from neural_radiance_caching_tpu_torch.ops import math

_F32_EPS = float(np.finfo(np.float32).eps)
_F32_TINY = float(np.finfo(np.float32).tiny)


def reflect(viewdirs, normals):
    """Reflect v about unit n: u = 2 (n.v) n - v."""
    return 2.0 * torch.sum(normals * viewdirs, dim=-1, keepdim=True) * normals - viewdirs


def l2_normalize(x, grad_eps=_F32_EPS, tiny=_F32_TINY):
    """Unit-normalize with a larger denominator clamp in the backward pass.

    Forward clamps the squared norm at ~1e-38 (value stays unit-norm); the
    gradient path clamps at grad_eps. Zero vectors map to zero.
    """
    grad_eps = max(tiny, grad_eps)
    denom_sq = torch.sum(x**2, dim=-1, keepdim=True)
    val = x / torch.sqrt(torch.clamp(denom_sq, min=tiny))
    grad = x / torch.sqrt(torch.clamp(denom_sq, min=grad_eps))
    out = math.override_gradient(val, grad)
    return torch.where(denom_sq < tiny, torch.zeros_like(out), out)


def _gen_binomial(a, k):
    return np.prod(a - np.arange(k)) / pymath.factorial(k)


def _assoc_legendre_coeff(l, m, k):  # noqa: E741
    return (
        (-1) ** m * 2**l * pymath.factorial(l) / pymath.factorial(k)
        / pymath.factorial(l - k - m) * _gen_binomial(0.5 * (l + k + m - 1.0), l)
    )


def _sph_harm_coeff(l, m, k):  # noqa: E741
    return np.sqrt(
        (2.0 * l + 1.0) * pymath.factorial(l - m) / (4.0 * np.pi * pymath.factorial(l + m))
    ) * _assoc_legendre_coeff(l, m, k)


def _ml_array(deg_view):
    ml = []
    for i in range(deg_view):
        l = 2**i  # noqa: E741
        ml.extend((m, l) for m in range(l + 1))
    return np.array(ml).T


def generate_ide_fn(deg_view):
    """Build the integrated directional encoding for vMF-blurred directions.

    The complex spherical harmonics are evaluated as real and imaginary parts
    of (x + iy)^m, expanded by repeated complex multiplication.
    """
    if deg_view > 5:
        raise ValueError("Only deg_view of at most 5 is numerically stable.")
    ml = _ml_array(deg_view)
    l_max = 2 ** (deg_view - 1)
    mat = np.zeros((l_max + 1, ml.shape[1]))
    for i, (m, l) in enumerate(ml.T):  # noqa: E741
        for k in range(l - m + 1):
            mat[k, i] = _sph_harm_coeff(l, m, k)
    mat = mat.astype(np.float32)
    sigma = (0.5 * ml[1, :] * (ml[1, :] + 1)).astype(np.float32)
    m_list = ml[0, :].tolist()

    def ide_fn(xyz, kappa_inv):
        """xyz: [..., 3] directions; kappa_inv: [..., 1] 1/vMF-concentration."""
        x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
        vmz = torch.cat([z**i for i in range(mat.shape[0])], dim=-1)
        # Powers (x + iy)^m for m = 0..max(m), as (real, imag) pairs.
        re_pows, im_pows = [torch.ones_like(x)], [torch.zeros_like(x)]
        for _ in range(max(m_list)):
            re, im = re_pows[-1], im_pows[-1]
            re_pows.append(re * x - im * y)
            im_pows.append(re * y + im * x)
        vmxy_re = torch.cat([re_pows[m] for m in m_list], dim=-1)
        vmxy_im = torch.cat([im_pows[m] for m in m_list], dim=-1)
        legendre = torch.matmul(vmz, torch.as_tensor(mat, device=xyz.device, dtype=vmz.dtype))
        atten = torch.exp(-torch.as_tensor(sigma, device=xyz.device) * kappa_inv)
        return torch.cat([vmxy_re * legendre * atten, vmxy_im * legendre * atten], dim=-1)

    return ide_fn


def generate_dir_enc_fn(deg_view):
    """Directional encoding = IDE at zero concentration spread."""
    ide_fn = generate_ide_fn(deg_view)
    return lambda xyz: ide_fn(xyz, torch.zeros_like(xyz[..., :1]))
