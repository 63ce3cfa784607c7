"""Coordinate contractions, ray warps and positional encodings (counterpart
of ``ops/coord.py``).

``track_linearize`` pushes Gaussians through a warp with the warp's Jacobian.
JAX takes it with ``jax.linearize``; here the Jacobians of the contractions
are written out (``_WARP_JACOBIANS``), including the derivative convention of
``maximum`` at ties (0.5 to each side), so the covariances match.
"""

from __future__ import annotations

import math as pymath

import torch

from neural_radiance_caching_tpu_torch.ops import math


def contract(x):
    """mip-NeRF 360 spherical contraction (Eq. 10 of arxiv/2111.12077)."""
    x_mag_sq = torch.clamp(torch.sum(x**2, dim=-1, keepdim=True), min=1)
    scale = (2 * torch.sqrt(x_mag_sq) - 1) / x_mag_sq
    return scale * x


def contract_radius_2(x):
    return contract(x / 2.0)


def contract_cube(x):
    """L-infinity analogue of contract(): squashes space into a cube."""
    x_max = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True), min=1)
    scale = (2 * x_max - 1) / x_max**2
    return scale * x


def contract_projective(x):
    """MERF-style projective contraction."""
    x_abs = torch.abs(x)
    x_max = torch.clamp(torch.amax(x_abs, dim=-1, keepdim=True), min=1)
    x_max = (x_max + 1) / 2.0
    scale = 1 / x_max
    z = scale * x
    idx = torch.argmax(x_abs, dim=-1, keepdim=True)
    negative = torch.gather(z, -1, idx) < 0
    o = torch.where(negative, -2 + scale, 2 - scale)
    ival = torch.arange(x.shape[-1], device=x.device).reshape([1] * (x.dim() - 1) + [-1])
    return torch.where(x_max <= 1, x, torch.where(ival == idx, o, z))


# The gin files' per-scale wrappers.
def contract_constant(x, c=7.0):
    return x / c


def contract_constant_1(x, c=1.0):
    return x / c


def contract_radius_5(x):
    return contract(x / 5.0)


def contract_radius_1_2(x):
    return contract(x / 0.5)


def contract_radius_1_4(x):
    return contract(x / 0.25)


def contract_cube_5(x):
    return contract_cube(x / 5.0)


def contract_cube_2(x):
    return contract_cube(x / 2.0)


def contract_cube_1_2(x):
    # Divides by 0.25, as the JAX function does.
    return contract_cube(x / 0.25)


def contract_cube_1_4(x):
    return contract_cube(x / 0.25)


def _contract_jacobian(x):
    """d contract(x) / dx as [..., 3, 3]."""
    m = torch.sum(x**2, dim=-1, keepdim=True)
    m_c = torch.clamp(m, min=1)
    # d max(1, m) / dm: 1 outside the unit ball, 0 inside, 0.5 on it.
    gate = torch.where(m > 1, 1.0, torch.where(m == 1, 0.5, 0.0)).to(x.dtype)
    scale = (2 * torch.sqrt(m_c) - 1) / m_c
    dscale_dm = (1 - torch.sqrt(m_c)) / m_c**2 * gate
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    return scale[..., None] * eye + 2 * dscale_dm[..., None] * x[..., :, None] * x[..., None, :]


_WARP_JACOBIANS = {
    contract: _contract_jacobian,
    contract_radius_2: lambda x: _contract_jacobian(x / 2.0) / 2.0,
}


def track_linearize(fn, mean, cov):
    """Push a Gaussian through fn by linearization: cov' = J cov J^T."""
    if (len(mean.shape) + 1) != len(cov.shape):
        raise ValueError("cov must be non-diagonal")
    if fn not in _WARP_JACOBIANS:
        raise NotImplementedError(f"No Jacobian registered for warp {fn!r}")
    jac = _WARP_JACOBIANS[fn](mean)
    return fn(mean), jac @ cov @ jac.transpose(-1, -2)


def construct_ray_warps(fn, t_near, t_far, *, fn_inv=None):
    """Bijection between metric distance t and normalized distance s in [0, 1]."""
    if fn is None:
        fn_fwd = lambda x: x
        fn_inv = lambda x: x
    else:
        if fn_inv is None:
            raise NotImplementedError("Only warps with a supplied inverse are ported.")
        fn_fwd = fn
    s_near, s_far = [fn_fwd(x) for x in (t_near, t_far)]
    t_to_s = lambda t: (fn_fwd(t) - s_near) / (s_far - s_near)
    s_to_t = lambda s: fn_inv(s * s_far + (1 - s) * s_near)
    return t_to_s, s_to_t


def expected_sin(mean, var):
    """E[sin(x)] for x ~ N(mean, var)."""
    return torch.exp(-0.5 * var) * math.safe_sin(mean)


def integrated_pos_enc(mean, var, min_deg, max_deg, dtype=None):
    """IPE: expected sinusoids of a Gaussian at scales 2^[min_deg, max_deg).

    dtype: optional compute/output dtype (bfloat16 for the bf16 trunks), applied
    before the frequency lift as in the JAX package.
    """
    if dtype is not None:
        mean = mean.to(dtype)
        var = var.to(dtype)
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=mean.dtype, device=mean.device)
    shape = mean.shape[:-1] + (-1,)
    scaled_mean = torch.reshape(mean[..., None, :] * scales[:, None], shape)
    scaled_var = torch.reshape(var[..., None, :] * scales[:, None] ** 2, shape)
    return expected_sin(
        torch.cat([scaled_mean, scaled_mean + 0.5 * pymath.pi], dim=-1),
        torch.cat([scaled_var] * 2, dim=-1),
    )


def pos_enc(x, min_deg, max_deg, append_identity=True):
    """Classic NeRF positional encoding."""
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=x.dtype, device=x.device)
    shape = x.shape[:-1] + (-1,)
    scaled_x = torch.reshape(x[..., None, :] * scales[:, None], shape)
    four_feat = torch.sin(torch.cat([scaled_x, scaled_x + 0.5 * pymath.pi], dim=-1))
    if append_identity:
        return torch.cat([x, four_feat], dim=-1)
    return four_feat


def lift_and_diagonalize(mean, cov, basis):
    """Project mean/cov onto a direction basis, keep diagonal variances."""
    fn_mean = torch.matmul(mean, basis)
    fn_cov_diag = torch.sum(basis * torch.matmul(cov, basis), dim=-2)
    return fn_mean, fn_cov_diag


def unscented_transform(mean, cov, basis, sqrt_fn="sqrtm", axis=0):
    """Sigma points along `axis`; the slice uses the single-point 'mean' basis."""
    del cov, sqrt_fn
    if basis != "mean":
        raise NotImplementedError(f"unscented basis {basis!r} is not ported yet")
    return torch.unsqueeze(mean, axis)


def compute_control_points(
    means, covs, rays, tdist, rng, unscented_mip_basis, unscented_sqrt_fn, unscented_scale_mult
):
    """Multisample control points for grid encoders."""
    del tdist, rng
    control = unscented_transform(
        means, covs, basis=unscented_mip_basis, sqrt_fn=unscented_sqrt_fn, axis=-2
    )
    if unscented_scale_mult > 0:
        if rays is None:
            raise ValueError("Rays required when unscented_scale_mult > 0.")
        t_recon = torch.sum(
            (control - rays.origins[..., None, None, :]) * rays.directions[..., None, None, :],
            dim=-1,
        )
        perp_mag = pymath.sqrt(0.5) * rays.radii[..., None, :] * t_recon
    else:
        perp_mag = None
    return control, perp_mag
