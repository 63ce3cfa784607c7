"""Coordinate contractions, ray warps, Gaussian tracking, the unscented
transform and positional encodings (counterpart of ``ops/coord.py``).

``track_linearize`` and ``track_isotropic`` push Gaussians through a warp with
the warp's Jacobian at the means. JAX takes it with ``jax.linearize``; here
the Jacobians of the contractions are written out (``_WARP_JACOBIANS``),
including the derivative convention of ``maximum`` at ties (0.5 to each
side), and any other pointwise warp is differentiated by autograd, one
reverse pass per output coordinate, with the graph kept where the means
carry one (so a loss can differentiate through the Jacobian).

``unscented_transform`` builds sigma points from every basis of the JAX
function. ``random_N`` draws a fixed noise on every call, as JAX draws from
``PRNGKey(0)``: the normal draw of ``torchutil.normal`` from a generator
seeded with 0 on the CPU.
"""

from __future__ import annotations

import math as pymath

import torch

import numpy as np

from neural_radiance_caching_tpu_torch.ops import geopoly, math
from neural_radiance_caching_tpu_torch.utils import torchutil


def contract(x):
    """mip-NeRF 360 spherical contraction (Eq. 10 of arxiv/2111.12077)."""
    x_mag_sq = torch.clamp(torch.sum(x**2, dim=-1, keepdim=True), min=1)
    scale = (2 * torch.sqrt(x_mag_sq) - 1) / x_mag_sq
    return scale * x


def inv_contract(z, eps=1e-8):
    """The inverse of contract()."""
    z_mag_sq = torch.clamp(torch.sum(z**2, dim=-1, keepdim=True), min=1)
    inv_scale = torch.clamp(2 * torch.sqrt(z_mag_sq) - z_mag_sq, min=eps)
    return z / inv_scale


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


def contract3_isoscale(x):
    """Isotropic scale of contract()'s Jacobian for 3D inputs."""
    if x.shape[-1] != 3:
        raise ValueError(f"Inputs must be 3D, are {x.shape[-1]}D.")
    norm_sq = torch.clamp(torch.sum(x**2, dim=-1), min=1)
    return torch.exp(2 / 3 * torch.log(2 * torch.sqrt(norm_sq) - 1) - torch.log(norm_sq))


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


def warp_jacobian(fn, x):
    """d fn(x) / dx as [..., D_out, D_in] for a warp that acts on each point
    (the last axis) alone: written out for the contractions, else one
    autograd pass per output coordinate. The Jacobian keeps a graph to `x`
    where `x` has one and gradients are on."""
    if fn in _WARP_JACOBIANS:
        return _WARP_JACOBIANS[fn](x)
    keep = torch.is_grad_enabled() and x.requires_grad
    with torch.enable_grad():
        xg = x if keep else x.detach().requires_grad_(True)
        y = fn(xg)
        rows = [torch.autograd.grad(y[..., i].sum(), xg, create_graph=keep, retain_graph=True)[0]
                for i in range(y.shape[-1])]
    jac = torch.stack(rows, dim=-2)
    return jac if keep else jac.detach()


def track_linearize(fn, mean, cov):
    """Push a Gaussian through fn by linearization: cov' = J cov J^T."""
    if (len(mean.shape) + 1) != len(cov.shape):
        raise ValueError("cov must be non-diagonal")
    jac = warp_jacobian(fn, mean)
    return fn(mean), jac @ cov @ jac.transpose(-1, -2)


def track_isotropic(fn, mean, scale):
    """Isotropic variant: scale' = scale * |det J|^(1/d)."""
    if tuple(mean.shape[:-1]) != tuple(scale.shape):
        raise ValueError(f"mean {tuple(mean.shape)}[:-1] != scale {tuple(scale.shape)}.")
    d = mean.shape[-1]
    abs_det = torch.clamp(torch.abs(torch.linalg.det(warp_jacobian(fn, mean))),
                          min=math.F32_TINY)
    return fn(mean), scale * abs_det ** (1 / d)


def isotropize(cov, mode="accurate"):
    """Replace covariances with isotropic ones of equal determinant."""
    d = cov.shape[-1]
    if d == 1:
        return cov
    if mode == "fast":
        det = torch.linalg.det(cov)
        diag_val = det ** (1 / d)
        invalid = (det <= math.F32_TINY) | ~torch.isfinite(det)
    elif mode == "accurate":
        log_det = torch.linalg.slogdet(cov)[1]
        diag_val = torch.exp(log_det / d)
        invalid = ~torch.isfinite(log_det)
    else:
        raise ValueError(f"mode={mode} not implemented.")
    cov_iso = torch.eye(d, dtype=cov.dtype, device=cov.device) * diag_val[..., None, None]
    return torch.where(invalid[..., None, None], torch.zeros_like(cov), cov_iso)


_F32_EPS = float(np.finfo(np.float32).eps)


def piecewise_warp_fwd(x, eps=_F32_EPS):
    """Linear in [0, 1], 1 - 0.5 / x beyond (allows t_near = 0)."""
    return torch.where(x < 1, 0.5 * x, 1 - 0.5 / torch.clamp(x, min=eps))


def piecewise_warp_inv(x, eps=_F32_EPS):
    return torch.where(x < 0.5, 2 * x, 0.5 / torch.clamp(1 - x, min=eps))


# A named warp's inverse, picked by the function's name as JAX picks it.
_INVERSE_BY_NAME = {
    "reciprocal": torch.reciprocal,
    "log": torch.exp,
    "exp": torch.log,
    "sqrt": torch.square,
    "square": torch.sqrt,
}


def construct_ray_warps(fn, t_near, t_far, *, fn_inv=None):
    """Bijection between metric distance t and normalized distance s in [0, 1].

    fn may be None (identity), 'piecewise', or a callable with a supplied
    inverse or one of the names of ``_INVERSE_BY_NAME``.
    """
    if fn is None:
        fn_fwd = lambda x: x
        fn_inv = lambda x: x
    elif isinstance(fn, str):
        if fn != "piecewise":
            raise ValueError(f"Unknown ray warp {fn!r}")
        fn_fwd, fn_inv = piecewise_warp_fwd, piecewise_warp_inv
    else:
        fn_fwd = fn
        if fn_inv is None:
            name = getattr(fn, "__name__", None)
            if name not in _INVERSE_BY_NAME:
                raise KeyError(f"no inverse known for the ray warp {name!r}; supply fn_inv")
            fn_inv = _INVERSE_BY_NAME[name]
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


def sqrtm(mat):
    """Matrix square root of a PSD matrix via its eigendecomposition."""
    eigval, eigvec = torch.linalg.eigh(mat)
    return torch.matmul(eigvec * math.safe_sqrt(eigval)[..., None, :], eigvec.transpose(-2, -1))


def construct_perp_basis(directions):
    """Two unit vectors perpendicular to each direction."""
    if directions.shape[-1] != 3:
        raise ValueError(f"directions must be 3D, got {directions.shape[-1]}D")

    def cross(v):
        v = torch.as_tensor(v, dtype=directions.dtype, device=directions.device)
        return torch.linalg.cross(directions, v.expand(directions.shape), dim=-1)

    cross1a = cross([0.0, 0.0, 1.0])
    cross1b = cross([1.0, 1.0, 1.0])
    use_b = torch.all(torch.abs(cross1a) < _F32_EPS, dim=-1)
    cross1 = torch.where(use_b[..., None], cross1b, cross1a)
    cross2 = torch.linalg.cross(directions, cross1, dim=-1)
    unit = lambda z: z / torch.sqrt(torch.sum(z**2, dim=-1, keepdim=True))
    return unit(cross1), unit(cross2)


_HEX_THETAS = (np.pi / 3) * np.array([0, 2, 4, 3, 5, 1])
# The control points' distance factors along each interval (float64, then
# float32 as the JAX package rounds them).
_HEX_OFFSETS = (3 / np.sqrt(7)) * (np.arange(6) * (2 / 5) - 1)


def hexify(rng, *, origins, directions, radii, tdist):
    """Hexagonal multisample pattern over each ray interval: control points
    [..., S, 6, 3] and their perpendicular magnitude [..., S, 6]. With a
    generator each interval's pattern is flipped by a fair coin and turned
    by a uniform angle (a uniform draw, then another, as JAX's bernoulli
    and uniform); without one the flips alternate."""
    dev, dt = tdist.device, tdist.dtype
    sz = tuple(tdist.shape[:-1]) + (tdist.shape[-1] - 1, len(_HEX_THETAS))
    thetas = torch.as_tensor(_HEX_THETAS, dtype=dt, device=dev).expand(sz)
    if rng is not None:
        flip = torchutil.uniform(rng, sz[:-1], dev) < 0.5
        thetas = torch.where(flip[..., None], thetas.flip(-1), thetas)
        thetas = thetas + (2 * np.pi) * torchutil.uniform(rng, sz[:-1], dev, dt)[..., None]
    else:
        flip = torch.arange(sz[-2], device=dev) % 2
        thetas = torch.where(flip[..., None].bool(), thetas.flip(-1), thetas)
        thetas = thetas + (flip * np.pi / 6)[..., None].to(dt)

    perp_axis1, perp_axis2 = construct_perp_basis(directions)
    t0, t1 = tdist[..., :-1], tdist[..., 1:]
    s = (t0 + t1) / 2
    d = (t1 - t0) / 2
    offsets = torch.as_tensor(_HEX_OFFSETS, dtype=dt, device=dev)
    cz = t0[..., None] + math.safe_div(d, (d**2 + 3 * s**2))[..., None] * (
        (t1**2 + 2 * s**2)[..., None]
        + offsets * math.safe_sqrt(((d**2 - s**2) ** 2 + 4 * s**4))[..., None])
    perp_mag = pymath.sqrt(0.5) * radii[..., None, :] * cz
    cx = perp_mag * torch.cos(thetas)
    cy = perp_mag * torch.sin(thetas)
    control = (origins[..., None, None, :]
               + perp_axis1[..., None, None, :] * cx[..., None]
               + perp_axis2[..., None, None, :] * cy[..., None]
               + directions[..., None, None, :] * cz[..., None])
    return control, perp_mag


def _random_noise(cov, num, batch_shape):
    """JAX's multivariate_normal(PRNGKey(0), 0, cov, (num,) + batch): the
    Cholesky factor of cov times a standard normal draw that is the same on
    every call (a CPU generator seeded with 0)."""
    d = cov.shape[-1]
    z = torchutil.normal(torch.Generator().manual_seed(0), (num,) + tuple(batch_shape) + (d,),
                         cov.device, cov.dtype)
    factor, info = torch.linalg.cholesky_ex(cov)
    # A factorization that fails is NaN, as JAX's (the caller zeroes it).
    factor = torch.where((info != 0)[..., None, None], torch.full_like(factor, float("nan")),
                         factor)
    return torch.einsum("...ij,...j->...i", factor, z)


def unscented_transform(mean, cov, basis, sqrt_fn="sqrtm", axis=0):
    """Sigma points along `axis` from each (mean, cov)."""
    d = cov.shape[-1]
    mean_ex = torch.unsqueeze(mean, axis)

    if basis == "mean":
        return mean_ex

    if basis.startswith("random_"):
        num_random = int(basis.split("_")[-1])
        noise = _random_noise(cov, num_random, mean.shape[:-1])
        return mean_ex + torch.movedim(torch.nan_to_num(noise), 0, axis)

    if basis.startswith("poweriter_"):
        num_iters = int(basis.split("_")[-1])
        val, vec = math.power_iteration(cov, num_iters)
        signs = torch.as_tensor([-1.0, 1.0], dtype=mean.dtype, device=mean.device)
        offsets = (torch.sqrt(val)[..., None] * signs)[..., None]
        return mean_ex + torch.movedim(offsets * vec[..., None, :], -2, axis)

    if sqrt_fn == "sqrtm":
        sqrtm_cov = sqrtm(cov)
    elif sqrt_fn == "cholesky":
        sqrtm_cov = math.safe_cholesky(cov, symmetrize_input=False)
    else:
        raise ValueError(f"sqrt_fn={sqrt_fn} not implemented.")

    if any(basis.startswith(x) for x in ("tetrahedron", "icosahedron", "octahedron")):
        if d != 3:
            raise ValueError(f"Input is {d}D; polyhedra are only defined for 3D.")
        base_shape, tess = basis.split("_")
        transform = geopoly.generate_basis(base_shape, int(tess), remove_symmetries=False).T
        transform1 = np.concatenate([np.zeros((d, 1)), transform], axis=-1)
        transform1 /= np.sqrt(np.mean(transform1**2, axis=1))[:, None]
        t1 = torch.as_tensor(transform1, dtype=mean.dtype, device=mean.device)
        return mean_ex + torch.movedim(torch.matmul(sqrtm_cov, t1), -1, axis)

    if basis == "julier":
        offsets = pymath.sqrt(d + 0.5) * torch.movedim(sqrtm_cov, -1, axis)
        return torch.cat([mean_ex, mean_ex + offsets, mean_ex - offsets], dim=axis)

    if basis == "menegaz":
        if d == 3:
            sqrtm_cov_sum = torch.sum(sqrtm_cov, dim=-1, keepdim=True)
            offsets = torch.cat([-sqrtm_cov_sum, 2 * sqrtm_cov - sqrtm_cov_sum / 3], dim=-1)
            return mean_ex + torch.movedim(offsets, -1, axis)
        transform = np.sqrt(d + 1) * np.eye(d) + (1 - np.sqrt(d + 1)) / d
        transform1 = np.concatenate([-np.ones((d, 1)), transform], axis=-1)
        t1 = torch.as_tensor(transform1, dtype=mean.dtype, device=mean.device)
        return mean_ex + torch.movedim(torch.matmul(sqrtm_cov, t1), -1, axis)

    raise ValueError(f"basis={basis} not implemented.")


def compute_control_points(
    means, covs, rays, tdist, rng, unscented_mip_basis, unscented_sqrt_fn, unscented_scale_mult
):
    """Multisample control points for grid encoders: (control [..., S, M, 3],
    perp_mag [..., S, M] or None)."""
    if unscented_mip_basis == "hexify":
        return hexify(rng, origins=rays.origins, directions=rays.directions, radii=rays.radii,
                      tdist=tdist)
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
