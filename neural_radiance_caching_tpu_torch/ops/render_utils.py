"""Secondary-ray machinery of the material stage (counterpart of the part of
``ops/render_utils.py`` the steady material path reaches).

Local shading frames, the 2D uniform generator, the cosine, uniform and GGX
importance samplers with the power-heuristic MIS weights, the active-light
sampler (the direction toward the light), vMF mixture evaluation, sampling
and filtering with the learned-light sampler, the unbiased vMF-mixture fit
of the light-sampling loss (``vmf_loss_fn``), the Disney-ish microfacet
lobe, the secondary-ray fan-out at surface points, the Monte-Carlo
reflection estimators (steady, and time-binned for the transient material
shader), the transient causality mask ``zero_invalid_bins`` and the iToF
projection of transients ``dtof_to_itof``; the samplers over a known
environment map (``EnvironmentSampler`` from its pmf,
``QuadratureEnvmapSampler`` on a fixed texel grid) and the env map's
radiance along rays (``get_environment_color``); the probe's sphere of
directions (``get_sphere_directions``). Identity, mirror and visible-normal
samplers, structured light and the Gaussian-pyramid projection of
transients are not ported yet.

Every random number comes from ``utils/torchutil`` (``uniform``, ``normal``,
``categorical``), in the order the JAX package draws its keys.
"""

from __future__ import annotations

import dataclasses
import math as pymath
import types

import numpy as np
import torch

from neural_radiance_caching_tpu_torch.ops import image
from neural_radiance_caching_tpu_torch.ops import math as math_utils
from neural_radiance_caching_tpu_torch.ops import ref_utils
from neural_radiance_caching_tpu_torch.utils import torchutil

DENOMINATOR_EPS = 1e-5
_F32_EPS = float(np.finfo(np.float32).eps)


# --- frames ------------------------------------------------------------------


def get_rotation_matrix(normal):
    """Rotation matrix mapping local +z to `normal` (columns are the frame)."""
    z = torch.tensor([0.0, 0.0, 1.0], dtype=normal.dtype, device=normal.device)
    y = torch.tensor([0.0, 1.0, 0.0], dtype=normal.dtype, device=normal.device)
    up = torch.where(torch.abs(normal[..., 2:3]) < 0.9, z, y)
    new_x = torch.linalg.cross(up, normal, dim=-1)
    new_x = new_x / (torch.linalg.norm(new_x, dim=-1, keepdim=True) + 1e-10)
    new_y = torch.linalg.cross(normal, new_x, dim=-1)
    new_y = new_y / (torch.linalg.norm(new_y, dim=-1, keepdim=True) + 1e-10)
    return torch.stack([new_x, new_y, normal], dim=-1)


def global_to_local(directions, rot):
    return (directions[..., 0:1] * rot[..., 0, :] + directions[..., 1:2] * rot[..., 1, :]
            + directions[..., 2:3] * rot[..., 2, :])


def local_to_global(directions, rot):
    return (directions[..., 0:1] * rot[..., 0] + directions[..., 1:2] * rot[..., 1]
            + directions[..., 2:3] * rot[..., 2])


def get_sphere_directions(height, width, flip=False, device="cpu"):
    """Equirectangular directions of the trainer's probe (float32 tensors):
    (theta [H*W], phi [H*W], xyz [H*W, 3], the pixel's dtheta * dphi). The
    azimuth phi runs from pi to -pi over the columns, the polar angle theta
    over the rows, both at pixel centres; `flip` puts the pole on -x
    instead of +z."""
    phi = (torch.linspace(np.pi, -np.pi, width + 1, device=device)[:-1]
           - 2.0 * np.pi / (2.0 * width))
    theta = torch.linspace(0.0, np.pi, height + 1, device=device)[:-1] + np.pi / (2.0 * height)
    theta, phi = torch.meshgrid(theta, phi, indexing="ij")
    theta, phi = theta.flatten(), phi.flatten()
    dtheta_dphi = (2.0 * np.pi / width) * (np.pi / height)
    if flip:
        xyz = torch.stack([-torch.cos(theta), torch.sin(theta) * torch.cos(phi),
                           torch.sin(theta) * torch.sin(phi)], dim=-1)
    else:
        xyz = torch.stack([torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi),
                           torch.cos(theta)], dim=-1)
    return theta, phi, xyz, dtheta_dphi


# --- 2D sample generator -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RandomGenerator2D:
    """Uniform samples in [0, 1)^2 (the stratified variant is not ported)."""

    h_blocks: int = 1
    w_blocks: int = 1
    stratified: bool = False

    def __post_init__(self):
        if self.stratified:
            raise NotImplementedError("stratified 2D samples are not ported yet")

    def sample(self, rng, n, device):
        """(uh, uw), each [n]: the two columns of one [n, 2] uniform draw."""
        u = torchutil.uniform(rng, (n, 2), device)
        return u[..., 0], u[..., 1]


# --- importance samplers -----------------------------------------------------
#
# Each sampler maps 2D uniforms (u1, u2) to directions in the local shading
# frame (+z = normal) unless global_dirs, plus a pdf; `pdf()` evaluates the
# density of arbitrary directions for MIS.


class UniformHemisphereSampler:
    global_dirs = False
    return_rgb = False

    def sample_directions(self, rng, u1, u2, wo, alpha, light_idx, kwargs):
        costheta = 1.0 - u1
        sintheta = torch.sqrt((2.0 - u1) * u1)
        phi = u2 * 2.0 * pymath.pi - pymath.pi
        wi = torch.stack([sintheta * torch.cos(phi), sintheta * torch.sin(phi), costheta], dim=-1)
        return wi, torch.full_like(phi, 1 / (2.0 * pymath.pi))

    def pdf(self, wo, wi, alpha, kwargs):
        pdf = torch.full_like(wi[..., 2], 1 / (2.0 * pymath.pi))
        return torch.clamp(torch.where(wi[..., 2] < 0, 0.0, pdf), min=0.0)


class CosineSampler:
    global_dirs = False
    return_rgb = False

    def sample_directions(self, rng, u1, u2, wo, alpha, light_idx, kwargs):
        r = torch.sqrt(u1)
        phi = u2 * 2.0 * pymath.pi - pymath.pi
        wi_x = r * torch.cos(phi)
        wi_y = r * torch.sin(phi)
        wi_z = torch.sqrt(torch.clamp(1.0 - wi_x**2 - wi_y**2, min=DENOMINATOR_EPS))
        return torch.stack([wi_x, wi_y, wi_z], dim=-1), torch.clamp(wi_z / pymath.pi, min=0.0)

    def pdf(self, wo, wi, alpha, kwargs):
        pdf = wi[..., 2] / pymath.pi
        return torch.clamp(torch.where(wi[..., 2] < 0, 0.0, pdf), min=0.0)


def GGX_D(costheta, a):  # noqa: N802
    """Trowbridge-Reitz normal distribution."""
    return a**2 / torch.clamp(pymath.pi * ((costheta**2 * (a**2 - 1.0) + 1.0)) ** 2,
                              min=_F32_EPS)


class MicrofacetSampler:
    """GGX half-vector importance sampler (normal-distribution sampling)."""

    global_dirs = False
    return_rgb = False

    def __init__(self, sample_visible=False):
        if sample_visible:
            raise NotImplementedError("visible-normal GGX sampling is not ported yet")

    def sample_normals(self, u1, u2, alpha):
        tantheta2 = alpha**2 * u1 / torch.clamp(1.0 - u1, min=_F32_EPS)
        costheta = 1.0 / torch.sqrt(torch.clamp(1.0 + tantheta2, min=_F32_EPS))
        sintheta = torch.sqrt(torch.clamp(1.0 - costheta**2, min=DENOMINATOR_EPS))
        phi = u2 * 2.0 * pymath.pi - pymath.pi
        n = torch.stack([sintheta * torch.cos(phi), sintheta * torch.sin(phi), costheta], dim=-1)
        pdf = GGX_D(costheta, alpha) * torch.abs(costheta)
        return n, torch.clamp(pdf, min=0.0)

    def sample_directions(self, rng, u1, u2, wo, alpha, light_idx, kwargs):
        normals, normal_pdf = self.sample_normals(u1, u2, alpha[..., 0])
        wo_dot_n = torch.sum(wo * normals, dim=-1)
        directions = 2.0 * wo_dot_n[..., None] * normals - wo
        pdf = normal_pdf * (1.0 / torch.clamp(4.0 * wo_dot_n, min=_F32_EPS))
        pdf = torch.where(wo_dot_n <= 0.0, 0.0, pdf)
        return math_utils.normalize(directions), torch.clamp(pdf, min=0.0)

    def pdf(self, wo, wi, alpha, kwargs):
        normals = math_utils.normalize(wo + wi)
        wo_dot_n = torch.sum(wo * normals, dim=-1)
        jac = 1.0 / torch.clamp(4.0 * wo_dot_n, min=_F32_EPS)
        pdf = GGX_D(normals[..., 2], alpha[..., 0]) * torch.abs(normals[..., 2]) * jac
        pdf = torch.where(wo_dot_n <= 0.0, 0.0, pdf)
        return torch.clamp(pdf, min=0.0)


# --- vMF mixtures -------------------------------------------------------------


def eval_vmf(x, means, kappa):
    """von Mises-Fisher density at directions x."""
    vals = kappa * math_utils.safe_exp(kappa * torch.sum(x * means, dim=-1)) / (
        4 * pymath.pi * torch.sinh(kappa))
    return torch.where(kappa <= _F32_EPS, torch.ones_like(vals) / (4.0 * pymath.pi), vals)


def sample_vmf_vars(rng, vmf_vars, x):
    """One mixture component per row of x: (means [N, 3], kappas [N], logits)."""
    latents = torchutil.categorical(rng, vmf_vars[2])
    means = torch.gather(vmf_vars[0], -2, latents[..., None, None].expand(
        latents.shape + (1, vmf_vars[0].shape[-1])))[..., 0, :]
    kappas = torch.gather(vmf_vars[1], -1, latents[..., None])[..., 0]
    return means, kappas, vmf_vars[2]


def filter_vmf_vars(vmf_vars, sample_normals, t1=0.1, t2=0.09):
    """Down-weight lobes pointing below the surface."""
    means, kappas, logits = vmf_vars
    dotprod = (ref_utils.l2_normalize(means, grad_eps=1e-5)
               * sample_normals[..., None, :]).sum(dim=-1)
    new_logits = logits + (dotprod - t2).detach() / (t1 - t2)
    return means, kappas, torch.where(dotprod > t1, logits, new_logits)


def sample_vmf(rng, vmf_vars, x, n_dirs):
    """Sample directions from a vMF mixture (mitsuba vmf.pdf recipe)."""
    mean, kappa, _ = sample_vmf_vars(rng, vmf_vars, x)
    t_vec = torch.stack([-mean[..., 1], mean[..., 0], torch.zeros_like(mean[..., 0])], dim=-1)
    t_vec = ref_utils.l2_normalize(t_vec)
    b_vec = ref_utils.l2_normalize(torch.linalg.cross(mean, t_vec, dim=-1))
    rotmat = torch.stack([t_vec, b_vec, mean], dim=-1)
    v = ref_utils.l2_normalize(torchutil.normal(rng, mean.shape[:-1] + (n_dirs, 2), mean.device))
    tmp = torchutil.uniform(rng, mean.shape[:-1] + (n_dirs,), mean.device)
    k = kappa[..., None]
    w = 1.0 + (1.0 / torch.clamp(k, min=_F32_EPS)) * math_utils.safe_log(
        tmp + (1.0 - tmp) * torch.exp(-2.0 * k))
    s = math_utils.safe_sqrt(1.0 - w**2)
    rand_dirs = torch.stack([s * v[..., 0], s * v[..., 1], w], dim=-1)
    return torch.matmul(rotmat[..., None, :, :], rand_dirs[..., None])[..., 0]


def vmf_loss_fn(vmf_vars, sample_normals, sample_dirs, samples, function_vals,
                function_vals_nocorr, lossmult, linear_to_srgb=True):
    """Unbiased fit of the vMF mixture (means [N, K, 3], kappas and logits
    [N, K, 1]) to the radiance norms of the secondary samples [N, S]:
    mean((f - L) sg(f' - L) w lossmult / max(pdf, 1e-2)), with the sample
    weights clipped to [0, 10] and zeroed below the surface."""
    means = ref_utils.l2_normalize(vmf_vars[0], grad_eps=1e-5)
    kappas = vmf_vars[1][..., 0]
    weights_mix = math_utils.safe_exp(vmf_vars[2][..., 0])
    likelihood = torch.sum(weights_mix[..., None, :] * eval_vmf(
        sample_dirs[..., None, :], means[..., None, :, :], kappas[..., None, :]), dim=-1)
    denominator = torch.clamp(samples["pdf"][..., 0], min=1e-2)
    dotprod = (sample_dirs * sample_normals[..., None, :]).sum(dim=-1)
    weight = torch.clamp(samples["weight"][..., 0], 0.0, 10.0)
    weight = torch.where(dotprod > 0.0, weight, torch.zeros_like(weight))
    if linear_to_srgb:
        function_vals = image.linear_to_srgb(torch.clamp(function_vals, min=1e-5))
        function_vals_nocorr = image.linear_to_srgb(torch.clamp(function_vals_nocorr, min=1e-5))
        likelihood = image.linear_to_srgb(torch.clamp(likelihood, min=1e-5))
    return torch.mean((function_vals - likelihood) * (function_vals_nocorr - likelihood).detach()
                      * weight * lossmult / denominator)


class ActiveSampler:
    """Deterministic sampler pointing at the active light source: the
    world-frame direction from kwargs["origins"] to kwargs["lights"], pdf 1.
    The uniforms it is handed are drawn all the same."""

    global_dirs = True
    return_rgb = False

    def sample_directions(self, rng, u1, u2, wo, alpha, light_idx, kwargs):
        light_offset = kwargs["lights"] - kwargs["origins"]
        light_dists = torch.linalg.norm(light_offset, dim=-1, keepdim=True)
        light_dirs = light_offset / torch.clamp(light_dists, min=1e-5)
        return light_dirs.reshape(wo.shape), torch.ones_like(wo[..., 0])

    def pdf(self, wo, wi, alpha, kwargs):
        return torch.ones_like(wo[..., 0])


class LightSampler:
    """Importance sampler over a learned vMF mixture (LightMLP output)."""

    global_dirs = True
    return_rgb = False

    def _vars(self, kwargs):
        means = ref_utils.l2_normalize(kwargs["vmf_means"], grad_eps=1e-5)
        return means, kwargs["vmf_kappas"][..., 0], kwargs["vmf_logits"][..., 0]

    def _mixture_pdf(self, dirs, means, kappas, logits):
        weights = torch.softmax(logits, dim=-1)
        pdf = torch.sum(weights[..., None, :] * eval_vmf(
            dirs[..., None, :], means[..., None, :, :], kappas[..., None, :]), dim=-1)
        return torch.clamp(pdf, min=0.0)

    def sample_directions(self, rng, u1, u2, wo, alpha, light_idx, kwargs):
        means, kappas, logits = self._vars(kwargs)
        dirs = sample_vmf(rng, (means, kappas, logits), wo, n_dirs=u1.shape[-1])
        return dirs, self._mixture_pdf(dirs, means, kappas, logits)

    def pdf(self, wo, wi, alpha, kwargs):
        return self._mixture_pdf(wi, *self._vars(kwargs))


def _take_along(arr, idx, axis):
    """jnp.take_along_axis: `idx` gathers `arr` along `axis`, the other
    axes broadcast between the two (which have one rank, as JAX requires)."""
    if idx.dim() != arr.dim():
        raise ValueError(f"indices and arr must have the same number of dimensions; "
                         f"{idx.dim()} vs. {arr.dim()}")
    axis = axis % arr.dim()
    shape = torch.broadcast_shapes(
        tuple(1 if d == axis else n for d, n in enumerate(arr.shape)),
        tuple(1 if d == axis else n for d, n in enumerate(idx.shape)))
    arr_shape = list(shape)
    arr_shape[axis] = arr.shape[axis]
    idx_shape = list(shape)
    idx_shape[axis] = idx.shape[axis]
    return torch.gather(arr.expand(arr_shape), axis, idx.long().expand(idx_shape))


def take_along_fill(arr, idx, axis):
    """``_take_along`` in jnp.take_along_axis's default mode "fill": an index
    outside [0, n) gives NaN there (and passes no gradient), as JAX's gather
    does."""
    n = arr.shape[axis]
    out = _take_along(arr, torch.clamp(idx, 0, n - 1), axis)
    valid = (idx >= 0) & (idx < n)
    return torch.where(valid, out, torch.full((), float("nan"), dtype=out.dtype,
                                              device=out.device))


class EnvironmentSampler:
    """Importance sampler over a known environment map (the tables of
    ``data/env_maps``: env_map, env_map_pmf, env_map_pdf, env_map_dirs with
    a texel axis and a light axis): `samples_to_take` texels drawn from the
    pmf (Gumbel-max over ``torchutil.uniform`` noise [..., S, lights,
    texels]) and shared in blocks of consecutive rows, or one draw per
    sample where the count does not divide; each sample's direction, pdf and
    radiance from its ray's light, world-frame and detached."""

    global_dirs = True
    return_rgb = True
    deterministic = False

    def __init__(self, samples_to_take=256):
        self.samples_to_take = samples_to_take

    def sample_directions(self, rng, u1, u2, wo, alpha, light_idx, kwargs):
        num_samples = u1.shape[-1]
        bs = wo.reshape(-1, num_samples, 3).shape[0]
        pmf = kwargs["env_map_pmf"]
        pdf_return = kwargs["env_map_pdf"]
        light_dirs = kwargs["env_map_dirs"]
        light_rgbs = kwargs["env_map"]
        if (bs * num_samples) % self.samples_to_take != 0:
            samples_to_take, reps = bs * num_samples, 1
        else:
            samples_to_take = self.samples_to_take
            reps = bs * num_samples // self.samples_to_take

        # Categorical draws over the texel axis (-2), [..., S, lights].
        logits = math_utils.safe_log(pmf).transpose(-1, -2)
        u = torchutil.uniform(rng, pmf.shape[:-2] + (samples_to_take,) + logits.shape[-2:],
                              pmf.device)
        idx = torch.argmax(logits.unsqueeze(-3) + -torch.log(-torch.log(u)), dim=-1)

        def take3(v):
            x = _take_along(v.detach(), idx[..., None], -3)
            return torch.repeat_interleave(x, reps, dim=0).reshape(u1.shape + (-1, 3))

        dirs, rgbs = take3(light_dirs), take3(light_rgbs)
        pdf = torch.repeat_interleave(_take_along(pdf_return.detach(), idx, -2), reps,
                                      dim=0).reshape(u1.shape + (-1,))
        light_idx = light_idx.reshape(u1.shape[:-1] + (1, 1))
        dirs = _take_along(dirs, light_idx[..., None], -2)[..., 0, :]
        pdf = _take_along(pdf, light_idx, -1)[..., 0]
        rgbs = _take_along(rgbs, light_idx[..., None], -2)[..., 0, :]
        return dirs, pdf, rgbs

    def pdf(self, wo, wi, alpha, kwargs):
        # The pdf of the texel whose direction is nearest (the MIS weight).
        pdf_map = kwargs["env_map_pdf"]
        dirs = kwargs["env_map_dirs"]
        sims = torch.einsum("...c,...nc->...n", wi, dirs[..., 0, :, :])
        idx = torch.argmax(sims, dim=-1)
        return _take_along(pdf_map[..., 0], idx[..., None], -1)[..., 0]


class QuadratureEnvmapSampler:
    """Deterministic quadrature over a known environment map: n texels
    evenly strided over the map (the same for every ray), pdf 1 / (2 pi^2
    sin(theta)), world-frame, with their radiance."""

    global_dirs = True
    return_rgb = True
    deterministic = True

    def sample_directions(self, rng, u1, u2, wo, alpha, light_idx, kwargs):
        dirs = kwargs["env_map_dirs"].detach().reshape(-1, 3)
        rgbs = kwargs["env_map"].detach().reshape(-1, 3)
        total, n = dirs.shape[0], u1.shape[-1]
        idx = torch.round(torch.linspace(0, total - 1, n, device=dirs.device)).long()
        sub_dirs = torch.broadcast_to(dirs[idx], u1.shape + (3,))
        sub_rgbs = torch.broadcast_to(rgbs[idx], u1.shape + (3,))
        sintheta = torch.sqrt(torch.clamp(1.0 - sub_dirs[..., 2] ** 2, min=1e-12))
        pdf = 1.0 / (2.0 * pymath.pi**2 * sintheta)
        return sub_dirs, torch.clamp(pdf, min=0.0), sub_rgbs

    def pdf(self, wo, wi, alpha, kwargs):
        sintheta = torch.sqrt(torch.clamp(1.0 - wi[..., 2] ** 2, min=1e-12))
        return 1.0 / (2.0 * pymath.pi**2 * sintheta)


def _bilerp_2d(img, yx):
    """Bilinear lookup of [H, W, C] at float [N, 2] (y, x), edges clamped."""
    h, w = img.shape[0], img.shape[1]
    y = torch.clamp(yx[..., 0], 0.0, h - 1.0)
    x = torch.clamp(yx[..., 1], 0.0, w - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (y - y0)[..., None]
    wx = (x - x0)[..., None]
    return (img[y0, x0] * (1 - wy) * (1 - wx) + img[y0, x1] * (1 - wy) * wx
            + img[y1, x0] * wy * (1 - wx) + img[y1, x1] * wy * wx)


def get_environment_color(ref_rays, env_map, env_map_w, env_map_h):
    """The env map's radiance along each ray's view direction (equirect,
    bilinear, y up), from the ray's light's map."""
    x = ref_rays.viewdirs[..., 0:1]
    y = ref_rays.viewdirs[..., 1:2]
    z = ref_rays.viewdirs[..., 2:3]
    x, y, z = x, z, -y
    sin_theta = torch.sqrt(x * x + y * y + 1e-8)
    phi = torch.atan2(y / (sin_theta + 1e-8), x / (sin_theta + 1e-8))
    theta = torch.atan2(sin_theta, z)
    phi = ((-phi + pymath.pi) / (2 * pymath.pi)) * env_map_w
    theta = (theta / pymath.pi) * env_map_h
    locations = torch.cat([theta, phi], dim=-1).reshape(-1, 2)
    img = env_map.reshape(env_map_h, env_map_w, -1)
    values = _bilerp_2d(img, locations).reshape(ref_rays.origins.shape[:-1] + (-1, 3))
    return _take_along(values, ref_rays.light_idx[..., None], -2)[..., 0, :]


IMPORTANCE_SAMPLER_BY_NAME = {
    "active": ActiveSampler,
    "environment": EnvironmentSampler,
    "quadrature": QuadratureEnvmapSampler,
    "light": LightSampler,
    "microfacet": MicrofacetSampler,
    "cosine": CosineSampler,
    "uniform": UniformHemisphereSampler,
}


# --- BRDF lobe ----------------------------------------------------------------


def get_lobe(wi, wo, normal, materials, brdf_correction, config):
    """The BRDF times n.l in local coordinates: GGX D*F*G/(4 n.v) specular plus
    Lambertian diffuse, mixed by metalness/diffuseness/mirrorness."""
    if config.shading == "mirror":
        return 1.0
    lobe = 0.0
    if config.shading in ("lambertian", "phong", "blinnphong", "microfacet"):
        lobe = torch.clamp(wi[..., 2:], min=0.0) * materials["albedo"][..., None, :] / pymath.pi
    if config.shading == "phong":
        raise NotImplementedError("phong shading is not ported yet")
    if "microfacet" not in config.shading:
        return lobe

    eps = _F32_EPS
    roughness = materials["roughness"][..., None, :]
    f0 = materials["F_0"][..., None, :]
    albedo = materials["albedo"][..., None, :]
    metalness = materials["metalness"][..., None, :]
    specular_albedo = (materials["specular_albedo"][..., None, :]
                       if config.use_specular_albedo else albedo)
    mirrorness = (materials["mirrorness"][..., None, :] if config.use_mirrorness
                  else torch.ones_like(metalness))
    if config.use_diffuseness:
        diffuseness = materials["diffuseness"][..., None, :]
        if not config.use_mirrorness:
            mirrorness = 1.0 - diffuseness
    else:
        diffuseness = 1.0 - metalness

    f0 = specular_albedo * metalness + f0 * (1.0 - metalness)
    halfdirs = math_utils.normalize(wi + wo)
    n_dot_v = torch.clamp(math_utils.dot(normal, wo), min=0.0)
    n_dot_l = torch.clamp(math_utils.dot(normal, wi), min=0.0)
    n_dot_h = torch.clamp(math_utils.dot(normal, halfdirs), min=0.0)
    l_dot_h = torch.clamp(math_utils.dot(wi, halfdirs), min=0.0)
    a = roughness

    fresnel = f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - l_dot_h, 0.0, 1.0), 5)
    d = GGX_D(n_dot_h, a)
    k = a / 2
    g = (n_dot_v / torch.clamp(n_dot_v * (1.0 - k) + k, min=eps)) * (
        n_dot_l / torch.clamp(n_dot_l * (1.0 - k) + k, min=eps))
    ggx_lobe = d * fresnel * g / torch.clamp(4.0 * n_dot_v, min=eps)
    lambertian_lobe = n_dot_l * albedo / pymath.pi

    if config.shading == "microfacet":
        return (ggx_lobe * brdf_correction[..., 0:1] * mirrorness
                + lambertian_lobe * brdf_correction[..., 1:2] * diffuseness)
    if config.shading == "microfacet_diffuse":
        return lambertian_lobe * brdf_correction[..., 1:2] * diffuseness
    if config.shading == "microfacet_specular":
        return ggx_lobe * brdf_correction[..., 0:1] * mirrorness
    return lobe


# --- MIS sampling -------------------------------------------------------------


def importance_sample_rays(rng, global_viewdirs, normal, material, random_generator_2d=None,
                           use_mis=True, samplers=None, num_secondary_samples=None,
                           light_sampler_results=None):
    """Sample secondary directions from a set of samplers with MIS weights.

    Per sampler: draw its share of the samples and weight them by the power
    heuristic against all samplers. Returns a dict of [N, S, C] tensors.
    """
    rot = get_rotation_matrix(normal)
    local_viewdirs = global_to_local(global_viewdirs, rot)
    roughness = material.get("roughness", torch.ones_like(local_viewdirs))
    light_idx = None
    if light_sampler_results is not None:
        light_idx = light_sampler_results.get("light_idx")
    if light_idx is None:
        light_idx = torch.ones_like(local_viewdirs[..., :1], dtype=torch.int32)

    num_real_samples = sum(count for _, count in samplers)
    if num_real_samples > num_secondary_samples:
        # The JAX path gathers the per-sample view directions past their
        # length there (NaN-filled); it is off every configuration here.
        raise NotImplementedError("resampling more sampler draws than secondary samples "
                                  "is not ported")
    n = local_viewdirs.shape[0]
    lightdirs, pdfs, weights, rgbs = [], [], [], []
    keep_rgb = True
    for sampler, sample_count in samplers:
        real_count = int(round((float(sample_count) / num_real_samples) * num_secondary_samples))
        uh, uw = random_generator_2d.sample(rng, n * real_count, local_viewdirs.device)
        uh, uw = uh.reshape(n, real_count), uw.reshape(n, real_count)
        cur_viewdirs = local_viewdirs[..., None, :].expand(n, real_count, 3)
        cur_roughness = roughness[..., None, :].expand(n, real_count, roughness.shape[-1])
        out = sampler.sample_directions(rng, uh, uw, cur_viewdirs, cur_roughness, light_idx,
                                        light_sampler_results)
        if sampler.return_rgb:
            cur_dirs, cur_pdf, cur_rgb = out
        else:
            (cur_dirs, cur_pdf), cur_rgb = out, None
            keep_rgb = False
        if sampler.global_dirs:
            cur_dirs = global_to_local(cur_dirs, rot[..., None, :, :])

        cur_pdf = torch.clamp(cur_pdf, min=0.0)
        if use_mis and len(samplers) > 1:
            # Power heuristic: w_i ~ (n_i p_i)^2 / sum_j (n_j p_j)^2.
            denominator = 0.0
            for sampler_p, count_p in samplers:
                if sampler_p.global_dirs:
                    vd = local_to_global(cur_viewdirs, rot[..., None, :, :])
                    ld = local_to_global(cur_dirs, rot[..., None, :, :])
                else:
                    vd, ld = cur_viewdirs, cur_dirs
                denominator = denominator + torch.square(
                    sampler_p.pdf(vd, ld, cur_roughness, light_sampler_results) * count_p)
            denominator = torch.clamp(denominator, min=DENOMINATOR_EPS)
            cur_weight = torch.square(sample_count * cur_pdf) / denominator
            cur_weight = cur_weight * (float(num_real_samples) / float(sample_count))
        else:
            cur_weight = torch.ones_like(cur_pdf)
        lightdirs.append(cur_dirs)
        pdfs.append(cur_pdf)
        weights.append(cur_weight)
        rgbs.append(cur_rgb)

    local_lightdirs = torch.cat(lightdirs, dim=-2)
    samples = {
        "local_lightdirs": local_lightdirs,
        "local_viewdirs": local_viewdirs[..., None, :].expand(n, num_secondary_samples, 3),
        "global_lightdirs": local_to_global(local_lightdirs, rot[..., None, :, :]),
        "global_viewdirs": global_viewdirs[..., None, :].expand(n, num_secondary_samples, 3),
        "pdf": torch.cat(pdfs, dim=-1)[..., None].detach(),
        "weight": torch.cat(weights, dim=-1)[..., None].detach(),
    }
    if keep_rgb:
        samples["rgb"] = torch.cat(rgbs, dim=-2).detach()
    return samples


def get_secondary_rays(rng, rays, means, viewdirs, normals, material, normal_eps=1e-2,
                       refdir_eps=1e-2, random_generator_2d=None, use_mis=True, samplers=None,
                       num_secondary_samples=None, light_sampler_results=None,
                       offset_origins=False, far=None):
    """Fan a Rays batch out into [N, S] secondary rays at surface points.

    Origins are offset along the normal; directions come from MIS importance
    sampling. All camera-frame fields are broadcast so the cache sees
    well-formed rays. offset_origins: each ray starts at its near point,
    its near bound then 0. Returns (ref_rays, ref_samples), each [N, S, ...].
    """
    n_sec = num_secondary_samples
    ref_origins = means + (normals * normal_eps).detach()
    ref_origins = ref_origins[..., None, :].expand(ref_origins.shape[:-1] + (n_sec, 3))
    global_viewdirs = -viewdirs[..., None, :] * torch.ones_like(means)
    material = {k: v.reshape(-1, v.shape[-1]) for k, v in material.items()}
    if light_sampler_results is not None and "env_map" not in light_sampler_results:
        light_sampler_results = {k: v.reshape((-1,) + v.shape[-2:])
                                 for k, v in light_sampler_results.items()}
    ref_samples = importance_sample_rays(
        rng, global_viewdirs.reshape(-1, 3), normals.reshape(-1, 3), material,
        random_generator_2d=random_generator_2d, use_mis=use_mis, samplers=samplers,
        num_secondary_samples=n_sec, light_sampler_results=light_sampler_results)

    ones = torch.ones_like(ref_origins[..., :1])

    def bcast(v):
        return (v[..., None, None, :] * torch.ones_like(ref_origins[..., :1]).to(v.dtype)).reshape(
            -1, n_sec, v.shape[-1])

    far_v = rays.far[..., None, None] if far is None else far
    ref_rays = rays.replace(
        near=(refdir_eps * ones).reshape(-1, n_sec, 1),
        far=(far_v * ones).reshape(-1, n_sec, 1),
        cam_idx=bcast(rays.cam_idx), light_idx=bcast(rays.light_idx),
        lights=bcast(rays.lights), imageplane=bcast(rays.imageplane), look=bcast(rays.look),
        up=bcast(rays.up), cam_origins=bcast(rays.cam_origins), vcam_look=bcast(rays.vcam_look),
        vcam_up=bcast(rays.vcam_up), vcam_origins=bcast(rays.vcam_origins),
        origins=ref_origins.reshape(-1, n_sec, 3),
        directions=ref_samples["global_lightdirs"].reshape(-1, n_sec, 3),
        viewdirs=ref_samples["global_lightdirs"].reshape(-1, n_sec, 3),
    )
    ref_rays = ref_rays.replace(radii=torch.ones_like(ref_rays.directions[..., :1]),
                                lossmult=bcast(rays.lossmult))
    if offset_origins:
        ref_rays = ref_rays.replace(origins=ref_rays.origins + ref_rays.directions * ref_rays.near,
                                    near=torch.zeros_like(ref_rays.near))
    ref_samples = {k: v.reshape(-1, n_sec, v.shape[-1]) for k, v in ref_samples.items()}
    return ref_rays, ref_samples


# --- Monte Carlo estimators -----------------------------------------------------


def _shading_config(material_type, use_brdf_correction, use_diffuseness, use_mirrorness,
                    use_specular_albedo):
    return types.SimpleNamespace(
        shading=material_type, use_brdf_correction=use_brdf_correction,
        use_diffuseness=use_diffuseness, use_mirrorness=use_mirrorness,
        use_specular_albedo=use_specular_albedo)


def _lobe_estimates(cfg, material, samples, max_radiance, bins_main=False, bins_mult=False):
    """Importance-weighted estimator means over the secondary-sample axis of
    clip(L_in * response) * w / pdf: the full BRDF lobe for outgoing
    radiance, the cosine lobe for irradiance. Samples below the local
    horizon contribute zero weight.

    ``bins_main`` / ``bins_mult`` insert a bins axis in front of the channel
    axis of the per-sample responses and weights [P, S, C], so that
    time-binned incoming radiance [P, S, bins, C] integrates against them
    (the outgoing radiance and irradiance, and the correction integral)."""
    z_up = samples["local_lightdirs"][..., 2:]
    surface_frame_normal = torch.cat(
        [torch.zeros_like(samples["local_lightdirs"][..., :2]), torch.ones_like(z_up)], dim=-1)
    brdf_response = get_lobe(
        samples["local_lightdirs"], samples["local_viewdirs"], surface_frame_normal,
        {k: v.reshape(-1, v.shape[-1]) for k, v in material.items()},
        samples["brdf_correction"], cfg)
    cosine_response = torch.clamp(z_up, min=0.0) / pymath.pi
    mc_w = torch.where(z_up > 0.0, torch.clamp(samples["weight"], min=0.0), 0.0)
    inv_p = torch.clamp(samples["pdf"], min=DENOMINATOR_EPS)
    incoming = samples["radiance_in"]

    def binned(x):
        return x[..., None, :]

    def estimate(response, lift):
        if lift:
            return (torch.clamp(incoming * binned(response), 0.0, max_radiance)
                    * binned(mc_w) / binned(inv_p)).mean(dim=1)
        return (torch.clamp(incoming * response, 0.0, max_radiance) * mc_w / inv_p).mean(dim=1)

    out = {"radiance_out": estimate(brdf_response, bins_main),
           "irradiance": estimate(cosine_response, bins_main)}
    correction = samples["brdf_correction"]
    if cfg.use_brdf_correction:
        # The correction integrals are not radiance-clipped.
        out["integrated_multiplier"] = (correction * mc_w / inv_p).mean(dim=1) / (2 * pymath.pi)
        if bins_mult:
            out["integrated_multiplier_irradiance"] = (
                binned(correction[..., 1:2]) * incoming * binned(cosine_response)
                * binned(mc_w) / binned(inv_p)).mean(dim=1)
        else:
            out["integrated_multiplier_irradiance"] = (
                correction[..., 1:2] * incoming * cosine_response * mc_w / inv_p).mean(dim=1)
    else:
        out["integrated_multiplier"] = correction[:, 0]
        out["integrated_multiplier_irradiance"] = correction[:, 0, :1]
    return out


def integrate_reflect_rays(material_type, use_brdf_correction, material, samples,
                           use_diffuseness=False, use_mirrorness=False, use_specular_albedo=False,
                           max_radiance=float("inf")):
    """MC estimate of one lobe's reflection integral over secondary samples."""
    cfg = _shading_config(material_type, use_brdf_correction, use_diffuseness, use_mirrorness,
                          use_specular_albedo)
    out = _lobe_estimates(cfg, material, samples, max_radiance)
    out["indirect_occ"] = samples["indirect_occ"].mean(dim=1)
    return out


def transient_integrate_reflect_rays(material_type, use_brdf_correction, material, samples,
                                     use_diffuseness=False, use_mirrorness=False,
                                     use_specular_albedo=False, direct=True,
                                     max_radiance=float("inf")):
    """Time-binned variant: the indirect lobes' incoming radiance carries a
    bins axis [P, S, bins, C]; a direct lobe's [P, S, C] does not, and has no
    indirect occlusion (None)."""
    cfg = _shading_config(material_type, use_brdf_correction, use_diffuseness, use_mirrorness,
                          use_specular_albedo)
    out = _lobe_estimates(cfg, material, samples, max_radiance, bins_main=not direct,
                          bins_mult=True)
    out["indirect_occ"] = None if direct else samples["indirect_occ"].mean(dim=1)
    return out


def integrate_irradiance(samples):
    """Cosine-weighted MC irradiance over the secondary-sample axis."""
    denominator = torch.clamp(samples["pdf"], min=_F32_EPS)
    z = samples["local_lightdirs"][..., 2:]
    weight = torch.where(z > 0.0, torch.clamp(samples["weight"], min=0.0), 0.0)
    diffuse_lobe = torch.clamp(z, min=0.0) / pymath.pi
    return (samples["radiance_in"] * diffuse_lobe * weight / denominator).mean(dim=1)


def dtof_to_itof(dtof_data, frequency_phase_shifts, bin_to_total_dist):
    """Project d-ToF transients [..., bins, C] onto iToF correlations
    [..., 2 P + 1, C]: per (frequency, phase) pair the transient weighted by
    cos and by sin of 2 pi f t + phase, each plus one, then half its sum.
    The bin times t are JAX's float32 ``linspace(0, bins *
    bin_to_total_dist, bins, endpoint=False) / c`` as XLA folds it: the bin
    index times (stop x (1 / bins)), each rounded to float32 (the phase
    reaches ~65 rad at 425 MHz over InvProp's 700 bins and ~180 over
    statue's 1933, where one ulp of t moves the cosine by ~1e-5)."""
    sh = dtof_data.shape
    dtof_data = dtof_data.reshape(-1, sh[-2], sh[-1])
    num_bins = dtof_data.shape[-2]
    c = 299792458
    f32 = dict(dtype=torch.float32, device=dtof_data.device)
    bin_time = torch.tensor(num_bins * bin_to_total_dist, **f32) * (
        1 / torch.tensor(num_bins, **f32))
    time_to_travel = torch.arange(num_bins, **f32) * bin_time / c
    itof_data = []
    for frequency, phase_shift in frequency_phase_shifts:
        for trig in (torch.cos, torch.sin):
            w = trig(2 * np.pi * frequency * time_to_travel + phase_shift) + 1.0
            itof_data.append((w[None, :, None] * dtof_data).sum(dim=-2, keepdim=True))
    itof_data.append(dtof_data.sum(dim=-2, keepdim=True) / 2.0)
    return torch.cat(itof_data, dim=-2).reshape(sh[:-2] + (-1, sh[-1]))


def zero_invalid_bins(transient_indirect_diffuse, transient_indirect_specular, rays, means,
                      config):
    """Causality mask of the per-sample indirect transients [..., S, bins, C]:
    zero the bins light cannot have reached the sample by (light distance
    beyond the bin's path length, less `bin_zero_threshold_light` bins), the
    bins whose return to the camera would fall past the last bin, and, with
    `light_zero`, every bin of samples nearer the light than `light_near`."""
    shape_trans = transient_indirect_diffuse.shape
    bins = torch.arange(config.n_bins, device=means.device).reshape(
        (1,) * (len(shape_trans) - 2) + (config.n_bins, 1))
    zero = torch.zeros((), dtype=transient_indirect_diffuse.dtype, device=means.device)

    def masked(mask, *ts):
        return tuple(torch.where(mask, zero.to(t.dtype), t) for t in ts)

    hist_dists_light = (bins + config.bin_zero_threshold_light) * config.exposure_time
    light_dists = torch.linalg.norm(rays.lights[..., None, :] - means, dim=-1, keepdim=True)
    ts = masked(hist_dists_light < light_dists[..., None, :],
                transient_indirect_diffuse, transient_indirect_specular)

    hist_dists_cam = bins * config.exposure_time
    max_dists = (config.n_bins - 1) * config.exposure_time
    cam_dists = torch.linalg.norm(rays.origins[..., None, :] - means, dim=-1, keepdim=True) + \
        torch.linalg.norm(rays.origins[..., None, :] - rays.cam_origins[..., None, :], dim=-1,
                          keepdim=True)
    ts = masked((hist_dists_cam + cam_dists[..., None, :]) > max_dists, *ts)
    if config.light_zero:
        ts = masked(light_dists[..., None, :] < config.light_near, *ts)
    return ts
