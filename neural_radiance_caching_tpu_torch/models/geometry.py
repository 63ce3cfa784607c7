"""Density field: hash-grid or IPE features + small MLP + predicted normals
(counterpart of ``models/geometry.py``).

Ported: the first-order path (``disable_density_normals=True``) and the
analytic density normals, with or without predicted normals, and every
option of the JAX class: the unscented control points of any basis with a
scale-aware grid query (``unscented_scale_mult``, the control points' scale
tracked through the warp), the covariance options of the IPE path, density
noise, corrected and offset normals, the feature filter (primary rays too,
and its far-field form), ``squash_before`` and the backfacing filter of
secondary rays. The density
normals are the gradient of the summed raw density with respect to the
sample means (each sample's density depends on its own mean only), taken
with ``torch.autograd.grad(..., create_graph=True)`` while gradients are
enabled, so a loss that reads the normals differentiates through them
again. That pass encodes through the plain-torch encoder, chosen for the
call (``plain_encoder``): the scatter kernel's backward is first-order, as
the JAX package's Pallas backward is, which takes its XLA encoder there.

With ``Config.gradient_checkpointing`` the encoding and trunk of each call
are recomputed in the backward instead of being kept (the JAX train step's
rematerialisation): the proposal MLPs' activations at secondary-ray
fan-outs are the bulk of the material step's memory. The recomputed region
draws no random numbers, so the recompute sees the same inputs as the
forward; the hash-grid backward still runs once.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models import grids
from neural_radiance_caching_tpu_torch.models.layers import Configurable, Dense, SkipMLP, softplus
from neural_radiance_caching_tpu_torch.ops import coord, geopoly, math, ref_utils
from neural_radiance_caching_tpu_torch.utils import torchutil


def warp_control_points(warp, control, perp_mag, unscented_scale_mult):
    """(control points through `warp`, their scale for a scale-aware grid
    query or None): with a positive `unscented_scale_mult` and `perp_mag`,
    the points' scale is tracked through the warp (the contraction's
    isotropic scale, else ``coord.track_isotropic``)."""
    if perp_mag is None or unscented_scale_mult <= 0:
        return warp(control), None
    if getattr(warp, "__wrapped__", warp) is coord.contract:
        s = coord.contract3_isoscale(control)
        return warp(control), unscented_scale_mult * (perp_mag * s)[..., None]
    control, perp_mag = coord.track_isotropic(warp, control, perp_mag)
    return control, unscented_scale_mult * perp_mag[..., None]


def adjust_covariances(covs, isotropize, scale, pad):
    """The Gaussians' covariances made isotropic, scaled and padded on the
    diagonal, as the fields ask."""
    if isotropize:
        covs = coord.isotropize(covs)
    if scale != 1:
        covs = covs * scale
    if pad > 0:
        covs = covs + pad * torch.eye(covs.shape[-1], dtype=covs.dtype, device=covs.device)
    return covs


def integrated_posenc(warp, means, covs, pos_basis_t, min_deg, max_deg, dtype=None):
    """The Gaussians' integrated positional encoding over the basis
    `pos_basis_t` [3, B], through `warp` (linearised) if given."""
    if warp is not None:
        means, covs = coord.track_linearize(warp, means, covs)
    lifted_means, lifted_vars = coord.lift_and_diagonalize(means, covs, pos_basis_t)
    return coord.integrated_pos_enc(lifted_means, lifted_vars, min_deg, max_deg, dtype=dtype)


def posenc_basis(basis_shape, basis_subdivisions):
    """The posenc basis [3, B] of ``geopoly.generate_basis``, float32."""
    return torch.as_tensor(np.ascontiguousarray(geopoly.generate_basis(
        basis_shape, basis_subdivisions).T), dtype=torch.float32)


@gin.configurable
class DensityMLP(Configurable, nn.Module):
    """Density MLP over grid features (or IPE posenc)."""

    filter_backfacing = False  # declared in JAX, read by nothing there

    net_depth = 8
    net_width = 256
    net_activation = staticmethod(F.relu)
    weight_init = "he_uniform"
    skip_layer = 4
    use_posenc_with_grid = False
    min_deg_point = 0
    max_deg_point = 4
    density_activation = staticmethod(softplus)
    density_bias = -1.0
    density_noise = 0.0
    enable_pred_normals = False
    enable_normals_offset = False
    use_corrected_normals = False
    disable_density_normals = False
    use_bf16_compute = False
    isotropize_gaussians = False
    gaussian_covariance_scale = 1.0
    gaussian_covariance_pad = 0.0
    warp_fn = None
    basis_shape = "icosahedron"
    basis_subdivisions = 2
    unscented_mip_basis = "mean"
    unscented_sqrt_fn = "sqrtm"
    unscented_scale_mult = 0.0
    squash_before = False
    use_grid = True
    grid_representation = "ngp"
    grid_params = None
    backfacing_target = "normals"
    backfacing_near = 0.2
    use_backfacing_near = False
    normals_for_filter_only = False
    use_feature_filter = False
    use_feature_filter_secondary_only = True
    secondary_grid_level_clamp = None
    primary_grid_level_clamp = None
    use_feature_filter_far_field = False
    feature_filter_radius = float("inf")
    feature_filter_size = 64

    def __init__(self, config=None, **kwargs):
        nn.Module.__init__(self)
        self.config = config
        self._set_fields(kwargs)
        self.register_buffer("pos_basis_t", posenc_basis(self.basis_shape,
                                                         self.basis_subdivisions),
                             persistent=False)
        compute_dtype = torch.bfloat16 if self.use_bf16_compute else None

        in_dim = 0
        if self.use_grid:
            grid_cls = grids.GRID_REPRESENTATION_BY_NAME[self.grid_representation.lower()]
            self.grid = grid_cls(**dict(self.grid_params or {}))
            in_dim += self.grid.output_dim
        else:
            self.grid = None
        if self.grid is None or self.use_posenc_with_grid:
            in_dim += self.pos_basis_t.shape[1] * (self.max_deg_point - self.min_deg_point) * 2
        self.density_layers = SkipMLP(in_dim, [self.net_width] * self.net_depth, self.skip_layer,
                                      self.net_activation, compute_dtype,
                                      kernel_init=self.weight_init)
        self.feature_dim = self.density_layers.out_dim
        self.output_density_layer = Dense(self.feature_dim, 1, compute_dtype, self.weight_init)
        if self.enable_pred_normals:
            self.pred_normals_layer = Dense(self.feature_dim, 3, compute_dtype, self.weight_init)
        if self.enable_normals_offset:
            self.normals_offset_layer = Dense(self.feature_dim, 3, kernel_init="zeros")

    def _encode(self, means, covs, control_offsets, perp_mag, is_secondary, viewdirs=None,
                plain_encoder=False):
        """Build the network input features for each sample mean."""
        x = []
        warp = None if self.squash_before else self.warp_fn
        if self.grid is not None:
            control = means[..., None, :] + control_offsets
            scale = None
            if warp is not None:
                control, scale = warp_control_points(warp, control, perp_mag,
                                                     self.unscented_scale_mult)

            # The feature filter: the fine levels of points beyond the radius
            # are zeroed, and under far_field those points are queried at a
            # distant point along the view instead.
            feature_filter = None
            if self.use_feature_filter and (is_secondary
                                            or not self.use_feature_filter_secondary_only):
                feature_filter = (torch.linalg.norm(means[..., None, :], dim=-1, keepdim=True)
                                  < self.feature_filter_radius)
                if self.use_feature_filter_far_field and viewdirs is not None:
                    vd = viewdirs
                    while vd.dim() < control.dim():
                        vd = vd[..., None, :]
                    far = torch.ones_like(control) * vd * 100.0
                    if self.warp_fn is not None:
                        far = self.warp_fn(far)
                    control = torch.where(feature_filter, control, far)
            grid_kwargs = {}
            if isinstance(self.grid, grids.HashEncoding):
                grid_kwargs["plain_encoder"] = plain_encoder
            if is_secondary and self.secondary_grid_level_clamp is not None:
                grid_kwargs["max_levels"] = self.secondary_grid_level_clamp
            elif not is_secondary and self.primary_grid_level_clamp is not None:
                grid_kwargs["max_levels"] = self.primary_grid_level_clamp
            # As in JAX the filter's arguments always go to the grid (the
            # triplane and factored grids take none, and raise).
            x.append(self.grid(control, x_scale=scale,
                               per_level_fn=math.average_across_multisamples,
                               feature_filter=feature_filter,
                               feature_filter_size=self.feature_filter_size, **grid_kwargs))
        if self.grid is None or self.use_posenc_with_grid:
            x.append(integrated_posenc(warp, means, covs, self.pos_basis_t, self.min_deg_point,
                                       self.max_deg_point,
                                       dtype=torch.bfloat16 if self.use_bf16_compute else None))
        return torch.cat(x, dim=-1) if len(x) > 1 else x[0]

    def predict_density(self, means, covs, control_offsets, perp_mag=None, is_secondary=False,
                        viewdirs=None, plain_encoder=False):
        """Raw density (pre-activation, without the density noise) and trunk
        feature for each sample."""
        covs = adjust_covariances(covs, self.isotropize_gaussians, self.gaussian_covariance_scale,
                                  self.gaussian_covariance_pad)
        x = self.density_layers(self._encode(means, covs, control_offsets, perp_mag, is_secondary,
                                             viewdirs, plain_encoder))
        return self.output_density_layer(x)[..., 0].float(), x.float()

    def _density_and_gradient(self, means, covs, control_offsets, perp_mag, is_secondary,
                              viewdirs):
        """(raw density, feature, d sum(raw density) / d means), through the
        plain encoder. With gradients enabled the gradient keeps its graph
        (create_graph) and the means' own gradient flows; without, all three
        come back detached."""
        grad_enabled = torch.is_grad_enabled()
        with torch.enable_grad():
            m = means if grad_enabled and means.requires_grad else \
                means.detach().requires_grad_(True)
            raw_density, feat = self.predict_density(m, covs, control_offsets, perp_mag,
                                                     is_secondary, viewdirs, plain_encoder=True)
            grad = torch.autograd.grad(raw_density.sum(), m, create_graph=grad_enabled)[0]
        if not grad_enabled:
            raw_density, feat, grad = raw_density.detach(), feat.detach(), grad.detach()
        return raw_density, feat, grad

    def convert_raw_density(self, raw_density, means):
        """Activation + bias, with zero density outside the grid bbox."""
        density = self.density_activation(raw_density + self.density_bias)
        if self.grid is not None:
            warped = self.warp_fn(means) if self.warp_fn is not None else means
            bbox = [torch.as_tensor(b, dtype=warped.dtype, device=warped.device)
                    for b in self.grid.bbox]
            valid = torch.all((warped > bbox[0]) & (warped < bbox[1]), dim=-1)
            density = torch.where(valid, density, torch.zeros_like(density))
        return density

    def forward(self, rng, rays, gaussians, tdist=None, train_frac=1.0, train=True,
                mesh_normals=None, is_secondary=False, density_only=False, **kwargs):
        """The density, feature and normals of each sample. density_only skips
        the density normals (None) for a caller that reads the density alone
        (unless the backfacing filter of secondary rays reads them).
        mesh_normals [..., S, 3] (the sampler's mesh shortcut) replace every
        normal, the density-gradient pass is skipped, and the density is
        1e5 (the sample sits on the surface). The random draws, in JAX's
        order: the control points' (``hexify``), then the density noise."""
        del train_frac, train, kwargs
        means, covs = gaussians
        control_offsets = perp_mag = None
        if self.grid is not None:
            control, perp_mag = coord.compute_control_points(
                means, covs, rays, tdist, rng, self.unscented_mip_basis, self.unscented_sqrt_fn,
                self.unscented_scale_mult)
            control_offsets = control - means[..., None, :]
        viewdirs = getattr(rays, "viewdirs", None) if rays is not None else None
        args = (means, covs, control_offsets, perp_mag, is_secondary, viewdirs)

        backfacing_reads = is_secondary and self.use_backfacing_near
        raw_grad_density = normals = None
        if (not self.disable_density_normals and (not density_only or backfacing_reads)
                and mesh_normals is None):
            raw_density, feat, raw_grad_density = self._density_and_gradient(*args)
            normals = torch.nan_to_num(-ref_utils.l2_normalize(raw_grad_density))
        elif self.config is not None and self.config.gradient_checkpointing \
                and torch.is_grad_enabled():
            raw_density, feat = torch.utils.checkpoint.checkpoint(
                self.predict_density, *args, use_reentrant=False)
        else:
            raw_density, feat = self.predict_density(*args)
        if rng is not None and self.density_noise > 0:
            raw_density = raw_density + self.density_noise * torchutil.normal(
                rng, raw_density.shape, raw_density.device)
        density = self.convert_raw_density(raw_density, means)

        if self.enable_pred_normals:
            grad_pred = self.pred_normals_layer(feat)
            normals_pred = torch.nan_to_num(-ref_utils.l2_normalize(grad_pred))
            if self.use_corrected_normals:
                def flip(n):
                    return torch.where(math.dot(n, rays.viewdirs[..., None, :]) < 0, n, -n)

                if normals is not None:
                    normals = flip(normals)
                normals_pred = flip(normals_pred)
            normals_to_use = normals_pred
        else:
            grad_pred = normals_pred = None
            normals_to_use = normals
        if mesh_normals is not None:
            normals = normals_pred = normals_to_use = raw_grad_density = mesh_normals
            density = 1e5 * torch.ones_like(density)
        normals_shading = None
        if self.enable_normals_offset:
            normals_shading = ref_utils.l2_normalize(
                normals_to_use + self.normals_offset_layer(feat))

        ray_dists = torch.linalg.norm(rays.origins[..., None, :] - means, dim=-1, keepdim=True)
        light_dists = torch.linalg.norm(rays.lights[..., None, :] - means, dim=-1, keepdim=True)
        results = dict(
            feature=feat, density=density, raw_grad_density=raw_grad_density, grad_pred=grad_pred,
            normals=normals, normals_pred=normals_pred, normals_to_use=normals_to_use,
            normals_shading=normals_shading, ray_dists=ray_dists, light_dists=light_dists,
        )
        # Secondary rays: zero the density of backfacing points near the ray's start.
        target = results.get(self.backfacing_target)
        if target is not None and backfacing_reads:
            dotprod = math.dot(target, -rays.directions[..., None, :])[..., 0]
            results["density"] = results["density"] * (
                (dotprod > 0.0) | (tdist[..., :-1] > self.backfacing_near))
        if self.normals_for_filter_only:
            results["normals"] = None
            results["normals_to_use"] = None
            results["normals_pred"] = None
        return results
