"""Density field: hash-grid or IPE features + small MLP + predicted normals
(counterpart of ``models/geometry.py``).

Ported: the first-order path (``disable_density_normals=True``) and the
analytic density normals, with or without predicted normals. The density
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


@gin.configurable
class DensityMLP(Configurable, nn.Module, unported=dict(
        weight_init="he_uniform", density_noise=0.0, enable_normals_offset=False,
        use_corrected_normals=False, isotropize_gaussians=False, gaussian_covariance_scale=1.0,
        gaussian_covariance_pad=0.0, unscented_sqrt_fn="sqrtm", unscented_scale_mult=0.0,
        squash_before=False, backfacing_target="normals", use_backfacing_near=False,
        use_feature_filter=False,
        use_feature_filter_secondary_only=True, use_feature_filter_far_field=False,
        feature_filter_radius=float("inf"), feature_filter_size=64)):
    """Density MLP over grid features (or IPE posenc)."""

    filter_backfacing = False  # declared in JAX, read by nothing there

    net_depth = 8
    net_width = 256
    net_activation = staticmethod(F.relu)
    skip_layer = 4
    use_posenc_with_grid = False
    min_deg_point = 0
    max_deg_point = 4
    density_activation = staticmethod(softplus)
    density_bias = -1.0
    enable_pred_normals = False
    disable_density_normals = False
    use_bf16_compute = False
    warp_fn = None
    basis_shape = "icosahedron"
    basis_subdivisions = 2
    unscented_mip_basis = "mean"
    use_grid = True
    grid_representation = "ngp"
    grid_params = None
    normals_for_filter_only = False
    secondary_grid_level_clamp = None
    primary_grid_level_clamp = None
    backfacing_near = 0.2  # read with use_backfacing_near only

    def __init__(self, config=None, **kwargs):
        nn.Module.__init__(self)
        self.config = config
        self._set_fields(kwargs)
        self.register_buffer("pos_basis_t", torch.as_tensor(
            np.ascontiguousarray(geopoly.generate_basis(
                self.basis_shape, self.basis_subdivisions).T), dtype=torch.float32),
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
                                      self.net_activation, compute_dtype)
        self.feature_dim = self.density_layers.out_dim
        self.output_density_layer = Dense(self.feature_dim, 1, compute_dtype)
        if self.enable_pred_normals:
            self.pred_normals_layer = Dense(self.feature_dim, 3, compute_dtype)

    def _encode(self, means, covs, control_offsets, is_secondary, plain_encoder=False):
        """Build the network input features for each sample mean."""
        x = []
        if self.grid is not None:
            control = means[..., None, :] + control_offsets
            if self.warp_fn is not None:
                control = self.warp_fn(control)
            grid_kwargs = {"plain_encoder": plain_encoder}
            if is_secondary and self.secondary_grid_level_clamp is not None:
                grid_kwargs["max_levels"] = self.secondary_grid_level_clamp
            elif not is_secondary and self.primary_grid_level_clamp is not None:
                grid_kwargs["max_levels"] = self.primary_grid_level_clamp
            x.append(self.grid(control, x_scale=None,
                               per_level_fn=math.average_across_multisamples, **grid_kwargs))
        if self.grid is None or self.use_posenc_with_grid:
            if self.warp_fn is not None:
                means, covs = coord.track_linearize(self.warp_fn, means, covs)
            lifted_means, lifted_vars = coord.lift_and_diagonalize(means, covs, self.pos_basis_t)
            x.append(coord.integrated_pos_enc(
                lifted_means, lifted_vars, self.min_deg_point, self.max_deg_point,
                dtype=torch.bfloat16 if self.use_bf16_compute else None))
        return torch.cat(x, dim=-1) if len(x) > 1 else x[0]

    def predict_density(self, means, covs, control_offsets, is_secondary=False,
                        plain_encoder=False):
        """Raw density (pre-activation) and trunk feature for each sample."""
        x = self.density_layers(self._encode(means, covs, control_offsets, is_secondary,
                                             plain_encoder))
        return self.output_density_layer(x)[..., 0].float(), x.float()

    def _density_and_gradient(self, means, covs, control_offsets, is_secondary):
        """(raw density, feature, d sum(raw density) / d means), through the
        plain encoder. With gradients enabled the gradient keeps its graph
        (create_graph) and the means' own gradient flows; without, all three
        come back detached."""
        grad_enabled = torch.is_grad_enabled()
        with torch.enable_grad():
            m = means if grad_enabled and means.requires_grad else \
                means.detach().requires_grad_(True)
            raw_density, feat = self.predict_density(m, covs, control_offsets, is_secondary,
                                                     plain_encoder=True)
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
        the density normals (None) for a caller that reads the density alone."""
        del train_frac, train, kwargs
        if mesh_normals is not None:
            raise NotImplementedError("mesh normals are not ported yet")
        means, covs = gaussians
        control_offsets = None
        if self.grid is not None:
            control, _ = coord.compute_control_points(
                means, covs, rays, tdist, rng, self.unscented_mip_basis, "sqrtm", 0.0)
            control_offsets = control - means[..., None, :]

        raw_grad_density = normals = None
        if not self.disable_density_normals and not density_only:
            raw_density, feat, raw_grad_density = self._density_and_gradient(
                means, covs, control_offsets, is_secondary)
            normals = torch.nan_to_num(-ref_utils.l2_normalize(raw_grad_density))
        elif self.config is not None and self.config.gradient_checkpointing \
                and torch.is_grad_enabled():
            raw_density, feat = torch.utils.checkpoint.checkpoint(
                self.predict_density, means, covs, control_offsets, is_secondary,
                use_reentrant=False)
        else:
            raw_density, feat = self.predict_density(means, covs, control_offsets, is_secondary)
        density = self.convert_raw_density(raw_density, means)

        if self.enable_pred_normals:
            grad_pred = self.pred_normals_layer(feat)
            normals_pred = torch.nan_to_num(-ref_utils.l2_normalize(grad_pred))
            normals_to_use = normals_pred
        else:
            grad_pred = normals_pred = None
            normals_to_use = normals

        ray_dists = torch.linalg.norm(rays.origins[..., None, :] - means, dim=-1, keepdim=True)
        light_dists = torch.linalg.norm(rays.lights[..., None, :] - means, dim=-1, keepdim=True)
        results = dict(
            feature=feat, density=density, raw_grad_density=raw_grad_density, grad_pred=grad_pred,
            normals=normals, normals_pred=normals_pred, normals_to_use=normals_to_use,
            normals_shading=None, ray_dists=ray_dists, light_dists=light_dists,
        )
        if self.normals_for_filter_only:
            results["normals"] = None
            results["normals_to_use"] = None
            results["normals_pred"] = None
        return results
