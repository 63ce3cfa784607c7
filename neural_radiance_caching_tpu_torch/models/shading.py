"""Shared shader base: appearance features from the density feature and/or
the shader's own hash grid (counterpart of ``models/shading.py``).

Ported: the density feature and an NGP appearance grid queried at the
sample means (the 'mean' unscented basis) with the warp and the
secondary-ray level clamp. Isotropized or rescaled covariances, scale-aware
grid queries, posenc with the grid and backfacing noise are not ported yet
and raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models import grids
from neural_radiance_caching_tpu_torch.models.layers import Configurable, SkipMLP
from neural_radiance_caching_tpu_torch.ops import coord, math
from neural_radiance_caching_tpu_torch.utils import torchutil


class BaseShader(Configurable, nn.Module, unported=dict(
        weight_init="he_uniform", min_deg_point=0, max_deg_point=4, rgb_bias_diffuse=-1.0,
        rgb_padding=0.001, basis_shape="icosahedron", basis_subdivisions=2,
        affine_density_feature=False, backfacing_target="normals_to_use",
        backfacing_noise_rate=float("inf"), backfacing_near=0.1)):
    """Base class for the shaders (radiance cache, material, light sampler, SLF)."""

    net_activation = staticmethod(F.relu)
    net_depth = 8
    net_width = 256
    bottleneck_width = 256
    bottleneck_noise = 0.0
    skip_layer = 4
    num_rgb_channels = 3
    rgb_premultiplier = 1.0
    rgb_activation = staticmethod(torch.sigmoid)
    rgb_bias = 0.0
    warp_fn = None
    use_density_feature = True
    use_grid = False
    grid_representation = "ngp"
    grid_params = None
    use_posenc_with_grid = False
    secondary_grid_level_clamp = None
    squash_before = False
    isotropize_gaussians = False
    gaussian_covariance_scale = 1.0
    gaussian_covariance_pad = 0.0
    unscented_mip_basis = "mean"
    unscented_sqrt_fn = "sqrtm"
    unscented_scale_mult = 0.0
    backfacing_noise = 0.0
    normals_target = "normals_to_use"
    use_bf16_compute = False

    def __init__(self, config=None, **kwargs):
        nn.Module.__init__(self)
        self.config = config
        self._set_fields(kwargs)
        self._require(use_posenc_with_grid=False, isotropize_gaussians=False,
                      gaussian_covariance_scale=1.0, gaussian_covariance_pad=0.0,
                      unscented_scale_mult=0.0, backfacing_noise=0.0)
        if self.use_grid:
            grid_cls = grids.GRID_REPRESENTATION_BY_NAME[self.grid_representation.lower()]
            self.grid = grid_cls(**dict(self.grid_params or {}))
        else:
            self.grid = None

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.use_bf16_compute else None

    def _build_trunk(self, density_feature_dim):
        """The appearance trunk `layers` over the density feature and the grid
        features; returns its output width."""
        in_dim = (density_feature_dim if self.use_density_feature else 0) + (
            self.grid.output_dim if self.grid is not None else 0)
        if in_dim == 0:
            raise NotImplementedError("shaders without density feature or grid are not ported yet")
        self.layers = SkipMLP(in_dim, [self.net_width] * self.net_depth, self.skip_layer,
                              self.net_activation, self.compute_dtype)
        return self.layers.out_dim

    def get_predict_appearance_kwargs(self, rng, rays, sampler_results):
        """Grid query offsets of each sample (zero for the 'mean' basis)."""
        if self.grid is None:
            return {}
        means, covs = sampler_results["means"], sampler_results["covs"]
        if "tdist" in sampler_results:
            control, _ = coord.compute_control_points(
                means, covs, rays, sampler_results["tdist"], rng, self.unscented_mip_basis,
                self.unscented_sqrt_fn, self.unscented_scale_mult)
        else:
            control = means[..., None, :]
        return {"control_offsets": control - means[..., None, :]}

    def predict_appearance_feature(self, sampler_results, train=True, train_frac=1.0,
                                   is_secondary=False, control_offsets=None, **kwargs):
        """Per-sample appearance feature: density feature and/or own grid, then
        the trunk."""
        del kwargs
        x = []
        if self.use_density_feature:
            x.append(sampler_results["feature"])
        if self.grid is not None:
            control = sampler_results["means"][..., None, :] + control_offsets
            if not self.squash_before and self.warp_fn is not None:
                control = self.warp_fn(control)
            grid_kwargs = {}
            if is_secondary and self.secondary_grid_level_clamp is not None:
                grid_kwargs["max_levels"] = self.secondary_grid_level_clamp
            x.append(self.grid(control, x_scale=None, per_level_fn=math.average_across_multisamples,
                               train=train, train_frac=train_frac, **grid_kwargs))
        return self.layers(torch.cat(x, dim=-1) if len(x) > 1 else x[0])

    def forward(self, rng, rays, sampler_results, train_frac=1.0, train=True,
                is_secondary=None, shading_only=False, **kwargs):
        key, rng = torchutil.random_split(rng)
        shading_results = self.predict_appearance(
            rng=key, rays=rays, sampler_results=sampler_results, train_frac=train_frac,
            train=train, is_secondary=is_secondary, **kwargs)
        if shading_only:
            return shading_results
        return dict(**shading_results,
                    **{k: v for k, v in sampler_results.items() if k not in shading_results})
