"""Shared shader base: appearance features from the density feature and/or
the shader's own hash grid (counterpart of ``models/shading.py``).

The appearance feature: the density feature and/or the shader's own grid
queried at the unscented control points of the samples (any basis, a
scale-aware query under ``unscented_scale_mult``, the warp, the
secondary-ray level clamp), with ``use_posenc_with_grid`` the samples'
integrated positional encoding too (over the Gaussians' covariances made
isotropic, scaled or padded as the fields ask), then the trunk. Training
renders may replace the colour of samples that face away from the ray by
noise (``backfacing_noise``). The helpers are ``models/geometry.py``'s,
which the density MLP shares.

Where JAX fails the port raises naming the failure: posenc with the grid
outside the cache shaders (``POSENC_BASIS_GAP``), a shader with neither
the density feature nor a grid (``EMPTY_FEATURE_GAP``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models import geometry, grids
from neural_radiance_caching_tpu_torch.models.layers import (Configurable, Dense, Embed, SkipMLP,
                                                            init_kernel_)
from neural_radiance_caching_tpu_torch.ops import coord, math, render_utils
from neural_radiance_caching_tpu_torch.utils import torchutil

# Config.sl_relight: JAX's active shaders read an env map that nothing hands them.
SL_RELIGHT_GAP = (
    "Config.sl_relight (structured light) is a reference gap: the JAX transient cache shader "
    "(nerf_shader.py:380-395) and material shader (material_shader.py:707-720) read "
    "kwargs['env_map'] for render_utils.get_sl_color, and no module of the JAX engine/ or "
    "parallel/ passes one, so its first query raises KeyError: 'env_map' "
    "(nerf_shader.py:384)")


# use_posenc_with_grid in a shader other than the cache shaders.
POSENC_BASIS_GAP = (
    "{cls}.use_posenc_with_grid with a grid is a reference gap: only the JAX cache shaders "
    "build the posenc basis pos_basis_t (BaseNeRFMLP.setup, nerf_shader.py:154), which "
    "BaseShader.predict_appearance_feature reads (shading.py:148), so the {cls}'s first "
    "query raises AttributeError: '{cls}' object has no attribute 'pos_basis_t'")
# A shader with neither the density feature nor a grid.
EMPTY_FEATURE_GAP = (
    "{cls} with use_density_feature=False and no grid is a reference gap: the JAX "
    "BaseShader.predict_appearance_feature then concatenates no feature and raises "
    "ValueError: Need at least one array to concatenate (shading.py:156) at the first query")


class BaseShader(Configurable, nn.Module):
    """Base class for the shaders (radiance cache, material, light sampler, SLF)."""

    # Declared by the JAX shaders and read by nothing there.
    rgb_bias_diffuse = -1.0
    rgb_padding = 0.001
    affine_density_feature = False
    backfacing_near = 0.1

    # The kernel initializer of the layers JAX builds with its dense factory
    # (every he_uniform Dense of the shader; the explicit zero-initialised
    # heads and the modules of other shaders keep theirs).
    weight_init = "he_uniform"
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
    min_deg_point = 0
    max_deg_point = 4
    # The posenc basis, which only the cache shaders build (_has_pos_basis).
    basis_shape = "icosahedron"
    basis_subdivisions = 2
    _has_pos_basis = False
    secondary_grid_level_clamp = None
    squash_before = False
    isotropize_gaussians = False
    gaussian_covariance_scale = 1.0
    gaussian_covariance_pad = 0.0
    unscented_mip_basis = "mean"
    unscented_sqrt_fn = "sqrtm"
    unscented_scale_mult = 0.0
    # Noise in place of the colour of samples facing away from the ray,
    # decaying to none at train_frac = backfacing_noise_rate.
    backfacing_noise = 0.0
    backfacing_target = "normals_to_use"
    backfacing_noise_rate = float("inf")
    normals_target = "normals_to_use"
    use_bf16_compute = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        init = cls.__dict__.get("__init__")
        if init is None:
            return

        @functools.wraps(init)
        def wrapped(self, *args, **kw):
            init(self, *args, **kw)
            if type(self).__init__ is wrapped:  # the most derived constructor is done
                self._apply_weight_init()

        cls.__init__ = wrapped

    def _apply_weight_init(self):
        """Refill the shader's own he_uniform Dense kernels (in its layer
        lists and MLPs, not in its child shaders, grids or lights) with
        ``weight_init``."""
        if self.weight_init == "he_uniform":
            return

        def walk(module):
            for child in module.children():
                if isinstance(child, Dense):
                    if child.kernel_init == "he_uniform":
                        init_kernel_(child.weight, self.weight_init)
                elif isinstance(child, (SkipMLP, nn.ModuleList, nn.Sequential)):
                    walk(child)

        walk(self)

    def __init__(self, config=None, **kwargs):
        nn.Module.__init__(self)
        self.config = config
        self._set_fields(kwargs)
        if self.use_grid:
            grid_cls = grids.GRID_REPRESENTATION_BY_NAME[self.grid_representation.lower()]
            self.grid = grid_cls(**dict(self.grid_params or {}))
        else:
            self.grid = None
        if self.reads_posenc:
            if not self._has_pos_basis:
                raise NotImplementedError(POSENC_BASIS_GAP.format(cls=type(self).__name__))
            self.register_buffer("pos_basis_t", geometry.posenc_basis(
                self.basis_shape, self.basis_subdivisions), persistent=False)

    @property
    def reads_posenc(self):
        """The samples' integrated posenc joins the grid's features."""
        return self.use_posenc_with_grid and self.grid is not None

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.use_bf16_compute else None

    # --- several illuminations (Config.multi_illumination) ---------------------------

    @property
    def reads_illumination_feature(self):
        """Whether the shader concatenates its illumination embedding
        ``light_vecs`` to its feature; only then does JAX call the embedding,
        and so create it."""
        cfg = self.config
        return bool(cfg is not None and cfg.multi_illumination
                    and getattr(self, "use_illumination_feature", False))

    @property
    def num_illumination_outputs(self):
        """The per-illumination heads' count: ``Config.num_illuminations``
        under ``Config.multi_illumination`` and
        ``Config.multiple_illumination_outputs``, else 1."""
        cfg = self.config
        return (cfg.num_illuminations if cfg is not None and cfg.multi_illumination
                and cfg.multiple_illumination_outputs else 1)

    @property
    def selects_illumination(self):
        """Whether a head's per-illumination slice is picked by the ray's
        light index: the shader's own field ``multiple_illumination_outputs``
        decides, whatever the head's size (a one-slice head then gives NaN
        for light indices past 0, JAX's gather out of bounds)."""
        cfg = self.config
        return bool(cfg is not None and cfg.multi_illumination
                    and self.multiple_illumination_outputs)

    def _make_light_vecs(self):
        """The illumination embedding, one row of ``num_light_features`` per
        illumination."""
        self.light_vecs = Embed(self.config.num_illuminations, self.num_light_features)
        return self.num_light_features

    def get_light_vec(self, rays, feature):
        """Each ray's illumination embedding, broadcast over its samples."""
        per_ray = self.light_vecs(rays.light_idx[..., 0])
        return per_ray[..., None, :] * torch.ones_like(feature[..., 0:1])

    def select_illumination(self, rays, x, like):
        """The ray's illumination slice of a per-illumination head `x`
        [..., S, n * C] -> [..., S, C] (JAX's take_along_axis, fill mode)."""
        light_idx = rays.light_idx[..., None, :] * torch.ones_like(like[..., 0:1]).to(
            rays.light_idx.dtype)
        x = x.reshape(x.shape[:-1] + (self.num_illumination_outputs, -1))
        return render_utils.take_along_fill(x, light_idx[..., None], -2)[..., 0, :]

    def _build_trunk(self, density_feature_dim):
        """The appearance trunk `layers` over the density feature and the grid
        features; returns its output width."""
        in_dim = (density_feature_dim if self.use_density_feature else 0) + (
            self.grid.output_dim if self.grid is not None else 0)
        if self.reads_posenc:
            in_dim += self.pos_basis_t.shape[1] * (self.max_deg_point - self.min_deg_point) * 2
        if not self.use_density_feature and self.grid is None:
            raise NotImplementedError(EMPTY_FEATURE_GAP.format(cls=type(self).__name__))
        self.layers = SkipMLP(in_dim, [self.net_width] * self.net_depth, self.skip_layer,
                              self.net_activation, self.compute_dtype)
        return self.layers.out_dim

    def get_predict_appearance_kwargs(self, rng, rays, sampler_results):
        """Grid query offsets of each sample's control points (zero for the
        'mean' basis) and their perpendicular scale."""
        if self.grid is None:
            return {}
        means, covs = sampler_results["means"], sampler_results["covs"]
        if "tdist" in sampler_results:
            control, perp_mag = coord.compute_control_points(
                means, covs, rays, sampler_results["tdist"], rng, self.unscented_mip_basis,
                self.unscented_sqrt_fn, self.unscented_scale_mult)
        else:
            control = means[..., None, :]
            perp_mag = torch.zeros_like(control)
        return {"control_offsets": control - means[..., None, :], "perp_mag": perp_mag}

    def predict_appearance_feature(self, sampler_results, train=True, train_frac=1.0,
                                   is_secondary=False, control_offsets=None, perp_mag=None,
                                   **kwargs):
        """Per-sample appearance feature: density feature and/or own grid
        (and the posenc), then the trunk."""
        del kwargs
        means = sampler_results["means"]
        x = []
        if self.use_density_feature:
            x.append(sampler_results["feature"])
        if self.grid is not None:
            control = means[..., None, :] + control_offsets
            warp = None if self.squash_before else self.warp_fn
            scale = None
            if warp is not None:
                control, scale = geometry.warp_control_points(warp, control, perp_mag,
                                                              self.unscented_scale_mult)
            grid_kwargs = {}
            if is_secondary and self.secondary_grid_level_clamp is not None:
                grid_kwargs["max_levels"] = self.secondary_grid_level_clamp
            x.append(self.grid(control, x_scale=scale,
                               per_level_fn=math.average_across_multisamples, train=train,
                               train_frac=train_frac, **grid_kwargs))
            if self.reads_posenc:
                covs = geometry.adjust_covariances(
                    sampler_results["covs"], self.isotropize_gaussians,
                    self.gaussian_covariance_scale, self.gaussian_covariance_pad)
                x.append(geometry.integrated_posenc(warp, means, covs, self.pos_basis_t,
                                                    self.min_deg_point, self.max_deg_point))
        return self.layers(torch.cat(x, dim=-1) if len(x) > 1 else x[0])

    def forward(self, rng, rays, sampler_results, train_frac=1.0, train=True,
                is_secondary=None, shading_only=False, **kwargs):
        key, rng = torchutil.random_split(rng)
        shading_results = self.predict_appearance(
            rng=key, rays=rays, sampler_results=sampler_results, train_frac=train_frac,
            train=train, is_secondary=is_secondary, **kwargs)
        if train and rng is not None and self.backfacing_noise > 0:
            self._add_backfacing_noise(rng, rays, sampler_results, shading_results, train_frac)
        if shading_only:
            return shading_results
        return dict(**shading_results,
                    **{k: v for k, v in sampler_results.items() if k not in shading_results})

    def _add_backfacing_noise(self, rng, rays, sampler_results, shading_results, train_frac):
        """The colour of samples whose ``backfacing_target`` normal faces
        away from the ray becomes normal noise of ``backfacing_noise`` (eased
        out linearly by train_frac / ``backfacing_noise_rate``) plus the
        detached colour."""
        rgb = shading_results["rgb"]
        facing = math.dot(sampler_results[self.backfacing_target],
                          -rays.directions[..., None, :]) > 0.0
        f32 = np.float32
        ease = float(np.clip(f32(1.0) - f32(train_frac) / f32(self.backfacing_noise_rate),
                             f32(0), f32(1)))
        key, rng = torchutil.random_split(rng)
        noise = torchutil.normal(key, rgb.shape, rgb.device) * self.backfacing_noise * ease
        shading_results["rgb"] = torch.where(facing, rgb, noise + rgb.detach())
