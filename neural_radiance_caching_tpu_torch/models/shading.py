"""Shared shader base: appearance features from the density feature and/or
the shader's own hash grid (counterpart of ``models/shading.py``).

Ported: the density feature and an NGP appearance grid queried at the
sample means (the 'mean' unscented basis) with the warp and the
secondary-ray level clamp. Isotropized or rescaled covariances, scale-aware
grid queries, posenc with the grid and backfacing noise are not ported yet
and raise.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models import grids
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


class BaseShader(Configurable, nn.Module, unported=dict(
        min_deg_point=0, max_deg_point=4, basis_shape="icosahedron",
        basis_subdivisions=2, backfacing_target="normals_to_use",
        backfacing_noise_rate=float("inf"))):
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
