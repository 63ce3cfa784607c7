"""The radiance-cache shader (counterpart of ``NeRFMLP`` in
``models/nerf_shader.py``).

Ported: the passive path (``use_active=False``): ambient and indirect
irradiance heads plus the integrated-BRDF-weighted specular term fed by the
surface light field along the reflected view direction. The active (point
light) path, occlusions, the env map and the transient shader are not
ported yet and raise.
"""

from __future__ import annotations

import math as pymath

import torch
from torch import nn

from neural_radiance_caching_tpu_torch.models import shading, surface_light_field
from neural_radiance_caching_tpu_torch.models.layers import Dense, SkipMLP, softplus
from neural_radiance_caching_tpu_torch.ops import math, ref_utils
from neural_radiance_caching_tpu_torch.utils import torchutil
from neural_radiance_caching_tpu_torch.utils.torchutil import stopgrad_with_weight


class NeRFMLP(shading.BaseShader):
    """Steady-state cache shader."""

    use_reflections = False
    roughness_activation = staticmethod(softplus)
    roughness_bias = -1.0
    net_depth_integrated_brdf = 2
    net_width_integrated_brdf = 64
    skip_layer_integrated_brdf = 4
    surface_lf_distance_near = float("inf")
    surface_lf_distance_far = float("inf")
    surface_lf_params = None
    rgb_max = float("inf")
    use_active = False
    use_env_map = False
    irradiance_activation = staticmethod(softplus)
    irradiance_bias = -2.0
    ambient_irradiance_activation = staticmethod(softplus)
    ambient_irradiance_bias = -2.0
    optimize_light = True
    light_power_bias = 200.0
    stopgrad_normals_weight = 1.0
    stopgrad_indirect_weight = 1.0
    stopgrad_ambient_weight = 1.0
    # Read by the active path, the heads it feeds or the config surface
    # only; accepted so the flagship parameters bind unchanged.
    enable_pred_roughness = False
    use_specular_tint = False
    use_ambient = True
    use_indirect = True
    net_depth_brdf = 2
    net_width_brdf = 64
    skip_layer_brdf = 4
    net_depth_irradiance = 2
    net_width_irradiance = 64
    skip_layer_irradiance = 4

    def __init__(self, config=None, density_feature_dim=0, **kwargs):
        super().__init__(config, **kwargs)
        self._require(use_active=False, use_env_map=False, use_grid=False)
        if config.use_transient or config.multi_illumination:
            raise NotImplementedError("transient and multi-illumination shaders are not ported yet")
        cd = self.compute_dtype
        feature_dim = self._build_trunk(density_feature_dim)
        self.bottleneck_layer = Dense(feature_dim, self.bottleneck_width, cd)
        slf_params = dict(self.surface_lf_params or {})
        slf_params["distance_near"] = self.surface_lf_distance_near
        slf_params["distance_far"] = self.surface_lf_distance_far
        self.surface_lf = surface_light_field.SurfaceLightFieldMLP(
            config=config, use_env_alpha=True, shader_bottleneck_dim=self.bottleneck_width,
            **slf_params)
        rgb = config.num_rgb_channels
        self.irradiance_layer = Dense(feature_dim, rgb, cd)
        self.ambient_irradiance_layer = Dense(feature_dim, rgb, cd)
        self.tint_layer = Dense(feature_dim, rgb, cd)
        self.roughness_layer = Dense(feature_dim, 1, cd)
        self.integrated_brdf_layers = SkipMLP(
            self.bottleneck_width + 1,
            [self.net_width_integrated_brdf] * self.net_depth_integrated_brdf,
            self.skip_layer_integrated_brdf, self.net_activation, cd)
        self.output_integrated_brdf_layer = Dense(self.integrated_brdf_layers.out_dim, 1, cd)
        if self.optimize_light:
            self.light_power = nn.Parameter(torch.full((1,), float(self.light_power_bias)))

    def get_bottleneck_feature(self, rng, feature):
        bottleneck = self.bottleneck_layer(feature)
        if rng is not None and self.bottleneck_noise > 0:
            bottleneck = bottleneck + self.bottleneck_noise * torch.randn(
                bottleneck.shape, generator=rng, device=bottleneck.device)
        return bottleneck

    def get_integrated_brdf(self, normals, viewdirs, bottleneck):
        """Hemisphere-integrated BRDF scalar from (bottleneck, n.v)."""
        dotprod = math.dot(normals, -viewdirs[..., None, :])
        x = self.integrated_brdf_layers(torch.cat([bottleneck, dotprod], dim=-1))
        return torch.sigmoid(self.output_integrated_brdf_layer(x) + pymath.log(3.0))

    def _get_refdirs(self, viewdirs, normals):
        refdirs = ref_utils.reflect(-viewdirs[..., None, :], normals)
        if not self.use_reflections:
            refdirs = viewdirs[..., None, :] * torch.ones_like(refdirs)
        return refdirs

    def predict_appearance(self, rng, rays, sampler_results, train_frac=1.0, train=True,
                           is_secondary=False, passes=("diffuse", "specular"), **kwargs):
        key, rng = torchutil.random_split(rng)
        feature = self.predict_appearance_feature(
            sampler_results, train=train, train_frac=train_frac, is_secondary=bool(is_secondary))
        key, rng = torchutil.random_split(rng)
        bottleneck = self.get_bottleneck_feature(key, feature)
        roughness = self.roughness_activation(self.roughness_layer(feature) + self.roughness_bias)

        normals = sampler_results[self.normals_target]
        if self.stopgrad_normals_weight < 1.0:
            normals = stopgrad_with_weight(normals, self.stopgrad_normals_weight)

        means = sampler_results["means"]
        viewdirs = rays.viewdirs

        ambient_irradiance = self.ambient_irradiance_activation(
            self.ambient_irradiance_layer(feature) + self.ambient_irradiance_bias)
        ambient_diffuse = stopgrad_with_weight(
            torch.clamp(ambient_irradiance, 0.0, self.rgb_max), self.stopgrad_ambient_weight)
        tint = torch.sigmoid(self.tint_layer(feature))
        integrated_brdf = self.get_integrated_brdf(normals, viewdirs, bottleneck)
        env_rgb = torch.zeros_like(ambient_diffuse)

        indirect_irradiance = self.irradiance_activation(
            self.irradiance_layer(feature) + self.irradiance_bias)
        indirect_diffuse = stopgrad_with_weight(
            torch.clamp(indirect_irradiance, 0.0, self.rgb_max), self.stopgrad_indirect_weight)

        key, rng = torchutil.random_split(rng)
        incoming = self.surface_lf(
            key, rays, sampler_results, means, self._get_refdirs(viewdirs, normals),
            roughness=roughness, shader_bottleneck=bottleneck, train=train,
            train_frac=train_frac)
        ref_rgb = incoming["incoming_ambient_rgb"]
        ref_acc = incoming["incoming_acc"][..., None]

        ambient_specular = torch.clamp(tint * integrated_brdf * (env_rgb * (1.0 - ref_acc)),
                                       0.0, self.rgb_max)
        indirect_specular = torch.clamp(tint * integrated_brdf * ref_rgb * ref_acc,
                                        0.0, self.rgb_max)
        ambient = ambient_diffuse + ambient_specular
        indirect = indirect_diffuse + indirect_specular
        rgb = ambient + indirect
        diffuse = ambient_diffuse + indirect_diffuse
        specular = ambient_specular + indirect_specular
        if len(passes) > 0 and "specular" not in passes:
            return {"rgb": diffuse, "diffuse_rgb": diffuse, "specular_rgb": None}

        # Passive shading has no point light: the "direct" buffers alias the
        # ambient component so downstream consumers see a uniform contract.
        zero = torch.zeros_like(rgb)
        return dict(
            rgb=rgb,
            diffuse_rgb=diffuse,
            specular_rgb=specular,
            ambient_rgb=ambient,
            indirect_rgb=indirect,
            albedo_rgb=tint,
            occ=zero,
            indirect_occ=ref_acc * torch.ones_like(rgb),
            direct_rgb=ambient,
            direct_diffuse_rgb=ambient_diffuse,
            direct_specular_rgb=ambient_specular,
            indirect_diffuse_rgb=indirect_diffuse,
            indirect_specular_rgb=indirect_specular,
            ambient_diffuse_rgb=ambient_diffuse,
            ambient_specular_rgb=ambient_specular,
            transient_indirect=None,
            n_dot_l_rgb=zero,
            light_radiance_rgb=zero,
            irradiance_rgb=zero,
            ray_dists=torch.linalg.norm(rays.origins[..., None, :] - means, dim=-1, keepdim=True),
        )
