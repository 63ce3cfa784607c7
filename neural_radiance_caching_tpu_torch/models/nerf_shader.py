"""The radiance-cache shaders (counterpart of ``BaseNeRFMLP``, ``NeRFMLP``
and ``TransientNeRFMLP`` in ``models/nerf_shader.py``).

``NeRFMLP`` is the steady cache shader on its passive path
(``use_active=False``): ambient and indirect irradiance heads plus the
integrated-BRDF-weighted specular term fed by the surface light field along
the reflected view direction.

``TransientNeRFMLP`` is the transient cache shader on its active path: a
point light of learnable constant power with inverse-square falloff, a
diffuse (albedo) and a BRDF-net specular direct term, and time-binned
indirect radiance: an irradiance net emitting n_bins x 3 channels (diffuse)
plus the tinted, integrated-BRDF-weighted transient surface light field
(specular), masked by ``zero_invalid_bins``.

Not ported yet, raising: the active steady shader, the passive transient
shader, shadow rays (occlusions that would be traced), the light power
shared with a material model (``share_light_power``), cone lights,
structured light, canonical-frame and intensity light conditioning, the
simple BRDF input, the ambient term of the active path, env maps and the
multi-illumination shaders.
"""

from __future__ import annotations

import math as pymath

import torch
from torch import nn

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models import shading, surface_light_field
from neural_radiance_caching_tpu_torch.models.layers import Dense, SkipMLP, softplus
from neural_radiance_caching_tpu_torch.ops import coord, math, ref_utils, render_utils
from neural_radiance_caching_tpu_torch.utils import torchutil
from neural_radiance_caching_tpu_torch.utils.torchutil import stopgrad_with_weight


class BaseNeRFMLP(shading.BaseShader, unported=dict(
        use_occlusions=False, cull_backfacing=True, use_normals_feature=False,
        use_pred_normals_feature=False, use_learned_vignette_map=False,
        use_exposure_at_bottleneck=False, num_glo_features=0, num_glo_embeddings=1000,
        num_light_features=64, multiple_illumination_outputs=True, run_surface_light_field=True,
        use_corrected_normals=False, weight_thold=0.0, stopgrad_occ_weight=(0.0, 0.0))):
    """Shared trunk, bottleneck, surface light field, integrated BRDF and
    light power of the cache shaders."""

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
    use_illumination_feature = False  # read with multi_illumination only
    # Read by the env map only (use_env_map).
    env_map_near = float("inf")
    env_map_far = float("inf")
    env_map_params = None
    irradiance_activation = staticmethod(softplus)
    irradiance_bias = -2.0
    ambient_irradiance_activation = staticmethod(softplus)
    ambient_irradiance_bias = -2.0
    optimize_light = True
    light_power_bias = 200.0
    stopgrad_normals_weight = 1.0
    stopgrad_shading_normals_weight = 1.0
    stopgrad_indirect_weight = 1.0
    stopgrad_ambient_weight = 1.0
    use_ambient = True
    use_indirect = True
    net_depth_brdf = 2
    net_width_brdf = 64
    skip_layer_brdf = 4
    net_depth_irradiance = 2
    net_width_irradiance = 64
    skip_layer_irradiance = 4
    # Read by paths or heads that are not ported or by the config surface
    # only; accepted so the flagship parameters bind unchanged.
    enable_pred_roughness = False
    use_specular_tint = False

    slf_cls = surface_light_field.SurfaceLightFieldMLP

    def __init__(self, config=None, density_feature_dim=0, **kwargs):
        super().__init__(config, **kwargs)
        self._require(use_env_map=False, use_grid=False)
        if config.multi_illumination:
            raise NotImplementedError("multi-illumination shaders are not ported yet")
        cd = self.compute_dtype
        feature_dim = self._build_trunk(density_feature_dim)
        self.bottleneck_layer = Dense(feature_dim, self.bottleneck_width, cd)
        slf_params = dict(self.surface_lf_params or {})
        slf_params["distance_near"] = self.surface_lf_distance_near
        slf_params["distance_far"] = self.surface_lf_distance_far
        self.surface_lf = self.slf_cls(
            config=config, use_env_alpha=True, shader_bottleneck_dim=self.bottleneck_width,
            **slf_params)
        self._build_heads(feature_dim)
        self.integrated_brdf_layers = SkipMLP(
            self.bottleneck_width + 1,
            [self.net_width_integrated_brdf] * self.net_depth_integrated_brdf,
            self.skip_layer_integrated_brdf, self.net_activation, cd)
        self.output_integrated_brdf_layer = Dense(self.integrated_brdf_layers.out_dim, 1, cd)
        if self.optimize_light:
            self.light_power = nn.Parameter(torch.full((1,), float(self.light_power_bias)))

    def _build_heads(self, feature_dim):
        raise NotImplementedError

    def get_bottleneck_feature(self, rng, feature):
        bottleneck = self.bottleneck_layer(feature)
        if rng is not None and self.bottleneck_noise > 0:
            bottleneck = bottleneck + self.bottleneck_noise * torchutil.normal(
                rng, bottleneck.shape, bottleneck.device)
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

    def _appearance_inputs(self, rng, sampler_results, train, train_frac, is_secondary):
        """(feature, bottleneck, roughness, normals, shading normals)."""
        key, rng = torchutil.random_split(rng)
        feature = self.predict_appearance_feature(
            sampler_results, train=train, train_frac=train_frac, is_secondary=bool(is_secondary))
        key, rng = torchutil.random_split(rng)
        bottleneck = self.get_bottleneck_feature(key, feature)
        roughness = self.roughness_activation(self.roughness_layer(feature) + self.roughness_bias)
        normals = shading_normals = sampler_results[self.normals_target]
        if self.stopgrad_normals_weight < 1.0:
            normals = stopgrad_with_weight(normals, self.stopgrad_normals_weight)
        if self.stopgrad_shading_normals_weight < 1.0:
            shading_normals = stopgrad_with_weight(shading_normals,
                                                   self.stopgrad_shading_normals_weight)
        return feature, bottleneck, roughness, normals, shading_normals

    def _query_surface_lf(self, rng, rays, sampler_results, means, normals, roughness, bottleneck,
                          train, train_frac):
        return self.surface_lf(
            rng, rays, sampler_results, means, self._get_refdirs(rays.viewdirs, normals),
            roughness=roughness, shader_bottleneck=bottleneck, train=train,
            train_frac=train_frac)


@gin.configurable
class NeRFMLP(BaseNeRFMLP):
    """Steady-state cache shader, passive path."""

    # Read by the active path's heads only (use_active, ported on
    # TransientNeRFMLP).
    deg_brdf = 2
    brdf_bias = -1.09861228867
    simple_brdf = False
    albedo_activation = staticmethod(torch.sigmoid)
    albedo_bias = -1.0
    deg_lights = 2
    bottleneck_irradiance = 64
    light_power_activation = staticmethod(math.abs_)
    light_max_angle = 0.0
    stopgrad_direct_weight = 1.0
    stopgrad_light_radiance_weight = 1.0
    indirect_scale = 1.0

    def __init__(self, config=None, density_feature_dim=0, **kwargs):
        super().__init__(config, density_feature_dim, **kwargs)
        self._require(use_active=False)
        if config.use_transient:
            raise NotImplementedError("the transient cache shader is TransientNeRFMLP")

    def _build_heads(self, feature_dim):
        cd = self.compute_dtype
        rgb = self.config.num_rgb_channels
        self.irradiance_layer = Dense(feature_dim, rgb, cd)
        self.ambient_irradiance_layer = Dense(feature_dim, rgb, cd)
        self.tint_layer = Dense(feature_dim, rgb, cd)
        self.roughness_layer = Dense(feature_dim, 1, cd)

    def predict_appearance(self, rng, rays, sampler_results, train_frac=1.0, train=True,
                           is_secondary=False, passes=("diffuse", "specular"), **kwargs):
        feature, bottleneck, roughness, normals, _ = self._appearance_inputs(
            rng, sampler_results, train, train_frac, is_secondary)
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
        incoming = self._query_surface_lf(key, rays, sampler_results, means, normals, roughness,
                                          bottleneck, train, train_frac)
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


@gin.configurable
class TransientNeRFMLP(BaseNeRFMLP):
    """Time-resolved cache shader, active path: per-point time-binned
    indirect radiance."""

    use_active = True
    albedo_activation = staticmethod(torch.sigmoid)
    albedo_bias = -1.0
    deg_brdf = 2
    brdf_bias = -1.09861228867
    simple_brdf = False
    deg_lights = 2
    bottleneck_irradiance = 64
    light_power_activation = staticmethod(math.abs_)
    light_max_angle = 0.0
    stopgrad_direct_weight = 1.0
    stopgrad_light_radiance_weight = 1.0
    indirect_scale = 1.0

    slf_cls = surface_light_field.TransientSurfaceLightFieldMLP

    def __init__(self, config=None, density_feature_dim=0, **kwargs):
        super().__init__(config, density_feature_dim, **kwargs)
        self._require(use_active=True, use_indirect=True, use_ambient=False, simple_brdf=False,
                      light_max_angle=0.0)
        if not config.use_transient:
            raise ValueError("TransientNeRFMLP needs Config.use_transient")
        unported = [k for k in ("light_canonical_frame", "light_intensity_conditioning",
                                "sl_relight") if getattr(config, k)]
        if unported:
            raise NotImplementedError(f"not ported yet: {', '.join(unported)}")

    def _build_heads(self, feature_dim):
        cd = self.compute_dtype
        rgb = self.config.num_rgb_channels
        # With use_ambient=False nothing reads the ambient head; the JAX
        # shader evaluates it all the same, so its parameters exist (and no
        # loss reaches them).
        self.ambient_irradiance_layer = Dense(feature_dim, rgb, cd)
        self.tint_layer = Dense(feature_dim, rgb, cd)
        self.roughness_layer = Dense(feature_dim, 1, cd)
        self.albedo_layer = Dense(feature_dim, rgb, cd)
        self.direct_tint_layer = Dense(feature_dim, rgb, cd)
        brdf_in = self.bottleneck_width + 3 * (1 + 2 * self.deg_brdf)
        self.brdf_layers = SkipMLP(brdf_in, [self.net_width_brdf] * self.net_depth_brdf,
                                   self.skip_layer_brdf, self.net_activation, cd)
        self.output_brdf_layer = Dense(self.brdf_layers.out_dim, 1, cd)
        lights_in = feature_dim + 3 * (1 + 2 * self.deg_lights)
        self.irradiance_layers = SkipMLP(
            lights_in,
            [self.net_width_irradiance] * (self.net_depth_irradiance - 1)
            + [self.bottleneck_irradiance],
            self.skip_layer_irradiance, self.net_activation, cd)
        self.transient_indirect_layer = Dense(self.irradiance_layers.out_dim,
                                              rgb * self.config.n_bins, cd)

    def get_brdf_light(self, normals, viewdirs, lightdirs, bottleneck):
        """Point-light BRDF net conditioned on the sorted (n.v, n.l) and n.h."""
        halfdirs = math.normalize(-viewdirs[..., None, :] + lightdirs)
        brdf_dot = math.dot(normals, halfdirs)
        pair = torch.cat([math.dot(normals, -viewdirs[..., None, :]),
                          math.dot(normals, lightdirs)], dim=-1)
        brdf_input = torch.cat([torch.sort(pair, dim=-1).values, brdf_dot], dim=-1)
        brdf_input = torch.cat([bottleneck, coord.pos_enc(brdf_input, 0, self.deg_brdf, True)],
                               dim=-1)
        return softplus(self.output_brdf_layer(self.brdf_layers(brdf_input)) + self.brdf_bias)

    def get_indirect(self, lights, feature):
        """Time-binned indirect irradiance [..., S, n_bins * C]."""
        x = torch.cat([feature, coord.pos_enc(lights, 0, self.deg_lights, True)], dim=-1)
        return self.irradiance_activation(
            self.transient_indirect_layer(self.irradiance_layers(x)) + self.irradiance_bias)

    def _light_radiance(self, light_dists, radiance_cache):
        """Constant-power point light with inverse-square falloff, of the
        shader's own power: also under a material model (`radiance_cache`)
        that does not share its light with the cache."""
        if radiance_cache is not None and radiance_cache.share_light_power:
            raise NotImplementedError("a material model's shared light power is not ported yet")
        light_radiance = torch.ones_like(light_dists) * self.light_power_activation(
            self.light_power)
        if self.config.use_falloff:
            light_radiance = light_radiance / torch.clamp(light_dists**2, min=1e-5)
        if self.config.light_zero:
            light_radiance = torch.where(light_dists < self.config.light_near,
                                         torch.zeros_like(light_radiance), light_radiance)
        light_radiance_before_occ = light_radiance
        light_radiance = stopgrad_with_weight(light_radiance, self.stopgrad_light_radiance_weight)
        return light_radiance, torch.ones_like(light_dists), light_radiance_before_occ

    def _occlusions(self, light_dists, is_secondary):
        cfg = self.config
        if (not cfg.use_occlusions or (not is_secondary and cfg.occlusions_secondary_only)
                or (is_secondary and cfg.occlusions_primary_only)):
            return torch.zeros_like(light_dists).repeat_interleave(self.num_rgb_channels, dim=-1)
        raise NotImplementedError("shadow rays are not ported yet")

    def _direct_lighting(self, rays, feature, shading_normals, bottleneck, n_dot_l,
                         light_radiance, light_dirs):
        albedo = self.albedo_activation(self.albedo_layer(feature) + self.albedo_bias)
        direct_tint = torch.sigmoid(self.direct_tint_layer(feature))
        light_brdf = self.get_brdf_light(shading_normals, rays.viewdirs, light_dirs, bottleneck)
        light_brdf = torch.where(n_dot_l == 0.0, torch.zeros_like(light_brdf), light_brdf)
        direct_diffuse = torch.clamp(albedo * n_dot_l * light_radiance / pymath.pi,
                                     0.0, self.rgb_max)
        direct_specular = torch.clamp(direct_tint * light_brdf * light_radiance, 0.0, self.rgb_max)
        direct_diffuse = stopgrad_with_weight(direct_diffuse, self.stopgrad_direct_weight)
        direct_specular = stopgrad_with_weight(direct_specular, self.stopgrad_direct_weight)
        return albedo, direct_diffuse, direct_specular

    def _indirect_lighting(self, rays, feature, means, normals, shading_normals, ref_rgb,
                           bottleneck):
        """Per-bin diffuse and specular indirect transients [..., S, bins, C]."""
        n_bins, num_ch = self.config.n_bins, self.config.num_rgb_channels
        integrated_brdf = self.get_integrated_brdf(normals, rays.viewdirs, bottleneck)
        tint = torch.sigmoid(self.tint_layer(feature))
        tint_expanded = tint[..., None, :].expand(tint.shape[:-1] + (n_bins, num_ch)).reshape(
            ref_rgb.shape)
        lights = rays.lights[..., None, :] * torch.ones_like(shading_normals)
        diffuse = self.get_indirect(lights, feature) * self.indirect_scale
        specular = tint_expanded * integrated_brdf * ref_rgb * self.indirect_scale
        shape = diffuse.shape[:-1] + (n_bins, num_ch)
        diffuse, specular = render_utils.zero_invalid_bins(
            diffuse.reshape(shape), specular.reshape(shape), rays, means, self.config)
        return torch.clamp(diffuse, 0.0, self.rgb_max), torch.clamp(specular, 0.0, self.rgb_max)

    def predict_appearance(self, rng, rays, sampler_results, train_frac=1.0, train=True,
                           is_secondary=False, radiance_cache=None, passes=(), **kwargs):
        feature, bottleneck, roughness, normals, shading_normals = self._appearance_inputs(
            rng, sampler_results, train, train_frac, is_secondary)
        means = sampler_results["means"]

        light_offset = rays.lights[..., None, :] - means
        light_dists = torch.linalg.norm(light_offset, dim=-1, keepdim=True)
        light_dirs = light_offset / torch.clamp(light_dists, min=1e-5)
        light_radiance, light_radiance_mult, light_radiance_before_occ = self._light_radiance(
            light_dists, radiance_cache)
        n_dot_l = torch.clamp(math.dot(shading_normals, light_dirs), min=0.0)
        if len(passes) == 0 or "occ" in passes:
            occ = self._occlusions(light_dists, is_secondary)
        else:
            occ = torch.zeros_like(n_dot_l)
        occ = torch.where(n_dot_l <= 0.0, torch.ones_like(occ), occ)
        light_radiance = light_radiance * (1.0 - occ)

        albedo, direct_diffuse, direct_specular = self._direct_lighting(
            rays, feature, shading_normals, bottleneck, n_dot_l, light_radiance, light_dirs)
        direct = direct_diffuse + direct_specular

        key, rng = torchutil.random_split(rng)
        incoming = self._query_surface_lf(key, rays, sampler_results, means, normals, roughness,
                                          bottleneck, train, train_frac)
        t_diffuse, t_specular = self._indirect_lighting(
            rays, feature, means, normals, shading_normals, incoming["incoming_rgb"], bottleneck)
        damp = lambda x: stopgrad_with_weight(x, self.stopgrad_indirect_weight)  # noqa: E731
        indirect_diffuse, indirect_specular = damp(t_diffuse.sum(-2)), damp(t_specular.sum(-2))
        indirect = indirect_diffuse + indirect_specular
        # use_ambient=False: the ambient terms are zero.
        ambient = torch.zeros_like(incoming["incoming_ambient_rgb"])

        if len(passes) > 0 and "indirect" not in passes:
            return {"rgb": direct, "direct_rgb": direct, "indirect_rgb": None,
                    "transient_indirect": None}

        rgb = direct + indirect
        like_rgb = lambda x: x * torch.ones_like(rgb)  # noqa: E731
        return dict(
            rgb=rgb,
            direct_rgb=direct,
            ambient_rgb=ambient,
            albedo_rgb=albedo,
            diffuse_rgb=direct_diffuse + indirect_diffuse,
            specular_rgb=direct_specular + indirect_specular,
            indirect_rgb=indirect,
            direct_diffuse_rgb=direct_diffuse,
            direct_specular_rgb=direct_specular,
            indirect_diffuse_rgb=indirect_diffuse,
            indirect_specular_rgb=indirect_specular,
            ambient_diffuse_rgb=ambient,
            ambient_specular_rgb=ambient,
            occ=like_rgb(occ) if "occ" not in sampler_results else torch.zeros_like(rgb),
            indirect_occ=like_rgb(incoming["incoming_acc"][..., None]),
            n_dot_l_rgb=like_rgb(n_dot_l),
            light_radiance_rgb=like_rgb(light_radiance_mult),
            irradiance_rgb=n_dot_l * light_radiance_before_occ / pymath.pi,
            ray_dists=torch.linalg.norm(rays.origins[..., None, :] - means, dim=-1, keepdim=True),
            light_dists=light_dists,
            transient_indirect=damp(t_diffuse + t_specular),
            transient_indirect_diffuse=damp(t_diffuse),
            transient_indirect_specular=damp(t_specular),
        )
