"""The radiance-cache shaders (counterpart of ``BaseNeRFMLP``, ``NeRFMLP``
and ``TransientNeRFMLP`` in ``models/nerf_shader.py``).

Both shaders pick their path by ``use_active``, as the JAX shaders do. The
passive path (``BaseNeRFMLP``; ``NeRFMLP``, the steady cache shader, takes
no other): ambient and indirect irradiance heads plus the
integrated-BRDF-weighted specular term fed by the surface light field along
the reflected view direction, and no transient of its own (the transient
render bins each sample's radiance as a pulse at its light path's length).

``TransientNeRFMLP``'s active path: a point light of learnable constant
power with inverse-square falloff, a diffuse (albedo) and a BRDF-net
specular direct term, and time-binned indirect radiance: an irradiance net
emitting n_bins x C channels (diffuse) plus the tinted, integrated-BRDF
weighted transient surface light field (specular), masked by
``zero_invalid_bins``, or, with ``use_indirect=False``, zeros repeated over
the bins (the render shifts them as JAX's does); with ``use_ambient`` an
untimed ambient term too (the ambient head, and the tinted, integrated-BRDF
weighted ambient radiance of the surface light field), which folds into the
indirect outputs.

Both shaders may query their own appearance hash grid (``use_grid``) at
the sample means, beside the density feature. The transient shader's light
takes the shader's own power, or a material model's shared power
(``share_light_power``): its learnable light, or the power the material
shader passes. With ``Config.use_occlusions`` (and the ``occlusions_*_only``
flags) its point light is shadowed by one shadow ray per sample, traced
through the cache's weights only (``_compute_occlusions``).

Under ``Config.multi_illumination`` the shaders read the ray's light index:
with ``use_illumination_feature`` each concatenates its illumination
embedding ``light_vecs`` to its feature, before the bottleneck and the heads
(JAX ``get_light_vec``). ``Config.multiple_illumination_outputs`` with more
than one illumination raises as the reference gap it is (``SLF_AMBIENT_GAP``).

With ``use_env_map`` the steady shader queries its own environment map
(``env_map``, an SLF over [env_map_near, env_map_far], which the cache
model hands it) along the reflected direction, and its specular ambient
term is that radiance where the surface light field is transparent; the
surface light field then ends at ``Config.env_map_distance``. With
``use_exposure_at_bottleneck`` the log exposure of each ray is added to the
bottleneck. The active point light can be a cone (``light_max_angle``),
the BRDF net can take n.h alone (``simple_brdf``), the indirect nets can
read the light in the surface's frame (``Config.light_canonical_frame``,
``canonical_light_features``) and be scaled by the light's intensity
(``Config.light_intensity_conditioning``). The steady shader's active path
(``NeRFMLP.use_active``) is the transient one's with C-channel indirect
radiance (``indirect_layer``) in place of the time-binned one.

Structured light (``Config.sl_relight``) raises as the reference gap it is
(``shading.SL_RELIGHT_GAP``), and so do a surface light field that decodes
per point (``PER_POINT_SLF_GAP``) and the passive transient shader's
environment map (``TRANSIENT_ENV_MAP_GAP``).
"""

from __future__ import annotations

import math as pymath

import numpy as np
import torch
from torch import nn

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models import shading, surface_light_field
from neural_radiance_caching_tpu_torch.models.layers import Dense, SkipMLP, clamp, softplus
from neural_radiance_caching_tpu_torch.ops import coord, math, ref_utils, render_utils
from neural_radiance_caching_tpu_torch.utils import torchutil
from neural_radiance_caching_tpu_torch.utils.torchutil import stopgrad_with_weight

# Config.multiple_illumination_outputs under Config.multi_illumination.
SLF_AMBIENT_GAP = (
    "Config.multiple_illumination_outputs = True with Config.multi_illumination and {n} "
    "illuminations is a reference gap: the JAX surface light field sizes its ambient head for "
    "every illumination (surface_light_field.py:239-241) and selects the ray's illumination for "
    "rgb only, never for ambient_rgb (:659-661), so the cache shader's tint * integrated_brdf * "
    "ref_rgb raises TypeError: mul got incompatible shapes for broadcasting (nerf_shader.py:531) "
    "at the first step; bind Config.multiple_illumination_outputs = False")
# A cache shader whose SLF decodes each point (per_ref_feature_output).
PER_POINT_SLF_GAP = (
    "SurfaceLightFieldMLP.per_ref_feature_output in a cache shader's SLF (surface_lf_params or "
    "env_map_params) is a reference gap: the JAX SLF's per-point decode returns no "
    "incoming_ambient_rgb (models/surface_light_field.py:590-605), and the cache shader reads "
    "it at the first query, raising KeyError: 'incoming_ambient_rgb' (nerf_shader.py:{line})")
# TransientNeRFMLP.use_env_map on the passive path.
TRANSIENT_ENV_MAP_GAP = (
    "TransientNeRFMLP.use_env_map with use_active=False is a reference gap: the JAX transient "
    "shader builds no EnvMap (nerf_shader.py:186) and its passive path reads self.env_map, "
    "raising AttributeError (nerf_shader.py:753)")


def canonical_light_features(lights, means, normals, viewdirs):
    """The light in the surface's frame [..., S, 5]: n.l, n.v, the dot and
    the product of the norms of l's and v's tangential parts, and the log
    light distance (l the unit point-to-light direction, v the unit view
    direction back to the camera). The frame's inputs take no gradient."""
    mu, n = means.detach(), normals.detach()
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-6)
    offset = lights - mu
    dist = torch.linalg.norm(offset, dim=-1, keepdim=True)
    l_dir = offset / torch.clamp(dist, min=1e-6)
    v_dir = -viewdirs * torch.ones_like(n)
    v_dir = v_dir / torch.clamp(torch.linalg.norm(v_dir, dim=-1, keepdim=True), min=1e-6)
    cos_l, cos_v = math.dot(n, l_dir), math.dot(n, v_dir)
    l_tan, v_tan = l_dir - cos_l * n, v_dir - cos_v * n
    sin_prod = (torch.linalg.norm(l_tan, dim=-1, keepdim=True)
                * torch.linalg.norm(v_tan, dim=-1, keepdim=True))
    return torch.cat([cos_l, cos_v, math.dot(l_tan, v_tan), sin_prod,
                      torch.log(torch.clamp(dist, min=1e-6))], dim=-1)


def cone_light(light_radiance, light_dirs, look, max_angle):
    """The radiance zeroed outside the light's cone: where the direction
    from the light to the point is more than `max_angle` / 2 degrees off
    the camera's look direction `look` [..., 3], or points behind it."""
    angle_dot = math.dot(-light_dirs, look[..., None, :])
    angle = torch.arccos(angle_dot)
    inside = (angle * 180.0 / pymath.pi <= max_angle / 2.0) & (angle_dot > 0.0)
    return torch.where(inside, light_radiance, torch.zeros_like(light_radiance))


class BaseNeRFMLP(shading.BaseShader):
    """Shared trunk, bottleneck, surface light field, integrated BRDF and
    light power of the cache shaders."""

    _has_pos_basis = True

    # Declared by the JAX cache shaders and read by nothing there.
    cull_backfacing = True
    use_normals_feature = False
    use_pred_normals_feature = False
    use_learned_vignette_map = False
    num_glo_features = 0
    num_glo_embeddings = 1000
    run_surface_light_field = True
    use_corrected_normals = False
    weight_thold = 0.0

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
    use_exposure_at_bottleneck = False
    # The illumination embedding's width, read under multi_illumination with
    # use_illumination_feature; the heads' selection field is read by
    # nothing in the cache shaders.
    num_light_features = 64
    use_illumination_feature = False
    multiple_illumination_outputs = True
    # The environment map's range and fields (use_env_map).
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
    # The shadow rays' (w_rays, w_out) gradient weights into the cache
    # (``Config.use_occlusions``).
    stopgrad_occ_weight = (0.0, 0.0)
    # The active path's light, direct terms and indirect nets (use_active).
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
    # Declared by the JAX cache shaders and read by nothing there; as in
    # JAX, shadow rays follow Config.use_occlusions, not use_occlusions.
    use_occlusions = False
    enable_pred_roughness = False
    use_specular_tint = False

    slf_cls = surface_light_field.SurfaceLightFieldMLP
    # The indirect head emits n_bins x C channels (the transient shader).
    _binned_indirect = False

    def __init__(self, config=None, density_feature_dim=0, **kwargs):
        super().__init__(config, **kwargs)
        if (config.multi_illumination and config.multiple_illumination_outputs
                and config.num_illuminations > 1):
            raise NotImplementedError(SLF_AMBIENT_GAP.format(n=config.num_illuminations))
        cd = self.compute_dtype
        feature_dim = self._build_trunk(density_feature_dim)
        if self.reads_illumination_feature:
            feature_dim += self._make_light_vecs()
        self.bottleneck_layer = Dense(feature_dim, self.bottleneck_width, cd)
        slf_params = dict(self.surface_lf_params or {})
        slf_params["distance_near"] = self.surface_lf_distance_near
        slf_params["distance_far"] = (
            config.env_map_distance if self.use_env_map and config.env_map_distance < float("inf")
            else self.surface_lf_distance_far)
        self.surface_lf = self.slf_cls(
            config=config, use_env_alpha=True, shader_bottleneck_dim=self.bottleneck_width,
            **slf_params)
        if self.surface_lf.decodes_per_point:
            raise NotImplementedError(PER_POINT_SLF_GAP.format(
                line=632 if self.use_active else 772))
        if self.use_env_map and not config.use_transient:
            self.env_map = surface_light_field.SurfaceLightFieldMLP(
                config=config, shader_bottleneck_dim=self.bottleneck_width,
                **dict(self.env_map_params or {}, distance_near=self.env_map_near,
                       distance_far=self.env_map_far))
            if self.env_map.decodes_per_point:
                raise NotImplementedError(PER_POINT_SLF_GAP.format(line=756))
        elif self.use_env_map and not self.use_active:
            raise NotImplementedError(TRANSIENT_ENV_MAP_GAP)
        self._build_heads(feature_dim)
        if self._reads_tint:
            self.integrated_brdf_layers = SkipMLP(
                self.bottleneck_width + 1,
                [self.net_width_integrated_brdf] * self.net_depth_integrated_brdf,
                self.skip_layer_integrated_brdf, self.net_activation, cd)
            self.output_integrated_brdf_layer = Dense(self.integrated_brdf_layers.out_dim, 1, cd)
        if self.optimize_light:
            self.light_power = nn.Parameter(torch.full((1,), float(self.light_power_bias)))

    def _build_heads(self, feature_dim):
        """The path's heads. A path builds the heads it reads, as JAX
        creates a head's parameters at its first call (the integrated BRDF
        wherever ``_reads_tint``, in ``__init__``)."""
        if self.use_active:
            return self._build_active_heads(feature_dim)
        cd = self.compute_dtype
        rgb = self.config.num_rgb_channels
        self.irradiance_layer = Dense(feature_dim, rgb, cd)
        self.ambient_irradiance_layer = Dense(feature_dim, rgb, cd)
        self.tint_layer = Dense(feature_dim, rgb, cd)
        self.roughness_layer = Dense(feature_dim, 1, cd)

    @property
    def _reads_tint(self):
        """The passive path reads the tint and the integrated BRDF; the
        active one only for its indirect or its ambient term."""
        return not self.use_active or self.use_indirect or self.use_ambient

    def get_bottleneck_feature(self, rng, feature, exposure=None):
        bottleneck = self.bottleneck_layer(feature)
        if rng is not None and self.bottleneck_noise > 0:
            bottleneck = bottleneck + self.bottleneck_noise * torchutil.normal(
                rng, bottleneck.shape, bottleneck.device)
        if self.use_exposure_at_bottleneck and exposure is not None:
            bottleneck = bottleneck + torch.log(exposure)[..., None, :]
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

    def _appearance_inputs(self, rng, rays, sampler_results, train, train_frac, is_secondary):
        """(feature, bottleneck, roughness, normals, shading normals)."""
        key, rng = torchutil.random_split(rng)
        feature = self.predict_appearance_feature(
            sampler_results, train=train, train_frac=train_frac, is_secondary=bool(is_secondary),
            **self.get_predict_appearance_kwargs(key, rays, sampler_results))
        if self.reads_illumination_feature:
            feature = torch.cat([feature, self.get_light_vec(rays, feature)], dim=-1)
        key, rng = torchutil.random_split(rng)
        bottleneck = self.get_bottleneck_feature(key, feature, rays.exposure_values)
        roughness = self.roughness_activation(self.roughness_layer(feature) + self.roughness_bias)
        normals = shading_normals = sampler_results[self.normals_target]
        if self.stopgrad_normals_weight < 1.0:
            normals = stopgrad_with_weight(normals, self.stopgrad_normals_weight)
        if self.stopgrad_shading_normals_weight < 1.0:
            shading_normals = stopgrad_with_weight(shading_normals,
                                                   self.stopgrad_shading_normals_weight)
        return feature, bottleneck, roughness, normals, shading_normals

    def _query_reflected_light(self, module, rng, rays, sampler_results, means, normals,
                               roughness, bottleneck, train, train_frac):
        """An SLF module (the surface light field or the environment map)
        along the reflected view direction at the points."""
        return module(
            rng, rays, sampler_results, means, self._get_refdirs(rays.viewdirs, normals),
            roughness=roughness, shader_bottleneck=bottleneck, train=train,
            train_frac=train_frac)

    def predict_appearance(self, rng, rays, sampler_results, train_frac=1.0, train=True,
                           is_secondary=False, radiance_cache=None, light_power=None, passes=(),
                           filtered_sampler_results=None, **kwargs):
        """The path ``use_active`` picks (JAX ``predict_appearance``)."""
        key, rng = torchutil.random_split(rng)
        inputs = self._appearance_inputs(key, rays, sampler_results, train, train_frac,
                                         is_secondary)
        fn = self._predict_appearance_active if self.use_active else self._predict_appearance_passive
        key, rng = torchutil.random_split(rng)
        return fn(key, rays, sampler_results, *inputs, train_frac=train_frac, train=train,
                  is_secondary=is_secondary, radiance_cache=radiance_cache,
                  light_power=light_power, passes=passes,
                  filtered_sampler_results=filtered_sampler_results, **kwargs)

    def _predict_appearance_passive(self, rng, rays, sampler_results, feature, bottleneck,
                                    roughness, normals, shading_normals, train_frac=1.0,
                                    train=True, passes=(), **kwargs):
        """Ambient and indirect irradiance heads and the SLF's specular term
        (JAX ``_predict_appearance_passive``); no light, no transient."""
        del shading_normals, kwargs
        means = sampler_results["means"]
        viewdirs = rays.viewdirs

        ambient_irradiance = self.ambient_irradiance_activation(
            self.ambient_irradiance_layer(feature) + self.ambient_irradiance_bias)
        ambient_diffuse = stopgrad_with_weight(
            torch.clamp(ambient_irradiance, 0.0, self.rgb_max), self.stopgrad_ambient_weight)
        tint = torch.sigmoid(self.tint_layer(feature))
        integrated_brdf = self.get_integrated_brdf(normals, viewdirs, bottleneck)
        if self.use_env_map:
            key, rng = torchutil.random_split(rng)
            env_rgb = self._query_reflected_light(
                self.env_map, key, rays, sampler_results, means, normals, roughness, bottleneck,
                train, train_frac)["incoming_ambient_rgb"]
        else:
            env_rgb = torch.zeros_like(ambient_diffuse)

        indirect_irradiance = self.irradiance_activation(
            self.irradiance_layer(feature) + self.irradiance_bias)
        indirect_diffuse = stopgrad_with_weight(
            torch.clamp(indirect_irradiance, 0.0, self.rgb_max), self.stopgrad_indirect_weight)

        key, rng = torchutil.random_split(rng)
        incoming = self._query_reflected_light(self.surface_lf, key, rays, sampler_results, means,
                                               normals, roughness, bottleneck, train, train_frac)
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

    # --- the active path (a point light, BRDF-net direct terms, indirect nets) -------

    @property
    def _indirect_channels(self):
        """The indirect head's width: C, or n_bins x C time-binned."""
        rgb = self.config.num_rgb_channels
        return rgb * self.config.n_bins if self._binned_indirect else rgb

    @property
    def _indirect_head(self):
        return self.transient_indirect_layer if self._binned_indirect else self.indirect_layer

    def _build_active_heads(self, feature_dim):
        """The active path's heads (JAX creates them at their first call)."""
        cd = self.compute_dtype
        rgb = self.config.num_rgb_channels
        # With use_ambient=False nothing reads the ambient head; the JAX
        # shader evaluates it all the same, so its parameters exist (and no
        # loss reaches them then).
        self.ambient_irradiance_layer = Dense(feature_dim, rgb, cd)
        if self._reads_tint:
            self.tint_layer = Dense(feature_dim, rgb, cd)
        self.roughness_layer = Dense(feature_dim, 1, cd)
        self.albedo_layer = Dense(feature_dim, rgb, cd)
        self.direct_tint_layer = Dense(feature_dim, rgb, cd)
        brdf_in = self.bottleneck_width + (2 if self.simple_brdf else 3) * (1 + 2 * self.deg_brdf)
        self.brdf_layers = SkipMLP(brdf_in, [self.net_width_brdf] * self.net_depth_brdf,
                                   self.skip_layer_brdf, self.net_activation, cd)
        self.output_brdf_layer = Dense(self.brdf_layers.out_dim, 1, cd)
        if not self.use_indirect:
            return
        light_channels = 5 if self.config.light_canonical_frame else 3
        lights_in = feature_dim + light_channels * (1 + 2 * self.deg_lights)
        self.irradiance_layers = SkipMLP(
            lights_in,
            [self.net_width_irradiance] * (self.net_depth_irradiance - 1)
            + [self.bottleneck_irradiance],
            self.skip_layer_irradiance, self.net_activation, cd)
        head = Dense(self.irradiance_layers.out_dim, self._indirect_channels, cd)
        if self._binned_indirect:
            self.transient_indirect_layer = head
        else:
            self.indirect_layer = head

    def get_brdf_light(self, normals, viewdirs, lightdirs, bottleneck):
        """Point-light BRDF net conditioned on the sorted (n.v, n.l) and n.h
        (on n.h twice under ``simple_brdf``)."""
        halfdirs = math.normalize(-viewdirs[..., None, :] + lightdirs)
        brdf_dot = math.dot(normals, halfdirs)
        if self.simple_brdf:
            brdf_input = torch.cat([brdf_dot, brdf_dot], dim=-1)
        else:
            pair = torch.cat([math.dot(normals, -viewdirs[..., None, :]),
                              math.dot(normals, lightdirs)], dim=-1)
            brdf_input = torch.cat([torch.sort(pair, dim=-1).values, brdf_dot], dim=-1)
        brdf_input = torch.cat([bottleneck, coord.pos_enc(brdf_input, 0, self.deg_brdf, True)],
                               dim=-1)
        return softplus(self.output_brdf_layer(self.brdf_layers(brdf_input)) + self.brdf_bias)

    def light_conditioning(self, rays, means, normals):
        """The light as the indirect nets read it at each sample: its
        position, or under ``Config.light_canonical_frame`` its features in
        the surface's frame (``canonical_light_features``)."""
        if not self.config.light_canonical_frame:
            return rays.lights[..., None, :] * torch.ones_like(normals)
        return canonical_light_features(rays.lights[..., None, :], means, normals,
                                        rays.viewdirs[..., None, :])

    def _light_radiance(self, rays, sampler_results, light_dists, radiance_cache, light_power):
        """(light radiance, its multiplier, the radiance before occlusion) at
        each sample: a point light with inverse-square falloff of the
        shader's own power (zero outside its cone of ``light_max_angle``
        about the camera's look direction), or, under a material model that
        shares its light power (``radiance_cache.share_light_power``), the
        material shader's learnable light (``Config.learnable_light``) or
        the `light_power` it passes."""
        cfg = self.config
        share = getattr(radiance_cache, "share_light_power", False)
        light_radiance_mult = torch.ones_like(light_dists)
        if cfg.learnable_light and share:
            if not hasattr(getattr(radiance_cache, "shader", None), "learnable_light"):
                raise ValueError("a shared learnable light is read from the material model's "
                                 "shader, and this radiance_cache has none")
            means = sampler_results["means"]
            ones = torch.ones_like(means)
            light_radiance, light_radiance_mult = radiance_cache.shader.learnable_light(
                means, rays.viewdirs[..., None, :] * ones, rays.lights[..., None, :] * ones,
                rays.vcam_look[..., None, :] * ones, rays.vcam_up[..., None, :] * ones,
                rays.vcam_origins[..., None, :] * ones)
        else:
            if light_power is None or not share:
                power = (self.light_power if self.optimize_light
                         else torch.tensor(float(self.light_power_bias), device=light_dists.device))
                light_power = self.light_power_activation(power)
            light_radiance = torch.ones_like(light_dists) * light_power
            if cfg.use_falloff:
                light_radiance = light_radiance / torch.clamp(light_dists**2, min=1e-5)
            if self.light_max_angle > 0.0:
                light_dirs = ((rays.lights[..., None, :] - sampler_results["means"])
                              / torch.clamp(light_dists, min=1e-5))
                light_radiance = cone_light(light_radiance, light_dirs, rays.vcam_look,
                                            self.light_max_angle)
        if cfg.light_zero:
            light_radiance = torch.where(light_dists < cfg.light_near,
                                         torch.zeros_like(light_radiance), light_radiance)
        light_radiance_before_occ = light_radiance
        light_radiance = stopgrad_with_weight(light_radiance, self.stopgrad_light_radiance_weight)
        return light_radiance, light_radiance_mult, light_radiance_before_occ

    def _compute_occlusions(self, rng, rays, light_dists, radiance_cache, train_frac, train,
                            is_secondary, filtered):
        """Shadow rays: one ray from each (filtered) sample toward the light,
        traced through the cache's weights only; its opacity, thresholded,
        is the sample's occlusion [..., S, C].

        Nothing of the pass reaches a gradient (JAX stops it at the
        proposals, the weights and the opacity), so it runs without a graph;
        the cache's weights-only pass renders the opacity alone.
        """
        cfg = self.config
        if (not cfg.use_occlusions or (not is_secondary and cfg.occlusions_secondary_only)
                or (is_secondary and cfg.occlusions_primary_only)):
            return torch.zeros_like(light_dists).repeat_interleave(self.num_rgb_channels, dim=-1)
        if radiance_cache is None:
            raise ValueError("shadow rays are traced through a radiance_cache, and none was given")

        def ramp(start, rate, lo, hi):
            """lo after the ramp over train_frac, hi before it, in float32."""
            if rate <= 0:
                return lo
            f32 = np.float32
            w = np.clip((f32(train_frac) - f32(start)) / f32(rate), f32(0), f32(1))
            return float(w * f32(lo) + (f32(1) - w) * f32(hi))

        shadow_near = ramp(cfg.shadow_near_start_frac, cfg.shadow_near_rate,
                           cfg.shadow_near_min, cfg.shadow_near_max)
        means = filtered["means"]
        normals = filtered[cfg.shadow_normals_target]
        with torch.no_grad():
            key, rng = torchutil.random_split(rng)
            ref_rays, _ = render_utils.get_secondary_rays(
                key, rays, means, rays.viewdirs, normals,
                {"roughness": torch.ones_like(light_dists)}, refdir_eps=shadow_near,
                normal_eps=cfg.secondary_normal_eps,
                random_generator_2d=radiance_cache.random_generator_2d, use_mis=True,
                samplers=radiance_cache.active_importance_samplers, num_secondary_samples=1,
                light_sampler_results={
                    "origins": means[..., None, :],
                    "lights": rays.lights[..., None, None, :] * torch.ones_like(
                        means[..., None, :])},
                far=cfg.secondary_far)
            single_light_dists = torch.linalg.norm(rays.lights[..., None, :] - means, dim=-1,
                                                   keepdim=True)
            ref_rays = ref_rays.replace(
                far=torch.clamp(single_light_dists.reshape(ref_rays.far.shape) - cfg.light_near,
                                ref_rays.near, ref_rays.far),
                normals=normals.reshape(ref_rays.viewdirs.shape))
            key, rng = torchutil.random_split(rng)
            acc = radiance_cache.cache(
                key, ref_rays, train_frac=train_frac, train=train, compute_extras=False,
                stopgrad_proposal=True, stopgrad_weights=True, is_secondary=True,
                weights_only=True, radiance_cache=radiance_cache,
                stopgrad_cache_weight=self.stopgrad_occ_weight)["render"]["acc"]
            occ = acc.reshape(single_light_dists.shape[:-1] + (1,)).repeat_interleave(
                self.num_rgb_channels, dim=-1)
            baseline = torch.linalg.norm(rays.lights[..., None, :] - rays.origins[..., None, :],
                                         dim=-1, keepdim=True)
            occ = torch.where(baseline < 1e-3, torch.zeros_like(occ), occ)
            occ_threshold = ramp(cfg.occ_threshold_start_frac, cfg.occ_threshold_rate,
                                 cfg.occ_threshold_min, cfg.occ_threshold_max)
            return torch.where(occ <= occ_threshold, torch.zeros_like(occ), occ)

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

    def get_indirect(self, lights, feature):
        """Indirect irradiance [..., S, C] (n_bins x C time-binned)."""
        x = torch.cat([feature, coord.pos_enc(lights, 0, self.deg_lights, True)], dim=-1)
        return self.irradiance_activation(
            self._indirect_head(self.irradiance_layers(x)) + self.irradiance_bias)

    def _indirect_lighting(self, rays, feature, means, shading_normals, ref_rgb, tint,
                           integrated_brdf, light_radiance_mult):
        """Diffuse and specular indirect radiance [..., S, C], per bin
        [..., S, bins, C] on the transient shader (masked by
        ``zero_invalid_bins`` and clamped to rgb_max): zeros without
        ``use_indirect``; under ``Config.light_intensity_conditioning``
        both scaled by the light's multiplier (affinely)."""
        cfg = self.config
        n_bins, num_ch = cfg.n_bins, cfg.num_rgb_channels
        lead = feature.shape[:-1] + ((n_bins,) if self._binned_indirect else ())
        if not self.use_indirect:
            zero = torch.zeros(lead + (num_ch,), dtype=feature.dtype, device=feature.device)
            return zero, zero
        lights = self.light_conditioning(rays, means, shading_normals)
        diffuse = self.get_indirect(lights, feature) * self.indirect_scale
        # JAX's tint repeated over the bins, (tint * brdf) * rgb per element,
        # broadcast: no [..., bins, C] copy of the tint is formed or kept.
        tint_brdf = tint * integrated_brdf
        if self._binned_indirect:
            tint_brdf = tint_brdf[..., None, :]
        specular = (tint_brdf * ref_rgb.reshape(lead + (num_ch,))) * self.indirect_scale
        if cfg.light_intensity_conditioning:
            scale = (light_radiance_mult * cfg.light_intensity_conditioning_scale
                     + cfg.light_intensity_conditioning_bias)
            diffuse = diffuse * scale
            specular = specular * (scale[..., None, :] if self._binned_indirect else scale)
        if not self._binned_indirect:
            return diffuse, specular
        diffuse, specular = render_utils.zero_invalid_bins(
            diffuse.reshape(lead + (num_ch,)), specular, rays, means, cfg)
        return clamp(diffuse, 0.0, self.rgb_max), clamp(specular, 0.0, self.rgb_max)

    def _predict_appearance_active(self, rng, rays, sampler_results, feature, bottleneck,
                                   roughness, normals, shading_normals, train_frac=1.0,
                                   train=True, is_secondary=False, radiance_cache=None,
                                   light_power=None, passes=(), filtered_sampler_results=None,
                                   **kwargs):
        del kwargs
        means = sampler_results["means"]

        light_offset = rays.lights[..., None, :] - means
        light_dists = torch.linalg.norm(light_offset, dim=-1, keepdim=True)
        light_dirs = light_offset / torch.clamp(light_dists, min=1e-5)
        light_radiance, light_radiance_mult, light_radiance_before_occ = self._light_radiance(
            rays, sampler_results, light_dists, radiance_cache, light_power)
        n_dot_l = torch.clamp(math.dot(shading_normals, light_dirs), min=0.0)
        if len(passes) == 0 or "occ" in passes:
            key, rng = torchutil.random_split(rng)
            occ = self._compute_occlusions(
                key, rays, light_dists, radiance_cache, train_frac, train, is_secondary,
                sampler_results if filtered_sampler_results is None
                else filtered_sampler_results)
        else:
            occ = torch.zeros_like(n_dot_l)
        occ = torch.where(n_dot_l <= 0.0, torch.ones_like(occ), occ)
        light_radiance = light_radiance * (1.0 - occ)

        albedo, direct_diffuse, direct_specular = self._direct_lighting(
            rays, feature, shading_normals, bottleneck, n_dot_l, light_radiance, light_dirs)
        direct = direct_diffuse + direct_specular

        key, rng = torchutil.random_split(rng)
        incoming = self._query_reflected_light(self.surface_lf, key, rays, sampler_results, means,
                                               normals, roughness, bottleneck, train, train_frac)
        tint = integrated_brdf = None
        if self._reads_tint:
            integrated_brdf = self.get_integrated_brdf(normals, rays.viewdirs, bottleneck)
            tint = torch.sigmoid(self.tint_layer(feature))
        t_diffuse, t_specular = self._indirect_lighting(
            rays, feature, means, shading_normals, incoming["incoming_rgb"], tint,
            integrated_brdf, light_radiance_mult)
        damp = lambda x: stopgrad_with_weight(x, self.stopgrad_indirect_weight)  # noqa: E731
        if self._binned_indirect:
            indirect_diffuse, indirect_specular = damp(t_diffuse.sum(-2)), damp(t_specular.sum(-2))
        else:
            indirect_diffuse, indirect_specular = damp(t_diffuse), damp(t_specular)
        indirect = indirect_diffuse + indirect_specular
        ambient_ref_rgb = incoming["incoming_ambient_rgb"]
        if self.use_ambient:
            # Clamped to rgb_max, then damped by stopgrad_ambient_weight.
            damp_ambient = lambda x: stopgrad_with_weight(  # noqa: E731
                torch.clamp(x, 0.0, self.rgb_max), self.stopgrad_ambient_weight)
            ambient_diffuse = damp_ambient(self.ambient_irradiance_activation(
                self.ambient_irradiance_layer(feature) + self.ambient_irradiance_bias))
            ambient_specular = damp_ambient(tint * integrated_brdf * ambient_ref_rgb)
        else:
            ambient_diffuse = ambient_specular = torch.zeros_like(ambient_ref_rgb)
        ambient = ambient_diffuse + ambient_specular

        if len(passes) > 0 and "indirect" not in passes:
            return {"rgb": direct, "direct_rgb": direct, "indirect_rgb": None,
                    "transient_indirect": None}

        rgb = direct + ambient + indirect
        like_rgb = lambda x: x * torch.ones_like(rgb)  # noqa: E731
        transient = (dict(transient_indirect=damp(t_diffuse + t_specular),
                          transient_indirect_diffuse=damp(t_diffuse),
                          transient_indirect_specular=damp(t_specular))
                     if self._binned_indirect else dict(transient_indirect=None))
        # The ambient term folds into the indirect outputs.
        return dict(
            rgb=rgb,
            direct_rgb=direct,
            ambient_rgb=ambient,
            albedo_rgb=albedo,
            diffuse_rgb=direct_diffuse + indirect_diffuse + ambient_diffuse,
            specular_rgb=direct_specular + indirect_specular + ambient_specular,
            indirect_rgb=indirect + ambient,
            direct_diffuse_rgb=direct_diffuse,
            direct_specular_rgb=direct_specular,
            indirect_diffuse_rgb=indirect_diffuse + ambient_diffuse,
            indirect_specular_rgb=indirect_specular + ambient_specular,
            ambient_diffuse_rgb=ambient_diffuse,
            ambient_specular_rgb=ambient_specular,
            occ=like_rgb(occ) if "occ" not in sampler_results else torch.zeros_like(rgb),
            indirect_occ=like_rgb(incoming["incoming_acc"][..., None]),
            n_dot_l_rgb=like_rgb(n_dot_l),
            light_radiance_rgb=like_rgb(light_radiance_mult),
            irradiance_rgb=n_dot_l * light_radiance_before_occ / pymath.pi,
            ray_dists=torch.linalg.norm(rays.origins[..., None, :] - means, dim=-1, keepdim=True),
            light_dists=light_dists,
            **transient,
        )


@gin.configurable
class NeRFMLP(BaseNeRFMLP):
    """Steady-state cache shader: the passive path, or the active one
    (``use_active``) with C-channel indirect radiance."""

    def __init__(self, config=None, density_feature_dim=0, **kwargs):
        super().__init__(config, density_feature_dim, **kwargs)
        if config.use_transient:
            raise NotImplementedError("the transient cache shader is TransientNeRFMLP")
        if config.sl_relight and self.use_active:
            raise NotImplementedError(shading.SL_RELIGHT_GAP)


@gin.configurable
class TransientNeRFMLP(BaseNeRFMLP):
    """Time-resolved cache shader: the active path's per-point time-binned
    indirect radiance, or the passive path (``use_active=False``)."""

    use_active = True
    _binned_indirect = True

    slf_cls = surface_light_field.TransientSurfaceLightFieldMLP

    def __init__(self, config=None, density_feature_dim=0, **kwargs):
        super().__init__(config, density_feature_dim, **kwargs)
        if not config.use_transient:
            raise ValueError("TransientNeRFMLP needs Config.use_transient")
        if config.sl_relight and self.use_active:
            raise NotImplementedError(shading.SL_RELIGHT_GAP)
