"""Volume integrators: composite shader samples into per-ray renderings
(counterpart of ``VolumeIntegrator`` and ``TransientVolumeIntegrator`` in
``models/integrator.py``), for the cache, the material pass, the transient
cache and the transient material pass; the colour correction net and random
backgrounds are not ported yet."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models.layers import Configurable
from neural_radiance_caching_tpu_torch.ops import image, render

# Keys composited by alpha blending when present in shader results.
_EXTRAS_TO_RENDER = [
    "lighting_irradiance", "material_albedo", "material_roughness", "material_F_0",
    "material_metalness", "material_diffuseness", "material_mirrorness", "means",
    "normals", "normals_pred", "normals_to_use", "normals_shading", "irradiance_cache",
    "irradiance_cache_rgb", "incoming_rgb", "incoming_s_dist", "person_rgb",
    "person_alpha", "diffuse_rgb", "specular_rgb", "occ", "indirect_occ", "direct_rgb",
    "indirect_rgb", "ambient_rgb", "irradiance_rgb", "light_radiance_rgb", "n_dot_l_rgb",
    "albedo_rgb", "direct_diffuse_rgb", "direct_specular_rgb", "indirect_diffuse_rgb",
    "indirect_specular_rgb", "ambient_diffuse_rgb", "ambient_specular_rgb", "light_dists",
    "ray_dists", "transient_indirect", "transient_indirect_specular",
    "transient_indirect_diffuse", "impulse_response",
]
_EXTRAS_TO_ALWAYS_RENDER = [
    k for k in _EXTRAS_TO_RENDER
    if k not in (
        "material_albedo", "material_roughness", "material_F_0", "material_metalness",
        "material_diffuseness", "material_mirrorness", "normals_shading", "incoming_rgb",
        "incoming_s_dist", "person_rgb", "person_alpha",
    )
] + ["beta"]


@gin.configurable
class VolumeIntegrator(Configurable, nn.Module, unported=dict(
        net_activation=F.relu, net_depth=4, net_width=256, skip_layer=2, deg_view=4,
        deg_origins=4, normalize_weights=False)):
    """Alpha-composite shader results."""

    bg_intensity_range = (1.0, 1.0)
    use_color_net = False

    def __init__(self, config=None, **kwargs):
        nn.Module.__init__(self)
        self.config = config
        self._set_fields(kwargs)
        self._require(use_color_net=False)

    def forward(self, rng, rays, shader_results, train_frac=1.0, train=True,
                percentiles=(5, 50, 95), linear_rgb=False, compute_extras=False,
                compute_distance=True, bg_intensity_range=None, **kwargs):
        del rng, rays, train_frac, train, kwargs
        lo, hi = self.bg_intensity_range if bg_intensity_range is None else bg_intensity_range
        if lo != hi:
            raise NotImplementedError("random backgrounds are not ported yet")

        extras_keys = _EXTRAS_TO_RENDER if compute_extras else _EXTRAS_TO_ALWAYS_RENDER
        rendering = render.volumetric_rendering(
            shader_results["rgb"], shader_results["weights"], shader_results["weights_no_filter"],
            shader_results["tdist"], lo, compute_extras,
            extras={k: v for k, v in shader_results.items() if k in extras_keys},
            percentiles=percentiles, compute_distance=compute_distance,
        )
        if not linear_rgb and self.config.linear_to_srgb and rendering["rgb"] is not None:
            rendering["rgb"] = torch.clamp(image.linear_to_srgb(rendering["rgb"]), min=0.0)
        return rendering


@gin.configurable
class TransientVolumeIntegrator(VolumeIntegrator):
    """Time-resolved compositing: [..., n_bins, C] renderings.

    The transient shift and dark level come from the learnable light of the
    material model passed as `radiance_cache` (its shader's
    ``learnable_light``) when ``Config.learnable_light`` is set, and are the
    Config's constants (``transient_shift``, 0) otherwise, as for a cache
    stage. Under ``material=True`` (the material integrator) both are
    detached, so only the cache's renderings train them. Secondary rays get
    neither, nor the impulse filter when ``filter_indirect`` is set. The
    indirect shift form is ``Config.transient_shift_form``.
    """

    def forward(self, rng, rays, shader_results, train_frac=1.0, train=True,
                percentiles=(5, 50, 95), linear_rgb=False, compute_extras=False,
                compute_distance=True, bg_intensity_range=None, is_secondary=False,
                radiance_cache=None, material=False, **kwargs):
        del rng, train_frac, train, kwargs
        lo, hi = self.bg_intensity_range if bg_intensity_range is None else bg_intensity_range
        if lo != hi:
            raise NotImplementedError("random backgrounds are not ported yet")
        cfg = self.config
        if cfg.learnable_light and radiance_cache is not None:
            light = radiance_cache.shader.learnable_light
            transient_shift, dark_level = light.get_transient_shift(), light.get_dark_level()
        else:
            transient_shift, dark_level = cfg.transient_shift, 0.0
        if material:
            transient_shift, dark_level = (
                v.detach() if isinstance(v, torch.Tensor) else v
                for v in (transient_shift, dark_level))
        filter_primary = not is_secondary or not cfg.filter_indirect
        extras_keys = _EXTRAS_TO_RENDER if compute_extras else _EXTRAS_TO_ALWAYS_RENDER
        rendering = render.volumetric_transient_rendering(
            shader_results["direct_rgb"], shader_results["transient_indirect"],
            shader_results["weights"], shader_results["weights_no_filter"],
            shader_results["tdist"], lo, compute_extras,
            extras={k: v for k, v in shader_results.items() if k in extras_keys},
            percentiles=percentiles, compute_distance=compute_distance, n_bins=cfg.n_bins,
            shift=0.0 if is_secondary else transient_shift,
            dark_level=0.0 if is_secondary else dark_level,
            impulse_response=rays.impulse_response if filter_primary else None,
            tfilter_sigma=cfg.tfilter_sigma if filter_primary else 0.0,
            exposure_time=cfg.exposure_time, filter_indirect=cfg.filter_indirect,
            filter_median=cfg.filter_median and not is_secondary,
            filter_median_thresh=cfg.filter_median_thresh,
            no_shift_direct=cfg.no_shift_direct and cfg.vis_only,
            shift_form=cfg.transient_shift_form,
        )
        if not linear_rgb and cfg.linear_to_srgb and rendering["rgb"] is not None:
            rendering["rgb"] = torch.clamp(image.linear_to_srgb(rendering["rgb"]), min=0.0)
        return rendering
