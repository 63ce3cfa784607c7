"""Volume integrator: composite shader samples into per-ray renderings
(counterpart of ``VolumeIntegrator`` in ``models/integrator.py``; the colour
correction net and the transient integrators are not ported yet)."""

from __future__ import annotations

import torch
from torch import nn

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


class VolumeIntegrator(Configurable, nn.Module):
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
