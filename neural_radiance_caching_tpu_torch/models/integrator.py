"""Volume integrators: composite shader samples into per-ray renderings
(counterpart of ``VolumeIntegrator``, ``GeometryVolumeIntegrator`` and
``TransientVolumeIntegrator`` in ``models/integrator.py``), for the cache,
the material pass, the transient cache and the transient material pass.

A random background (``bg_intensity_range`` with lo != hi) composites a
normal draw of scale hi - lo per ray, and reports ``bg_noise``, the
background's share of the render, which is taken out of the rgb (the data
loss adds its square). Without a generator the background is 0. Under
``use_color_net`` a colour network (``layer.{i}``, ``output_layer``) over the
rays' encoded view directions and origins multiplies the rgb by exp(.) of
its output, except for linear renders (the secondary rays'). Its layers are
built with the integrator when it is switched on, as JAX creates them at
its first call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models.layers import Configurable, Dense
from neural_radiance_caching_tpu_torch.ops import coord, image, math, render
from neural_radiance_caching_tpu_torch.utils import torchutil

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
# Time-binned shader outputs the transient integrator does not composite
# as extras: "transient_indirect" (the renderer writes its shifted composite
# under that key over the extra), and in a train step (compute_extras=False)
# the diffuse and specular parts, which no loss reads from the render. Each
# is a [rays, samples, bins, C] product that JAX's compiler drops unread.
_UNRENDERED_EXTRAS = ("transient_indirect",)
_TRAIN_UNRENDERED_EXTRAS = ("transient_indirect_diffuse", "transient_indirect_specular")
_EXTRAS_TO_ALWAYS_RENDER = [
    k for k in _EXTRAS_TO_RENDER
    if k not in (
        "material_albedo", "material_roughness", "material_F_0", "material_metalness",
        "material_diffuseness", "material_mirrorness", "normals_shading", "incoming_rgb",
        "incoming_s_dist", "person_rgb", "person_alpha",
    )
] + ["beta"]


@gin.configurable
class VolumeIntegrator(Configurable, nn.Module):
    """Alpha-composite shader results."""

    bg_intensity_range = (1.0, 1.0)
    use_color_net = False
    net_activation = staticmethod(F.relu)
    net_depth = 4
    net_width = 256
    skip_layer = 2
    deg_view = 4
    deg_origins = 4
    # Read by GeometryVolumeIntegrator only (as in JAX).
    normalize_weights = False

    def __init__(self, config=None, **kwargs):
        nn.Module.__init__(self)
        self.config = config
        self._set_fields(kwargs)
        if self.use_color_net:
            in_dim = 3 * (1 + 2 * self.deg_view) + 3 * (1 + 2 * self.deg_origins)
            layers, d = [], in_dim
            for i in range(self.net_depth):
                layers.append(Dense(d, self.net_width))
                d = self.net_width + (in_dim if i % self.skip_layer == 0 and i > 0 else 0)
            self.layer = nn.ModuleList(layers)
            self.output_layer = Dense(d, 3)

    def run_color_network(self, viewdirs, origins):
        x = torch.cat([coord.pos_enc(viewdirs, 0, self.deg_view, True),
                       coord.pos_enc(origins, 0, self.deg_origins, True)], dim=-1)
        inputs = x
        for i, layer in enumerate(self.layer):
            x = self.net_activation(layer(x))
            if i % self.skip_layer == 0 and i > 0:
                x = torch.cat([x, inputs], dim=-1)
        return self.output_layer(x)

    def _background(self, rng, shader_results, bg_intensity_range):
        """(background, random): the constant lo where lo == hi; else a
        normal draw [..., 3] per ray times hi - lo (0 without a generator)."""
        lo, hi = bg_intensity_range
        if lo == hi:
            return lo, False
        if rng is None:
            return ((lo + hi) / 2) * 0.0, False
        weights = shader_results["weights"]
        bg = torchutil.normal(rng, weights.shape[:-1] + (3,), weights.device) * (hi - lo)
        return bg, True

    def _finish(self, rendering, rays, shader_results, bg_rgbs, random_background, linear_rgb,
                vignette):
        """The background's share taken out, the colour correction, the
        vignette and the sRGB curve, in JAX's order."""
        if random_background:
            rendering["bg_noise"] = (
                1.0 - shader_results["weights"].sum(dim=-1, keepdim=True)) * bg_rgbs
            rendering["rgb"] = rendering["rgb"] - rendering["bg_noise"]
        if self.use_color_net and not linear_rgb:
            correction = math.safe_exp(self.run_color_network(rays.viewdirs, rays.origins))
            rendering["rgb"] = rendering["rgb"] * correction
        if vignette is not None:
            rendering["rgb"] = rendering["rgb"] * vignette
        if not linear_rgb and self.config.linear_to_srgb and rendering["rgb"] is not None:
            rendering["rgb"] = torch.clamp(image.linear_to_srgb(rendering["rgb"]), min=0.0)
        return rendering

    def forward(self, rng, rays, shader_results, train_frac=1.0, train=True,
                percentiles=(5, 50, 95), linear_rgb=False, compute_extras=False,
                compute_distance=True, bg_intensity_range=None, vignette=None, **kwargs):
        del train_frac, train, kwargs
        if bg_intensity_range is None:
            bg_intensity_range = self.bg_intensity_range
        bg_rgbs, random_background = self._background(rng, shader_results, bg_intensity_range)
        extras_keys = _EXTRAS_TO_RENDER if compute_extras else _EXTRAS_TO_ALWAYS_RENDER
        rendering = render.volumetric_rendering(
            shader_results["rgb"], shader_results["weights"], shader_results["weights_no_filter"],
            shader_results["tdist"], bg_rgbs, compute_extras,
            extras={k: v for k, v in shader_results.items() if k in extras_keys},
            percentiles=percentiles, compute_distance=compute_distance,
        )
        return self._finish(rendering, rays, shader_results, bg_rgbs, random_background,
                            linear_rgb, vignette)


@gin.configurable
class GeometryVolumeIntegrator(VolumeIntegrator):
    """Composites geometry buffers (means, normals, feature, covariances)
    along each ray, the weights normalised to sum to one under
    ``normalize_weights``; each output keeps a one-sample axis."""

    def forward(self, rng, sampler_results, train_frac=1.0, train=True, **kwargs):
        del rng, train_frac, train, kwargs
        extras = ["normals_to_use", "normals", "normals_pred", "feature", "means", "covs"]
        sampler_results = dict(sampler_results)
        sampler_results["covs"] = sampler_results["covs"].reshape(
            sampler_results["covs"].shape[:-2] + (9,))
        weights = sampler_results["weights"]
        if self.normalize_weights:
            weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-8)
        rendering = render.volumetric_rendering(
            sampler_results["means"], weights, weights, sampler_results["tdist"], 0.0, True,
            extras={k: v for k, v in sampler_results.items() if k in extras},
            normalize_weights_for_extras=False)
        del rendering["rgb"]
        rendering["covs"] = rendering["covs"].reshape(rendering["covs"].shape[:-1] + (3, 3))
        return {k: (v[..., None, :] if isinstance(v, torch.Tensor) else v)
                for k, v in rendering.items()}


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
    indirect shift form is ``Config.transient_shift_form``. A per-ray
    `vignette` [..., 1] multiplies the rgb over every bin, before the sRGB
    curve.
    """

    def forward(self, rng, rays, shader_results, train_frac=1.0, train=True,
                percentiles=(5, 50, 95), linear_rgb=False, compute_extras=False,
                compute_distance=True, bg_intensity_range=None, is_secondary=False,
                radiance_cache=None, material=False, vignette=None, **kwargs):
        del train_frac, train, kwargs
        if bg_intensity_range is None:
            bg_intensity_range = self.bg_intensity_range
        bg_rgbs, random_background = self._background(rng, shader_results, bg_intensity_range)
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
        unrendered = _UNRENDERED_EXTRAS + (() if compute_extras else _TRAIN_UNRENDERED_EXTRAS)
        rendering = render.volumetric_transient_rendering(
            shader_results["direct_rgb"], shader_results["transient_indirect"],
            shader_results["weights"], shader_results["weights_no_filter"],
            shader_results["tdist"], bg_rgbs, compute_extras,
            extras={k: v for k, v in shader_results.items()
                    if k in extras_keys and k not in unrendered},
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
        return self._finish(rendering, rays, shader_results, bg_rgbs, random_background,
                            linear_rgb, None if vignette is None else vignette[..., None, :])
