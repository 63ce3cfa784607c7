"""Material models: cache pass -> resample to surface points -> material pass
(counterpart of ``BaseMaterialModel``, ``MaterialModel`` and
``TransientMaterialModel`` in ``models/material_model.py``).

One forward:
  1. cache pass: the full cache render, the ``cache_main`` loss target;
  2. the cache's final samples resampled to num_resample surface points,
     and the cache shader run there (the consistency targets);
  3. vMF light sampling at the surface points (``LightMLP``);
  4. material pass: the material shader fires secondary rays into the
     cache, its outputs are composited by the material integrator (the
     ``main`` target), and the cache is rendered again at the surface points
     for the cache-consistency integrator.

The model passes itself as ``radiance_cache`` to the cache's passes, the
cache shader, the secondary-ray queries and both integrators, as the JAX
model does: that is how the transient integrators find the learnable light
(the shift and dark level) on the material shader.

``MaterialModel`` is the steady model (``MaterialMLP`` over a
``NeRFModel``); ``TransientMaterialModel`` is InvProp's
(``TransientMaterialMLP`` over a ``TransientNeRFModel``, composited by a
``TransientVolumeIntegrator``).

With ``use_material=False`` (the staged trainer's cache stage of a material
config) the model holds only its cache: no light sampler, material shader
or integrator is built, and the forward's ``cache_main`` and ``main`` are
the same dict, the cache render, as in JAX. Without a light sampler
(``use_light_sampler=False``) the material shader gets no light-sampler
results.

Not ported yet (they raise): the SLF and volume control variates,
ground-truth lights and a light power shared with the cache, the
sub-module bypass passes, vignetting and shared materials.
"""

from __future__ import annotations

import torch

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models import integrator as integrator_lib
from neural_radiance_caching_tpu_torch.models import light_sampler as light_sampler_lib
from neural_radiance_caching_tpu_torch.models import material_shader, nerf_model
from neural_radiance_caching_tpu_torch.utils import torchutil

# Sentinel: "use the cache pass's own resample indices".
_CACHE_INDS = object()


def _detach_dict(d):
    return {k: (v.detach() if isinstance(v, torch.Tensor) else v) for k, v in d.items()}


class BaseMaterialModel(nerf_model.Model, unported=dict(
        stopgrad_weight_variate=0.0, sampler_params=None, use_vignette=False,
        use_resample_depth=False, depth_key="distance_median")):
    """Material model over a radiance cache; the variants pick the cache,
    shader and integrator classes."""

    _cache_cls = None
    _shader_cls = None
    _integrator_cls = None

    cache_model_params = None
    light_sampler_params = None
    shader_params = None
    integrator_params = None
    extra_model_params = None
    use_material = True
    use_light_sampler = True
    # Bound by the gin files, read by no model code (in JAX either).
    share_material = False
    material_loss = "rawnerf_unbiased"
    material_loss_weight = 1.0
    material_linear_to_srgb = False
    loss = "rawnerf_unbiased"
    loss_weight = 1.0
    linear_to_srgb = False
    cache_loss = "charb"
    cache_loss_weight = 1.0
    cache_linear_to_srgb = True
    stopgrad_samples = False
    stopgrad_geometry_weight = 0.0
    stopgrad_geometry_feature_weight = 0.0
    stopgrad_geometry_normals_weight = 1.0
    stopgrad_geometry_weight_consistency = 0.0
    stopgrad_geometry_feature_weight_consistency = 0.0
    stopgrad_geometry_normals_weight_consistency = 0.0
    slf_variate = True
    share_light_power = False

    def __init__(self, config=None, **kwargs):
        self._init_model(config, kwargs)
        self.cache = self._cache_cls(
            config=config, use_surface_light_field=self.use_surface_light_field,
            **dict(self.cache_model_params or {}), **dict(self.extra_model_params or {}))
        if not self.use_material:
            return
        self._require(slf_variate=False, share_light_power=False)
        if config.volume_variate_material:
            raise NotImplementedError("the material volume variate is not ported yet")
        feature_dim = self.cache.sampler.mlps[-1].feature_dim
        if self.use_light_sampler:
            self.light_sampler = light_sampler_lib.LightMLP(
                config=config, density_feature_dim=feature_dim,
                **dict(self.light_sampler_params or {}))
        self.shader = self._shader_cls(
            config=config, use_surface_light_field=self.use_surface_light_field,
            density_feature_dim=feature_dim, **dict(self.shader_params or {}))
        self.integrator = self._integrator_cls(
            config=config, **dict(self.integrator_params or {}))

    _CACHE_MAIN_KEYS = ("sampler", "filtered_sampler_inds", "geometry", "shader", "integrator")

    def forward(self, rng, rays, train_frac=1.0, train=True, compute_extras=False,
                cache_outputs=None, filtered_sampler_inds=_CACHE_INDS, **render_kwargs):
        """Returns {"cache_main", "main", "render"}.

        cache_outputs: {"sampler": ray history} of an earlier forward to reuse
        in the cache pass (the gradient-debias pass); filtered_sampler_inds,
        when given (None included), replaces the cache pass's resample
        indices for the surface points.
        """
        if render_kwargs.pop("is_secondary", False):
            raise NotImplementedError("secondary-ray queries of the material model are not ported")
        key, rng = torchutil.random_split(rng)
        cache_out = self.cache(key, rays, train_frac=train_frac, train=train,
                               cache_outputs=cache_outputs, compute_extras=compute_extras,
                               radiance_cache=self, **render_kwargs)["main"]
        cache_outputs = {k: cache_out[k] for k in self._CACHE_MAIN_KEYS}
        cache_outputs.update(loss_weight=self.cache_loss_weight, loss_type=self.cache_loss,
                             linear_to_srgb=self.cache_linear_to_srgb)
        if not self.use_material:
            return self._finalize_cache_only(cache_outputs, rays)

        inds = (cache_outputs["filtered_sampler_inds"] if filtered_sampler_inds is _CACHE_INDS
                else filtered_sampler_inds)
        key, rng = torchutil.random_split(rng)
        filtered, cache_shader_results = self._get_material_samples(
            key, rays, cache_outputs["sampler"][-1], inds, train, train_frac)

        key, rng = torchutil.random_split(rng)
        light_sampler_results = None
        if self.use_light_sampler:
            light_sampler_results = self.light_sampler(
                rng=key, rays=rays, sampler_results=_detach_dict(filtered),
                train_frac=train_frac, train=train)

        key, rng = torchutil.random_split(rng)
        outputs = self._handle_material_pass(
            key, rays, train_frac, train, cache_outputs, cache_shader_results, filtered,
            light_sampler_results, compute_extras)
        return self._finalize_outputs(outputs, cache_outputs, cache_shader_results,
                                      light_sampler_results)

    def _finalize_cache_only(self, cache_outputs, rays):
        """The cache render is the model output: ``cache_main`` and ``main``
        are one dict, and the render carries the ``cache_`` copies of its
        keys, a lossmult broadcast over rgb and a unit vignette."""
        render = cache_outputs["integrator"]
        for key in self._INTEGRATOR_KEYS:
            if key in render:
                render[f"cache_{key}"] = render[key]
        lossmult = rays.lossmult
        if render["rgb"].dim() == lossmult.dim() + 1:
            lossmult = lossmult[..., None]
        render["lossmult"] = lossmult * torch.ones_like(render["rgb"])
        render["vignette"] = torch.ones_like(render["rgb"][..., :1])
        cache_outputs["light_sampler"] = None
        return {"cache_main": cache_outputs, "main": cache_outputs, "render": render}

    def _consistency_stopgrad_map(self):
        return self.geometry_stopgrad_map(
            True, weight=self.stopgrad_geometry_weight_consistency,
            feature=self.stopgrad_geometry_feature_weight_consistency,
            normals=self.stopgrad_geometry_normals_weight_consistency)

    def _get_material_samples(self, rng, rays, sampler_results, filtered_sampler_inds, train,
                              train_frac):
        """Refilter the cache's final samples to num_resample surface points
        and run the cache shader there."""
        do_resample_cache = self.cache.do_resample(False, False, train)
        key, rng = torchutil.random_split(rng)
        filtered, _ = self.maybe_resample(
            key, do_resample_cache, sampler_results, self.cache.num_resample,
            inds=filtered_sampler_inds)
        do_resample_self = self.do_resample(False, False, train)
        if not (do_resample_cache and self.cache.num_resample == self.num_resample):
            key, rng = torchutil.random_split(rng)
            filtered, _ = self.maybe_resample(
                key, do_resample_self, filtered, self.num_resample,
                logits_mult=self._get_logits_mult(False))
            filtered["weights_no_filter"] = sampler_results["weights"]
        if self.stopgrad_samples:
            filtered = _detach_dict(filtered)

        filtered_material = torchutil.apply_stopgrad_fields(
            filtered, self.geometry_stopgrad_map(do_resample_cache or do_resample_self))
        filtered_cache = torchutil.apply_stopgrad_fields(filtered, self._consistency_stopgrad_map())
        key, rng = torchutil.random_split(rng)
        cache_shader_results = self.cache.shader(
            rng=key, rays=rays, sampler_results=filtered_cache,
            filtered_sampler_results=filtered_cache, train_frac=train_frac, train=train,
            is_secondary=False, radiance_cache=self)
        filtered_material["occ"] = cache_shader_results["occ"].detach()
        return filtered_material, cache_shader_results

    def _handle_material_pass(self, rng, rays, train_frac, train, cache_outputs,
                              cache_shader_results, filtered, light_sampler_results,
                              compute_extras):
        shared = dict(rays=rays, train_frac=train_frac, train=train)
        key, rng = torchutil.random_split(rng)
        material_shader_results = self.shader(
            rng=key, sampler_results=filtered, light_sampler_results=light_sampler_results,
            radiance_cache=self, **shared)
        key, rng = torchutil.random_split(rng)
        material_integrator_results = self.integrator(
            rng=key, shader_results=material_shader_results, compute_extras=compute_extras,
            compute_distance=False, material=True, radiance_cache=self, **shared)
        # The material integrator never re-derives depth: distances come from
        # the cache's own integration.
        for k, v in cache_outputs["integrator"].items():
            if "distance" in k:
                material_integrator_results[k] = v

        # The cache rendered at the material's surface points (the
        # cache-consistency integrator). The JAX model also integrates the
        # cache shader's results alone; only the volume variate reads that.
        key, rng = torchutil.random_split(rng)
        _, cache_consistency_integrator_results = self.cache.apply_shader_and_integrator(
            key, rays, filtered,
            self._consistency_stopgrad_map(), train, train_frac, False, None,
            radiance_cache=self)

        material_outputs = dict(
            loss_weight=self.loss_weight, loss_type=self.loss, linear_to_srgb=self.linear_to_srgb,
            sampler=None, geometry=None, cache_shader=cache_shader_results,
            cache_integrator=cache_consistency_integrator_results,
            shader=material_shader_results, integrator=material_integrator_results)
        return dict(cache_main=cache_outputs, main=material_outputs,
                    render=material_integrator_results)

    _INTEGRATOR_KEYS = (
        "rgb", "normals", "normals_pred", "incoming_rgb", "env_map_rgb", "incoming_s_dist",
        "diffuse_rgb", "specular_rgb", "occ", "indirect_occ", "direct_rgb", "indirect_rgb",
        "ambient_rgb", "irradiance_rgb", "light_radiance_rgb", "n_dot_l_rgb", "albedo_rgb",
        "direct_diffuse_rgb", "direct_specular_rgb", "indirect_diffuse_rgb",
        "indirect_specular_rgb", "ambient_diffuse_rgb", "ambient_specular_rgb",
    )

    def _finalize_outputs(self, outputs, cache_outputs, cache_shader_results,
                          light_sampler_results):
        render, cache_integrator = outputs["render"], cache_outputs["integrator"]
        for key in self._INTEGRATOR_KEYS:
            if key in cache_integrator:
                render[f"cache_{key}"] = cache_integrator[key]
        for key in self._INTEGRATOR_KEYS[6:] + ("transient_indirect",):
            if key in cache_shader_results:
                outputs["main"]["shader"][f"cache_{key}"] = cache_shader_results[key]
        render["material_rgb"] = render["rgb"]
        render["normals"] = cache_integrator.get("normals")
        render["normals_pred"] = cache_integrator.get("normals_pred")
        render["vignette"] = torch.ones_like(render["rgb"][..., :1])
        outputs["main"]["light_sampler"] = light_sampler_results
        # The material lossmult is constant-true, as in the JAX model (whose
        # normal/radius thresholds are dead); the shader's radius mask gates
        # material supervision.
        render["lossmult"] = torch.ones_like(cache_integrator["acc"][..., None], dtype=torch.bool)
        return outputs


@gin.configurable
class MaterialModel(BaseMaterialModel):
    """Steady-state material model over a radiance cache."""

    _cache_cls = nerf_model.NeRFModel
    _shader_cls = material_shader.MaterialMLP
    _integrator_cls = integrator_lib.VolumeIntegrator


@gin.configurable
class TransientMaterialModel(BaseMaterialModel):
    """InvProp's time-resolved material model over a transient cache."""

    _cache_cls = nerf_model.TransientNeRFModel
    _shader_cls = material_shader.TransientMaterialMLP
    _integrator_cls = integrator_lib.TransientVolumeIntegrator
