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

``bypass`` evaluates one sub-module at given samples (the passes
"geometry", "material_shader" and "material_cache_shader" that the
smoothness losses run, and the SLF memory's "surface_light_field" pass).

With ``slf_variate`` the material pass is followed by the SLF variate's
(``_handle_slf_variate_pass``): the material shader again at the surface
points, detached, with the variate's estimate; its secondary rays replace
the main pass's in the shader results (the material ray sampler reads the
cache's), and its radiance, times the surface weights, is added to the
material render. It needs one surface point per ray (resampling), as the
JAX model's reshape does. With ``use_surface_light_field`` the cache holds
the SLF memory, which the material shader queries.

With ``share_light_power`` the cache shader lights its secondary queries
with the material shader's power (or its learnable light). Under
``Config.use_occlusions`` the cache shader traces shadow rays from the
surface points (their occlusion, stored without gradient, darkens the
material's direct lobe) and from the point each secondary query resamples.

With ``use_vignette`` (InvProp's captured scenes) a ``VignetteMap``
multiplies the primary rays' renders, the cache pass's and the material
pass's, by one learned factor per ray. A cache stage under
``Config.learnable_light`` holds the material shader's light alone
(``material_shader.CacheStageLight``): the cache shader and integrator read
it there.

The render passes ("cache", "light", "material", "is_secondary",
"surface_light_field_vis", "light_sampler_vis") pick what a render runs:
without "material" it is the cache's, and with "is_secondary" the cache is
queried as secondary rays (the trainer's secondary-ray probe).

Not ported yet (they raise): the volume control variate and shared
materials. A relit render (``Config.compute_relight_metrics``) and the
ground-truth lights under ``Config.multi_illumination`` raise as the
reference gaps they are: the JAX trainer hands its model no env map tables.
Under ``Config.multi_illumination`` the cache, its SLF and the light sampler
read each ray's light index.
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


class BaseMaterialModel(nerf_model.Model, unported=dict(stopgrad_weight_variate=0.0)):
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
    # Bound by the gin files (or declared), read by no model code (in JAX
    # either).
    sampler_params = None
    use_resample_depth = False
    depth_key = "distance_median"
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
    use_vignette = False

    def __init__(self, config=None, **kwargs):
        self._init_model(config, kwargs)
        # Only the material shader queries the cache's SLF memory, and JAX's
        # module creates the memory's parameters at its first query: a cache
        # without a material pass has none.
        self.cache = self._cache_cls(
            config=config, use_surface_light_field=self.use_surface_light_field and self.use_material,
            **dict(self.cache_model_params or {}), **dict(self.extra_model_params or {}))
        if self.use_vignette:
            self.vignette_map = nerf_model.VignetteMap(config=config)
        if not self.use_material:
            if config.learnable_light:
                self.shader = material_shader.CacheStageLight(config, self.shader_params)
            return
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
                cache_outputs=None, filtered_sampler_inds=_CACHE_INDS, passes=None,
                sampler_results=None, secondary_proposal_grad=True, **render_kwargs):
        """Returns {"cache_main", "main", "render"}, or with `passes` naming
        a bypass pass, that pass's outputs at `sampler_results` (``bypass``).

        passes: those of RENDER_PASSES to run (by default the cache, light
        and material passes); without "material" the render is the cache's,
        and with "is_secondary" the rays query the cache as secondary rays
        (the trainer's secondary-ray probe).
        cache_outputs: {"sampler": ray history} of an earlier forward to reuse
        in the cache pass (the gradient-debias pass); filtered_sampler_inds,
        when given (None included), replaces the cache pass's resample
        indices for the surface points. secondary_proposal_grad=False runs
        the secondary rays' proposal levels without a graph (the train step
        asks for it where no loss reads them). `mesh` and `use_mesh` among
        `render_kwargs`: the cache pass takes the sampler's mesh shortcut,
        and the material shader's secondary rays take it too (``use_mesh``
        always), starting at their near point.
        """
        if passes is not None and set(passes) & set(self.BYPASS_PASSES):
            return self.bypass(rng, rays, passes, sampler_results, train_frac=train_frac,
                               train=train, **render_kwargs)
        passes = ("cache", "light", "material") if passes is None else tuple(passes)
        unknown = set(passes) - set(self.RENDER_PASSES)
        if unknown:
            raise NotImplementedError(f"the material model's passes {sorted(unknown)} are not "
                                      "ported yet")
        is_secondary = render_kwargs.pop("is_secondary", False) or "is_secondary" in passes
        use_material = self.use_material and "material" in passes
        if is_secondary and use_material:
            raise NotImplementedError("secondary-ray queries of the material model's material "
                                      "pass are not ported")
        slf_vis = None
        if "surface_light_field_vis" in passes and self.cache.use_surface_light_field:
            # The memory's radiance along the rays, beside the render (a model
            # without the memory ignores the pass, as in JAX).
            key, rng = torchutil.random_split(rng)
            slf_vis = self.cache(key, rays, train_frac=train_frac, train=train, use_slf=True)
        if is_secondary:
            # The probe's render reports its distances, as JAX's does.
            render_kwargs.setdefault("compute_distance", True)
        vignette = self.vignette_map(rays) if self.use_vignette and not is_secondary else None
        key, rng = torchutil.random_split(rng)
        cache_out = self.cache(key, rays, train_frac=train_frac, train=train,
                               cache_outputs=cache_outputs, compute_extras=compute_extras,
                               radiance_cache=self, vignette=vignette, is_secondary=is_secondary,
                               **render_kwargs)["main"]
        cache_outputs = {k: cache_out[k] for k in self._CACHE_MAIN_KEYS}
        cache_outputs.update(loss_weight=self.cache_loss_weight, loss_type=self.cache_loss,
                             linear_to_srgb=self.cache_linear_to_srgb)
        if not use_material:
            outputs = self._finalize_cache_only(cache_outputs, rays, vignette)
            if self.use_material:
                # A material model's lossmult is constant-true, as in JAX.
                outputs["render"]["lossmult"] = torch.ones_like(
                    cache_outputs["integrator"]["acc"][..., None], dtype=torch.bool)
            self._add_slf_vis(outputs["render"], slf_vis)
            return outputs

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
            light_sampler_results, compute_extras, secondary_proposal_grad, vignette,
            render_kwargs.get("mesh"))
        outputs = self._finalize_outputs(outputs, cache_outputs, cache_shader_results,
                                         light_sampler_results, slf_vis, vignette)
        if "light_sampler_vis" in passes and light_sampler_results:
            outputs["render"].update(light_sampler_results)
        return outputs

    # The sub-module passes at given samples or rays (JAX's
    # `_maybe_bypass_pipeline`).
    BYPASS_PASSES = ("material_shader", "material_cache_shader", "geometry",
                     "surface_light_field")
    # The passes of a render: "material" adds the material pass to the
    # cache's, "is_secondary" queries the cache as secondary rays (the
    # secondary-ray probe's), "surface_light_field_vis" adds the SLF memory's
    # radiance along the rays, "light_sampler_vis" the light sampler's vMF
    # mixture at the surface points.
    RENDER_PASSES = ("cache", "light", "material", "is_secondary", "surface_light_field_vis",
                     "light_sampler_vis")

    def bypass(self, rng, rays, passes, sampler_results, train_frac=1.0, train=True,
               material_only=False):
        """One sub-module evaluated at externally supplied samples
        (`sampler_results`: means, covs, tdist and the shader's inputs).

        "geometry": the cache's final density MLP at the samples' Gaussians.
        "material_shader": that MLP's feature replaces the samples', then the
        material shader runs there; "material_cache_shader": the cache
        shader too, as {"material": ..., "cache": ...}. material_only
        makes the material shader output its material heads only and trace
        no secondary ray (``MaterialMLP.predict_appearance``).
        "surface_light_field": the cache's SLF memory queried along `rays`
        (``NeRFModel.get_slf_results``).
        """
        shared = dict(rays=rays, train_frac=train_frac, train=train, is_secondary=False)

        def geometry(key):
            return self.cache.sampler.mlps[-1](
                rng=key, gaussians=(sampler_results["means"], sampler_results["covs"]),
                tdist=sampler_results["tdist"], **shared)

        if {"material_shader", "material_cache_shader"} & set(passes):
            key, rng = torchutil.random_split(rng)
            sampler_results = dict(sampler_results, feature=geometry(key)["feature"])
            key, rng = torchutil.random_split(rng)
            material = self.shader(rng=key, sampler_results=sampler_results, radiance_cache=self,
                                   material_only=material_only, **shared)
            if "material_cache_shader" not in passes:
                return material
            key, rng = torchutil.random_split(rng)
            cache = self.cache.shader(rng=key, sampler_results=sampler_results,
                                      filtered_sampler_results=sampler_results,
                                      radiance_cache=self, **shared)
            return {"material": material, "cache": cache}
        if "geometry" in passes:
            key, rng = torchutil.random_split(rng)
            return geometry(key)
        if not self.cache.use_surface_light_field:
            raise ValueError("the surface_light_field pass needs the cache's SLF memory "
                             "(use_surface_light_field with use_material)")
        key, rng = torchutil.random_split(rng)
        return self.cache(key, rays, train_frac=train_frac, train=train, use_slf=True)

    def _finalize_cache_only(self, cache_outputs, rays, vignette=None):
        """The cache render is the model output: ``cache_main`` and ``main``
        are one dict, and the render carries the ``cache_`` copies of its
        keys, a lossmult broadcast over rgb and the vignette (unit without
        ``use_vignette``)."""
        render = cache_outputs["integrator"]
        for key in self._INTEGRATOR_KEYS:
            if key in render:
                render[f"cache_{key}"] = render[key]
        lossmult = rays.lossmult
        if render["rgb"].dim() == lossmult.dim() + 1:
            lossmult = lossmult[..., None]
        render["lossmult"] = lossmult * torch.ones_like(render["rgb"])
        render["vignette"] = (torch.ones_like(render["rgb"][..., :1]) if vignette is None
                              else vignette)
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
                              compute_extras, secondary_proposal_grad=True, vignette=None,
                              mesh=None):
        shared = dict(rays=rays, train_frac=train_frac, train=train)
        key, rng = torchutil.random_split(rng)
        # Under slf_variate the variate pass's secondary rays replace this
        # pass's: no loss reads this pass's proposal levels.
        material_shader_results = self.shader(
            rng=key, sampler_results=filtered, light_sampler_results=light_sampler_results,
            radiance_cache=self, mesh=mesh,
            secondary_proposal_grad=secondary_proposal_grad and not self.slf_variate, **shared)
        key, rng = torchutil.random_split(rng)
        material_integrator_results = self.integrator(
            rng=key, shader_results=material_shader_results, compute_extras=compute_extras,
            compute_distance=False, material=True, radiance_cache=self, vignette=vignette,
            **shared)
        # The material integrator never re-derives depth: distances come from
        # the cache's own integration.
        for k, v in cache_outputs["integrator"].items():
            if "distance" in k:
                material_integrator_results[k] = v

        if self.slf_variate:
            key, rng = torchutil.random_split(rng)
            self._handle_slf_variate_pass(key, rays, train_frac, train, filtered,
                                          material_shader_results, material_integrator_results,
                                          secondary_proposal_grad, mesh)
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

    # The material render's outputs the SLF variate adds to.
    _VARIATE_OUTPUTS = ("diffuse_rgb", "specular_rgb", "rgb", "lighting_irradiance",
                        "transient_indirect", "transient_indirect_specular",
                        "transient_indirect_diffuse")

    def _handle_slf_variate_pass(self, rng, rays, train_frac, train, filtered,
                                 material_shader_results, material_integrator_results,
                                 secondary_proposal_grad=True, mesh=None):
        """The SLF variate: the material shader at the detached surface
        points with ``slf_variate``, lit by a second, detached light-sampler
        call (graph-free: no loss reads it). Its ``ref_*`` outputs replace
        the main pass's; its outputs times the surface weights (their
        gradient scaled by ``stopgrad_geometry_variate_weight``) are added
        to the material render's. (JAX returns early under
        compute_relight_metrics, which the port's material shader refuses.)"""
        if filtered["weights"].shape[-1] != 1:
            raise NotImplementedError(
                "the SLF variate at more than one surface point per ray (without "
                "Trainer.resample and resample_render): the JAX model's sum reshapes the "
                "variate to one point per ray and raises (models/material_model.py:577)")
        single = _detach_dict(filtered)
        single_light = None
        if self.use_light_sampler:
            key, rng = torchutil.random_split(rng)
            with torch.no_grad():
                single_light = self.light_sampler(rng=key, rays=rays, sampler_results=single,
                                                  train_frac=train_frac, train=train)
        key, rng = torchutil.random_split(rng)
        single_shader = self.shader(
            rng=key, rays=rays, sampler_results=single, train_frac=train_frac, train=train,
            light_sampler_results=single_light, slf_variate=True, radiance_cache=self,
            secondary_proposal_grad=secondary_proposal_grad, mesh=mesh)
        for f, v in single_shader.items():
            if f.startswith("ref_"):
                material_shader_results[f] = v
        w = torchutil.stopgrad_with_weight(filtered["weights"],
                                           self.stopgrad_geometry_variate_weight)[..., None]
        for key_out in self._VARIATE_OUTPUTS:
            if key_out not in material_integrator_results or single_shader.get(key_out) is None:
                continue
            target = material_integrator_results[key_out]
            material_integrator_results[key_out] = target + (single_shader[key_out] * w).reshape(
                target.shape)

    _INTEGRATOR_KEYS = (
        "rgb", "normals", "normals_pred", "incoming_rgb", "env_map_rgb", "incoming_s_dist",
        "diffuse_rgb", "specular_rgb", "occ", "indirect_occ", "direct_rgb", "indirect_rgb",
        "ambient_rgb", "irradiance_rgb", "light_radiance_rgb", "n_dot_l_rgb", "albedo_rgb",
        "direct_diffuse_rgb", "direct_specular_rgb", "indirect_diffuse_rgb",
        "indirect_specular_rgb", "ambient_diffuse_rgb", "ambient_specular_rgb",
    )

    @staticmethod
    def _add_slf_vis(render, slf_vis):
        """The SLF memory's ``incoming_*`` along the rays as the render's
        ``cache_incoming_*`` (the "surface_light_field_vis" pass)."""
        if slf_vis is None:
            return
        for key in ("incoming_rgb", "incoming_acc", "incoming_s_dist"):
            if key in slf_vis:
                render[f"cache_{key}"] = slf_vis[key].reshape(render["rgb"].shape[:-1] + (-1,))

    def _finalize_outputs(self, outputs, cache_outputs, cache_shader_results,
                          light_sampler_results, slf_vis=None, vignette=None):
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
        render["vignette"] = (torch.ones_like(render["rgb"][..., :1]) if vignette is None
                              else vignette)
        self._add_slf_vis(render, slf_vis)
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
