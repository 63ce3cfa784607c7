"""Model composition: sampler -> (resample) -> shader -> integrator
(counterpart of ``Model`` and ``NeRFModel`` in ``models/nerf_model.py``).

``Model`` carries the resampled estimator (a categorical draw of
num_resample samples proportional to the weights, with the weights divided
by the detached N * p so the estimate stays unbiased) and the secondary-ray
bookkeeping. ``NeRFModel`` is the radiance cache: primary rays without
resampling, and secondary rays (``is_secondary``) with it when
``resample_secondary`` is set, as the material stage traces them.
``TransientNeRFModel`` is the transient (time-resolved) cache. A
weights-only pass (``weights_only``, the shadow rays') renders the opacity
alone.

With ``use_surface_light_field`` the steady cache holds a surface light
field memory (``surface_lf_mem``, a ``SurfaceLightFieldMLP`` with
``use_env_alpha``): a query with ``use_slf`` reads the memory's incoming
radiance along the rays instead of rendering them (``get_slf_results``).
Only the material shader queries it. The transient cache has no memory, as
in JAX, where ``TransientNeRFModel`` lacks ``get_slf_results``: a ``use_slf``
query on it raises.

``VignetteMap`` is the per-ray vignette multiplier of a material model with
``use_vignette`` (InvProp's captured scenes): an MLP on the cosine between
each ray's view direction and its camera's look direction.

Under ``Config.volume_variate`` (primary rays) and
``Config.volume_variate_secondary`` (secondary rays) the shade-and-integrate
chain runs twice more with the variate's shader passes
(``Config.volume_variate_passes[_secondary]``): once over every final
sample and once over the resampled ones, and the render's outputs become
E[f(all)] - E[f(resampled, variate passes)] + f(resampled)
(``_handle_volume_variate_pass``, the two terms' gradients scaled by
``stopgrad_weight_variate`` and ``stopgrad_weight_model``).

Resampling (``resample`` on training rays, ``resample_render`` on render
rays, ``resample_secondary``) draws categorically; with
``resample_argmax`` the heaviest sample is kept and the other
num_resample - 1 are drawn from the rest, reweighted by their own
probabilities.

The environment map (``use_env_map``): an SLF module ``env_map`` over
[env_map_near, env_map_far] built from ``env_map_params``; secondary rays
end at ``Config.env_map_distance`` (as does the SLF memory), and their
render is composited over the map's radiance along them
(``_handle_env_map``, ``_composite_env_map``) unless the caller passes
``use_env_map=False``, as the material shader's cache and memory queries
do; an ``env_map_only`` query returns the map's radiance alone, and with
``env_map`` tables (``data/env_maps``) the map is looked up instead
(``render_utils.get_environment_color``). The transient cache builds no
map, as in JAX, and raises where JAX's would be read (``ENV_MAP_GAP``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from neural_radiance_caching_tpu_torch.engine import gin_config as gin
from neural_radiance_caching_tpu_torch.models import integrator as integrator_lib
from neural_radiance_caching_tpu_torch.models import nerf_shader, sampler as sampler_lib
from neural_radiance_caching_tpu_torch.models import surface_light_field
from neural_radiance_caching_tpu_torch.models.layers import Configurable, Dense
from neural_radiance_caching_tpu_torch.ops import coord, math, render_utils
from neural_radiance_caching_tpu_torch.utils import torchutil



# A material model's cache under use_env_map whose shader never queries the map.
ENV_MAP_UNQUERIED_GAP = (
    "NeRFModel.use_env_map with a material shader that does not query the environment map "
    "(MaterialMLP.use_env_map off) is a reference gap where the map is then read (a secondary "
    "render composited over it, the SLF passes): the JAX model's initialisation never queries "
    "the EnvMap, so it has no parameters, and flax raises ScopeParamNotFoundError at the read "
    "(models/nerf_model.py:255)")
# TransientNeRFModel under use_env_map.
ENV_MAP_GAP = (
    "TransientNeRFModel.use_env_map with a secondary query that composites the environment map "
    "is a reference gap: the JAX TransientNeRFModel builds no EnvMap "
    "(models/nerf_model.py:625-640), so Model._handle_env_map raises AttributeError: "
    "'TransientNeRFModel' object has no attribute 'env_map' (:255)")

# The render outputs the volume variate corrects.
VOLUME_VARIATE_KEYS = ("rgb", "diffuse_rgb", "specular_rgb", "direct_rgb", "indirect_rgb",
                       "transient_indirect")


class Model(Configurable, nn.Module):
    """Shared base: resampled estimator and secondary-ray bookkeeping."""

    # The 2D generator and samplers of the extra-ray loss's outgoing rays
    # (parallel/extra_losses.extra_ray_loss).
    random_generator_2d = render_utils.RandomGenerator2D(1, 1, False)
    uniform_importance_samplers = ((render_utils.UniformHemisphereSampler(), 1.0),)
    # The samplers of the transient cache shader's shadow rays (the
    # direction toward the light, pdf 1).
    active_importance_samplers = ((render_utils.ActiveSampler(), 1.0),)
    # Importance samplers the JAX model declares and nothing reads.
    uniform_sphere_importance_samplers = (("UniformSphereSampler", 1.0),)
    cosine_importance_samplers = (("CosineSampler", 1.0),)
    light_importance_samplers = (("UniformHemisphereSampler", 1.0),)
    distance_importance_samplers = (("UniformHemisphereSampler", 1.0),)
    light_field_importance_samplers = (("UniformHemisphereSampler", 1), ("MicrofacetSampler", 1))
    irradiance_importance_samplers = (("CosineSampler", 1), ("LightSampler", 1))
    extra_ray_importance_samplers = (("UniformHemisphereSampler", 1), ("IdentitySampler", 1))
    # The environment map of secondary rays and its distance range.
    use_env_map = False
    env_map_near = float("inf")
    env_map_far = float("inf")
    env_map_params = None
    # Bound by the gin files, read by no model code (the secondary-ray
    # stop-gradient weights that the material shader passes are its own).
    stopgrad_cache_weight = (1.0, 1.0)
    stopgrad_slf_weight = (1.0, 1.0)
    stopgrad_env_map_weight = (1.0, 1.0)
    # The surface light field memory (NeRFModel) and its ray-distance range.
    use_surface_light_field = False
    surface_lf_mem_distance_near = 1e-3
    surface_lf_mem_distance_far = 1e6
    surface_lf_mem_params = None
    # The gradient scale of the surface weights in the SLF variate's sum
    # (read by the material models).
    stopgrad_geometry_variate_weight = 0.0
    resample = False
    resample_render = False
    resample_secondary = False
    resample_argmax = False
    num_resample = 1
    logits_mult = 1.0
    logits_mult_secondary = 1.0
    weights_bias = 0.0
    stopgrad_geometry_weight = 1.0
    stopgrad_geometry_feature_weight = 1.0
    stopgrad_geometry_normals_weight = 1.0
    # The gradient scales of the volume variate's two terms.
    stopgrad_weight_variate = 1.0
    stopgrad_weight_model = 1.0
    use_raydist_for_secondary_only = False
    train_sampling_strategy = ((0, 0, 64), (1, 1, 64), (2, 2, 32))
    render_sampling_strategy = ((0, 0, 64), (1, 1, 64), (2, 2, 32))

    def _init_model(self, config, kwargs):
        nn.Module.__init__(self)
        self.config = config
        self._set_fields(kwargs)

    def do_resample(self, do_resample, is_secondary, train):
        return (do_resample or (train and self.resample) or (not train and self.resample_render)
                or (is_secondary and self.resample_secondary))

    def use_volume_variate(self, is_secondary):
        return bool((self.config.volume_variate_secondary and is_secondary)
                    or (self.config.volume_variate and not is_secondary))

    def get_variate_passes(self, is_secondary):
        return (self.config.volume_variate_passes_secondary if is_secondary
                else self.config.volume_variate_passes)

    def get_bg_and_raydist(self, is_secondary):
        """Secondary rays composite over black and take the sampler's ray
        warp; primary rays take the integrator's own background, and the warp
        unless ``use_raydist_for_secondary_only``."""
        if is_secondary:
            return (0.0, 0.0), True
        return None, not self.use_raydist_for_secondary_only

    def get_sampling_strategy(self, train, sampling_strategy):
        if sampling_strategy is not None:
            return sampling_strategy
        return self.train_sampling_strategy if train else self.render_sampling_strategy

    def _get_logits_mult(self, is_secondary):
        return self.logits_mult_secondary if is_secondary else self.logits_mult

    def geometry_stopgrad_map(self, active, weight=None, feature=None, normals=None):
        """Per-field gradient-flow weights applied to resampled geometry."""
        if not active:
            return {}
        w = self.stopgrad_geometry_weight if weight is None else weight
        f = self.stopgrad_geometry_feature_weight if feature is None else feature
        n = self.stopgrad_geometry_normals_weight if normals is None else normals
        return {"weights": w, "weights_no_filter": w, "feature": f,
                "normals_pred": n, "normals": n, "normals_to_use": n}

    def maybe_resample(self, rng, resample, sampler_results, num_resample, inds=None,
                       logits_mult=1.0):
        """Draw num_resample samples proportional to the weights (or take
        `inds`); the kept weights are divided by the detached N * p. With
        ``resample_argmax`` the first kept sample is the heaviest, and the
        other num_resample - 1 are drawn from the rest (its weight zeroed),
        each divided by (num_resample - 1) times its probability there.

        Returns (filtered_results, indices). Per-sample fields are gathered
        along their sample axis; fields without one (the per-ray lossmult) are
        kept as they are.
        """
        if not resample:
            out = dict(sampler_results)
            out["weights_no_filter"] = out["weights"]
            return out, None
        weights = sampler_results["weights"]
        num_samples = weights.shape[-1]

        def logits_probs(w):
            logits = math.safe_log(w + self.weights_bias) * logits_mult
            return logits, torch.softmax(logits, dim=-1)

        logits, probs = logits_probs(weights)
        if self.resample_argmax:
            inds_argmax = torch.argmax(logits, dim=-1, keepdim=True)
            pos = torch.arange(num_samples, device=weights.device)
            residual = torch.where(pos == inds_argmax, torch.zeros_like(weights), weights)
            new_logits, new_probs = logits_probs(residual)
        if inds is None:
            if self.resample_argmax:
                inds = torch.cat([inds_argmax, torchutil.categorical(rng, new_logits,
                                                                     num_resample - 1)], dim=-1)
            else:
                inds = torchutil.categorical(rng, logits, num_resample)

        ref_ndim = sampler_results["points"].dim()

        def take(x):
            if x.dim() == ref_ndim - 1 and x.shape[-1] == num_samples:
                return torch.gather(x, -1, inds)
            if x.dim() == ref_ndim:
                return torch.gather(x, -2, inds[..., None].expand(inds.shape + x.shape[-1:]))
            if x.dim() == ref_ndim + 1:
                return torch.gather(x, -3, inds[..., None, None].expand(inds.shape + x.shape[-2:]))
            return x

        filtered = {k: (take(v) if isinstance(v, torch.Tensor) and "_no_filter" not in k else v)
                    for k, v in sampler_results.items()}
        filtered["tdist"] = sampler_results["tdist"]
        filtered["sdist"] = sampler_results["sdist"]
        filtered["weights_no_filter"] = weights
        if self.resample_argmax:
            drawn_probs = torch.gather(new_probs, -1, inds[..., 1:])
            w = filtered["weights"][..., 1:] / ((num_resample - 1) * drawn_probs + 1e-8).detach()
            filtered["weights"] = torch.cat([filtered["weights"][..., :1], w], dim=-1)
        else:
            filtered_probs = torch.gather(probs, -1, inds)
            filtered["weights"] = filtered["weights"] / (
                num_resample * filtered_probs + 1e-8).detach()
        return filtered, inds

    # --- the environment map on secondary rays -------------------------------------------

    def _handle_env_map(self, rng, rays, train, train_frac, use_env_map=True, env_map=None,
                        env_map_w=None, env_map_h=None, stopgrad_cache_weight=None):
        """The environment's radiance along `rays` ({"incoming_rgb": [..., C]}
        and the map's other outputs), or {} without the map or under
        ``use_env_map=False``: the learned map queried from each ray's origin
        along its direction (its gradient scaled by
        ``stopgrad_cache_weight`` = (w_rays, w_out), the unscaled radiance
        also under ``incoming_rgb_no_stopgrad``), or the `env_map` tables
        looked up along the directions."""
        if not (self.use_env_map and use_env_map):
            return {}
        env_rays = torchutil.partial_stopgrad_rays(rays, stopgrad_cache_weight)
        if env_map is not None:
            values = render_utils.get_environment_color(env_rays, env_map, env_map_w, env_map_h)
            return {"incoming_rgb": values.reshape(rays.origins.shape[:-1]
                                                   + (self.config.num_rgb_channels,))}
        env = getattr(self, "env_map", None)
        if env is None:
            raise NotImplementedError(ENV_MAP_GAP if not getattr(self, "_has_env_map", True)
                                      else ENV_MAP_UNQUERIED_GAP)
        origins = env_rays.origins[..., None, :]
        out = env(rng, env_rays, {"means": origins, "covs": torch.ones_like(origins)}, origins,
                  env_rays.viewdirs[..., None, :], roughness=torch.zeros_like(origins[..., :1]),
                  shader_bottleneck=None, train=train, train_frac=train_frac)
        out["incoming_rgb_no_stopgrad"] = out["incoming_rgb"]
        if stopgrad_cache_weight is not None and tuple(stopgrad_cache_weight) != (1.0, 1.0):
            out["incoming_rgb"] = torchutil.stopgrad_with_weight(out["incoming_rgb"],
                                                                 stopgrad_cache_weight[1])
        return out

    @staticmethod
    def _composite_env_map(integrator_results, env_outputs):
        """The render over the environment: rgb += env * (1 - acc) (the
        `_no_stopgrad` twin with the env detached), and the env's radiance
        under ``env_map_rgb`` and ``env_map_rgb_no_stopgrad``."""
        if not env_outputs:
            return integrator_results
        rgb = integrator_results["rgb"]
        transparency = 1.0 - integrator_results["acc"][..., None]
        env_rgb = env_outputs["incoming_rgb"].reshape(rgb.shape)
        env_rgb_ns = env_outputs.get("incoming_rgb_no_stopgrad", env_rgb).reshape(rgb.shape)
        integrator_results["rgb"] = rgb + env_rgb * transparency
        if "rgb_no_stopgrad" in integrator_results:
            integrator_results["rgb_no_stopgrad"] = (integrator_results["rgb_no_stopgrad"]
                                                     + env_rgb.detach() * transparency)
        integrator_results["env_map_rgb"] = env_rgb
        integrator_results["env_map_rgb_no_stopgrad"] = env_rgb_ns
        return integrator_results

    def _handle_secondary(self, is_secondary, integrator_results, stopgrad_cache_weight=None,
                          rng=None, rays=None, train=True, train_frac=1.0, **env_kwargs):
        """Secondary rays report every rgb/transient/acc output also under
        `<key>_no_stopgrad`, which the material shader reads; with the
        material shader's ``stopgrad_cache_weight`` (w_rays, w_out) the
        outputs themselves pass gradient scaled by w_out (their
        `_no_stopgrad` twins in full). Then the render is composited over
        the environment map along `rays` (``_handle_env_map``'s
        `env_kwargs`)."""
        if not is_secondary:
            return integrator_results
        partial = stopgrad_cache_weight is not None and tuple(stopgrad_cache_weight) != (1.0, 1.0)
        for k in list(integrator_results):
            v = integrator_results[k]
            if v is not None and any(s in k for s in ("rgb", "transient", "acc")):
                integrator_results[f"{k}_no_stopgrad"] = v
                if partial:
                    integrator_results[k] = torchutil.stopgrad_with_weight(
                        v, stopgrad_cache_weight[1])
        if rays is None:
            return integrator_results
        key, rng = torchutil.random_split(rng)
        env = self._handle_env_map(key, rays, train, train_frac,
                                   stopgrad_cache_weight=stopgrad_cache_weight, **env_kwargs)
        return self._composite_env_map(integrator_results, env)

    def apply_shader_and_integrator(self, rng, rays, filtered_sampler_results, stopgrad_map,
                                    train, train_frac, is_secondary, bg_intensity_range,
                                    stopgrad_cache_weight=None, vignette=None,
                                    sampler_results=None, env_rays=None, env_kwargs=None,
                                    **render_kwargs):
        """Shade the (filtered) samples and composite them; the render's rgb
        times `vignette` [..., 1] if given. Under the volume variate
        (``use_volume_variate``) `sampler_results`, the sampler's levels,
        give the variate's chain over every final sample. Secondary rays'
        renders are composited over the environment map along `env_rays`
        (``_handle_secondary`` with `env_kwargs`)."""
        inputs = torchutil.apply_stopgrad_fields(filtered_sampler_results, stopgrad_map)
        shared = dict(train_frac=train_frac, train=train, is_secondary=is_secondary)
        integrate_kwargs = dict(render_kwargs)
        if is_secondary:
            # Nothing in a train step or a primary render reads the
            # ray-distance statistics of secondary rays; the secondary-ray
            # probe's render asks for them.
            integrate_kwargs.setdefault("compute_distance", False)

        def shade_and_integrate(rng, samples, passes=None):
            extra = {} if passes is None else {"passes": passes}
            key, rng = torchutil.random_split(rng)
            shader_results = self.shader(rng=key, rays=rays, sampler_results=samples,
                                         filtered_sampler_results=samples, **shared, **extra,
                                         **render_kwargs)
            shader_results.setdefault("weights_no_filter", shader_results["weights"])
            key, rng = torchutil.random_split(rng)
            integrator_results = self.integrator(
                rng=key, rays=rays, shader_results=shader_results,
                bg_intensity_range=bg_intensity_range, vignette=vignette, **shared,
                **integrate_kwargs)
            key, rng = torchutil.random_split(rng)
            return shader_results, self._handle_secondary(
                is_secondary, integrator_results, stopgrad_cache_weight, key, env_rays, train,
                train_frac, **(env_kwargs or {}))

        key, rng = torchutil.random_split(rng)
        shader_results, integrator_results = shade_and_integrate(key, inputs)
        if self.use_volume_variate(is_secondary):
            # Control variate: E[f(all)] - E[f(resampled, variate passes)] + f(resampled).
            passes = self.get_variate_passes(is_secondary)
            variate_results, biased_total = shade_and_integrate(rng, sampler_results[-1], passes)
            _, biased = shade_and_integrate(rng, inputs, passes)
            self._handle_volume_variate_pass(integrator_results, biased, biased_total,
                                             VOLUME_VARIATE_KEYS, self.stopgrad_weight_variate,
                                             self.stopgrad_weight_model)
            if not is_secondary:
                shader_results = variate_results
        return shader_results, integrator_results

    @staticmethod
    def _handle_volume_variate_pass(unbiased, biased, biased_total, keys,
                                    stopgrad_weight_variate=1.0, stopgrad_weight_model=1.0):
        """unbiased[k] = (biased_total[k] - biased[k]) + unbiased[k] for each
        key all three hold, the two terms' gradients scaled by the weights."""
        for k in keys:
            if biased_total.get(k) is None or biased.get(k) is None or unbiased.get(k) is None:
                continue
            if biased[k].numel() != unbiased[k].numel():
                # The steady material model's one-channel direct_rgb against
                # the cache's three channels under volume_variate_material.
                raise TypeError(
                    f"the volume variate's {k!r}: {tuple(biased[k].shape)} cannot take the "
                    f"shape {tuple(unbiased[k].shape)}; the JAX model's reshape raises there "
                    "too (models/nerf_model.py:429)")
            unbiased[k] = torchutil.stopgrad_with_weight(
                biased_total[k] - biased[k].reshape(unbiased[k].shape), stopgrad_weight_variate,
            ) + torchutil.stopgrad_with_weight(unbiased[k], stopgrad_weight_model)


@gin.configurable
class NeRFModel(Model):
    """Radiance cache: proposal sampler + NeRFMLP + integrator."""

    use_material = False  # declared in JAX, read by nothing there
    sampler_params = None
    shader_params = None
    integrator_params = None
    extra_model_params = None
    _shader_cls = nerf_shader.NeRFMLP
    _integrator_cls = integrator_lib.VolumeIntegrator
    _has_surface_lf_mem = True
    # The steady cache builds its environment map and hands its shader the
    # map's range, as JAX's NeRFModel does; the transient one does neither.
    _has_env_map = True

    def __init__(self, config=None, env_map_queried=True, **kwargs):
        """env_map_queried: build the environment map now; a material
        model's cache builds it only if its shader queries it
        (``build_env_map``), as JAX creates its parameters at the first
        query."""
        self._init_model(config, kwargs)
        self.sampler = sampler_lib.ProposalVolumeSampler(
            config=config, **dict(self.sampler_params or {}),
            **dict(self.extra_model_params or {}))
        env_range = (dict(env_map_near=self.env_map_near, env_map_far=self.env_map_far)
                     if self._has_env_map else {})
        self.shader = self._shader_cls(
            config=config, density_feature_dim=self.sampler.mlps[-1].feature_dim,
            **env_range, **dict(self.shader_params or {}))
        self.integrator = self._integrator_cls(
            config=config, **dict(self.integrator_params or {}))
        if env_map_queried:
            self.build_env_map()
        if self.use_surface_light_field and self._has_surface_lf_mem:
            slf_params = dict(self.surface_lf_mem_params or {})
            slf_params.update(distance_near=self.surface_lf_mem_distance_near,
                              distance_far=self.surface_lf_mem_distance_far)
            if self.use_env_map and config.env_map_distance < float("inf"):
                slf_params["distance_far"] = config.env_map_distance
            self.surface_lf_mem = surface_light_field.SurfaceLightFieldMLP(
                config=config, use_env_alpha=True, **slf_params)

    def build_env_map(self):
        """The environment map ``env_map``: an SLF over [env_map_near,
        env_map_far] with ``env_map_params`` (under use_env_map, in the
        steady cache)."""
        if self.use_env_map and self._has_env_map and not hasattr(self, "env_map"):
            self.env_map = surface_light_field.SurfaceLightFieldMLP(
                config=self.config, **dict(self.env_map_params or {},
                                           distance_near=self.env_map_near,
                                           distance_far=self.env_map_far))

    def get_slf_results(self, rng, rays, train_frac, train, stopgrad_cache_weight=None,
                        dist_only=False, cache_tdist=None, **env_kwargs):
        """The memory's incoming radiance along `rays` [..., 3]: one query
        per ray from its origin along its direction, reported as a secondary
        render (``rgb``, ``acc`` and their ``_no_stopgrad`` twins, the
        outputs' gradient scaled by ``stopgrad_cache_weight[1]``; the rays'
        own fields pass theirs in full, as in JAX, whose
        ``stopgrad_slf_weight`` no caller passes), composited over the
        environment map (``_handle_secondary``'s `env_kwargs`), beside the
        memory's ``incoming_*`` outputs. `cache_tdist` [..., N]: also those
        distances in the memory's s (``cache_sdist``); with `dist_only` that
        alone."""
        origins = rays.origins[..., None, :]
        key, rng = torchutil.random_split(rng)
        slf = self.surface_lf_mem(
            key, rays, {"means": origins, "covs": torch.ones_like(origins)}, origins,
            rays.viewdirs[..., None, :], roughness=torch.zeros_like(origins[..., :1]),
            shader_bottleneck=None, train=train, train_frac=train_frac, dist_only=dist_only,
            cache_tdist=cache_tdist)
        if dist_only:
            return slf
        key, rng = torchutil.random_split(rng)
        out = self._handle_secondary(True, {"rgb": slf["incoming_rgb"], "acc": slf["incoming_acc"]},
                                     stopgrad_cache_weight, key, rays, train, train_frac,
                                     **env_kwargs)
        out.update(slf)
        out["incoming_rgb"] = out["rgb_no_stopgrad"]
        out["incoming_acc"] = out["acc_no_stopgrad"]
        return out

    def forward(self, rng, rays, train_frac=1.0, train=True, sampling_strategy=None,
                is_secondary=False, resample=False, cache_outputs=None,
                filtered_sampler_inds=None, stopgrad_cache_weight=None, proposal_grad=True,
                weights_only=False, use_slf=False, vignette=None, mesh=None, use_mesh=True,
                **render_kwargs):
        """Render a ray batch; returns {"main": per-stage results, "render": rgb etc.}.

        cache_outputs: {"sampler": ray history} of an earlier forward to reuse
        instead of sampling again (the gradient-debias pass).
        stopgrad_cache_weight: (w_rays, w_out) of secondary rays (the material
        shader's): every ray field passes gradient scaled by w_rays into the
        sampler, shader and integrator, and the rgb/transient/acc outputs
        pass theirs scaled by w_out (``_handle_secondary``). Ignored for
        primary rays.
        proposal_grad: False runs the sampler's proposal levels without a graph
        (``ProposalVolumeSampler.forward``).
        weights_only: the render is the opacity alone (``acc``, the sum of the
        weights), from each sample's density without its normals, and no
        shader runs: the shadow rays read nothing else. (JAX renders unit
        colours and transients there, which its compiler drops unread; here
        they would be [rays, samples, bins, C] tensors of ones.)
        use_slf: the query reads the surface light field memory instead
        (``get_slf_results``, which takes `stopgrad_cache_weight` whether
        or not the rays are secondary).
        vignette: the per-ray multiplier [..., 1] of the render's rgb (a
        material model's ``VignetteMap``), or None.
        mesh, use_mesh: the sampler's mesh shortcut (an ``ops/mesh``
        TriangleMesh on the rays' device, ``ProposalVolumeSampler.forward``).
        use_env_map, env_map, env_map_w, env_map_h: under the model's
        ``use_env_map``, whether a secondary render is composited over the
        environment map, and the map's tables to look up in place of the
        learned map (``_handle_env_map``); env_map_only: the map's radiance
        along the rays alone (`stopgrad_cache_weight` applies to it).
        dist_only, cache_tdist: of a ``use_slf`` query (``get_slf_results``).
        """
        env_kwargs = {k: render_kwargs.pop(k) for k in ("use_env_map", "env_map", "env_map_w",
                                                        "env_map_h") if k in render_kwargs}
        env_map_only = render_kwargs.pop("env_map_only", False)
        slf_kwargs = {k: render_kwargs.pop(k) for k in ("dist_only", "cache_tdist")
                      if k in render_kwargs}
        if is_secondary and self.use_env_map:
            rays = rays.replace(far=torch.clamp(rays.far, max=self.config.env_map_distance))
        if use_slf:
            return self.get_slf_results(rng, rays, train_frac, train, stopgrad_cache_weight,
                                        **slf_kwargs, **env_kwargs)
        if env_map_only and self.use_env_map:
            return self._handle_env_map(rng, rays, train, train_frac,
                                        stopgrad_cache_weight=stopgrad_cache_weight, **env_kwargs)
        do_resample = self.do_resample(resample, is_secondary, train)
        bg_intensity_range, use_raydist_fn = self.get_bg_and_raydist(is_secondary)
        if not is_secondary:
            stopgrad_cache_weight = None
        env_rays = rays
        rays = torchutil.partial_stopgrad_rays(rays, stopgrad_cache_weight)

        if cache_outputs is not None:
            sampler_results = [dict(r) for r in cache_outputs["sampler"]]
        else:
            key, rng = torchutil.random_split(rng)
            sampler_results = self.sampler(
                rng=key, rays=rays, train_frac=train_frac, train=train,
                sampling_strategy=self.get_sampling_strategy(train, sampling_strategy),
                use_raydist_fn=use_raydist_fn, is_secondary=is_secondary,
                proposal_grad=proposal_grad, density_only=weights_only, mesh=mesh,
                use_mesh=use_mesh, **render_kwargs)

        key, rng = torchutil.random_split(rng)
        filtered, filtered_sampler_inds = self.maybe_resample(
            key, do_resample, sampler_results[-1], self.num_resample,
            inds=filtered_sampler_inds, logits_mult=self._get_logits_mult(is_secondary))
        if weights_only:
            if (is_secondary and self.use_env_map and not self._has_env_map
                    and env_kwargs.get("use_env_map", True)):
                raise NotImplementedError(ENV_MAP_GAP)
            # The opacity alone: the environment's composite changes only
            # the colour, which nothing reads here.
            render = self._handle_secondary(
                is_secondary, {"acc": filtered["weights_no_filter"].sum(dim=-1)},
                stopgrad_cache_weight)
            return {"main": dict(sampler=sampler_results, integrator=render), "render": render}

        key, rng = torchutil.random_split(rng)
        shader_results, integrator_results = self.apply_shader_and_integrator(
            key, rays, filtered, self.geometry_stopgrad_map(do_resample),
            train, train_frac, is_secondary, bg_intensity_range,
            stopgrad_cache_weight=stopgrad_cache_weight, vignette=vignette,
            sampler_results=sampler_results, env_rays=env_rays, env_kwargs=env_kwargs,
            **render_kwargs)

        main = dict(
            loss_weight=1.0, sampler=sampler_results, filtered_sampler_inds=filtered_sampler_inds,
            shader=shader_results, geometry=sampler_results[-1], integrator=integrator_results,
        )
        return {"main": main, "render": integrator_results}


@gin.configurable
class TransientNeRFModel(NeRFModel):
    """Time-resolved radiance cache (InvProp): proposal sampler +
    TransientNeRFMLP + TransientVolumeIntegrator."""

    _shader_cls = nerf_shader.TransientNeRFMLP
    _integrator_cls = integrator_lib.TransientVolumeIntegrator
    _has_surface_lf_mem = False
    _has_env_map = False

    def get_slf_results(self, rng, rays, train_frac, train, stopgrad_cache_weight=None,
                        **kwargs):
        raise NotImplementedError(
            "a surface-light-field query of the transient cache: the JAX package's "
            "TransientNeRFModel builds no SLF memory and has no get_slf_results "
            "(models/nerf_model.py:625-640), so the transient material SLF stages have no "
            "reference")


@gin.configurable
class VignetteMap(Configurable, nn.Module):
    """Per-ray vignette multiplier 2 sigmoid(MLP(pos_enc(dot(viewdirs,
    look)))) [..., 1]: ``net_depth_vignette`` he-uniform Dense layers
    (``layer.{i}``) and a one-wide ``output_layer``. As in JAX, the skip
    concatenation of the encoded input is tested once, after the loop, on
    the last layer's index: it feeds the output layer when that index is a
    positive multiple of ``skip_layer_vignette`` (depth 5 at the default 4),
    never at the default depth 2."""

    deg_vignette = 2
    net_depth_vignette = 2
    net_width_vignette = 64
    skip_layer_vignette = 4
    net_activation = staticmethod(F.relu)

    def __init__(self, config=None, **kwargs):
        nn.Module.__init__(self)
        self.config = config
        self._set_fields(kwargs)
        in_dim = 1 + 2 * self.deg_vignette
        widths = [in_dim] + [self.net_width_vignette] * self.net_depth_vignette
        self.layer = nn.ModuleList(Dense(a, b) for a, b in zip(widths[:-1], widths[1:]))
        last = self.net_depth_vignette - 1
        self._skip = last % self.skip_layer_vignette == 0 and last > 0
        self.output_layer = Dense(widths[-1] + (in_dim if self._skip else 0), 1)

    def forward(self, rays):
        x = coord.pos_enc(math.dot(rays.viewdirs, rays.look), 0, self.deg_vignette, True)
        inputs = x
        for layer in self.layer:
            x = self.net_activation(layer(x))
        if self._skip:
            x = torch.cat([x, inputs], dim=-1)
        return torch.sigmoid(self.output_layer(x)) * 2.0
