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

Not ported yet: resampling of primary rays, volume control variates and
environment maps (they raise), and the argmax resample and ray-distance
warps of secondary rays.
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


# Fields of the JAX ``Model`` whose code paths are not ported; the importance
# sampler tuples stand as (JAX sampler class name, weight) pairs.
_MODEL_UNPORTED = dict(
    random_generator_2d=render_utils.RandomGenerator2D(1, 1, False),
    uniform_importance_samplers=(("UniformHemisphereSampler", 1.0),),
    active_importance_samplers=(("ActiveSampler", 1.0),),
    resample_argmax=False,
    stopgrad_weight_variate=1.0,
    stopgrad_weight_model=1.0,
)


class Model(Configurable, nn.Module, unported=_MODEL_UNPORTED):
    """Shared base: resampled estimator and secondary-ray bookkeeping."""

    # Importance samplers the JAX model declares and nothing reads.
    uniform_sphere_importance_samplers = (("UniformSphereSampler", 1.0),)
    cosine_importance_samplers = (("CosineSampler", 1.0),)
    light_importance_samplers = (("UniformHemisphereSampler", 1.0),)
    distance_importance_samplers = (("UniformHemisphereSampler", 1.0),)
    light_field_importance_samplers = (("UniformHemisphereSampler", 1), ("MicrofacetSampler", 1))
    irradiance_importance_samplers = (("CosineSampler", 1), ("LightSampler", 1))
    extra_ray_importance_samplers = (("UniformHemisphereSampler", 1), ("IdentitySampler", 1))
    use_env_map = False
    # Read by the env map only (use_env_map).
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
    num_resample = 1
    logits_mult = 1.0
    logits_mult_secondary = 1.0
    weights_bias = 0.0
    stopgrad_geometry_weight = 1.0
    stopgrad_geometry_feature_weight = 1.0
    stopgrad_geometry_normals_weight = 1.0
    use_raydist_for_secondary_only = False
    train_sampling_strategy = ((0, 0, 64), (1, 1, 64), (2, 2, 32))
    render_sampling_strategy = ((0, 0, 64), (1, 1, 64), (2, 2, 32))

    def _init_model(self, config, kwargs):
        nn.Module.__init__(self)
        self.config = config
        self._set_fields(kwargs)
        self._require(use_env_map=False)
        if config.volume_variate or config.volume_variate_secondary:
            raise NotImplementedError("volume control variates are not ported yet")

    def do_resample(self, do_resample, is_secondary, train):
        return (do_resample or (train and self.resample) or (not train and self.resample_render)
                or (is_secondary and self.resample_secondary))

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
        `inds`); the kept weights are divided by the detached N * p.

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
        logits = math.safe_log(weights + self.weights_bias) * logits_mult
        probs = torch.softmax(logits, dim=-1)
        if inds is None:
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
        filtered_probs = torch.gather(probs, -1, inds)
        filtered["weights"] = filtered["weights"] / (num_resample * filtered_probs + 1e-8).detach()
        return filtered, inds

    def _handle_secondary(self, is_secondary, integrator_results, stopgrad_cache_weight=None):
        """Secondary rays report every rgb/transient/acc output also under
        `<key>_no_stopgrad`, which the material shader reads; with the
        material shader's ``stopgrad_cache_weight`` (w_rays, w_out) the
        outputs themselves pass gradient scaled by w_out (their
        `_no_stopgrad` twins in full)."""
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
        return integrator_results

    def apply_shader_and_integrator(self, rng, rays, filtered_sampler_results, stopgrad_map,
                                    train, train_frac, is_secondary, bg_intensity_range,
                                    stopgrad_cache_weight=None, vignette=None, **render_kwargs):
        """Shade the (filtered) samples and composite them; the render's rgb
        times `vignette` [..., 1] if given."""
        inputs = torchutil.apply_stopgrad_fields(filtered_sampler_results, stopgrad_map)
        shared = dict(train_frac=train_frac, train=train, is_secondary=is_secondary)
        key, rng = torchutil.random_split(rng)
        shader_results = self.shader(rng=key, rays=rays, sampler_results=inputs,
                                     filtered_sampler_results=inputs, **shared, **render_kwargs)
        shader_results.setdefault("weights_no_filter", shader_results["weights"])
        if is_secondary:
            # Nothing in a train step or a primary render reads the
            # ray-distance statistics of secondary rays; the secondary-ray
            # probe's render asks for them.
            render_kwargs.setdefault("compute_distance", False)
        key, rng = torchutil.random_split(rng)
        integrator_results = self.integrator(
            rng=key, rays=rays, shader_results=shader_results,
            bg_intensity_range=bg_intensity_range, vignette=vignette, **shared, **render_kwargs)
        integrator_results = self._handle_secondary(is_secondary, integrator_results,
                                                    stopgrad_cache_weight)
        return shader_results, integrator_results


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

    def __init__(self, config=None, **kwargs):
        self._init_model(config, kwargs)
        self._require(resample=False, resample_render=False)
        self.sampler = sampler_lib.ProposalVolumeSampler(
            config=config, **dict(self.sampler_params or {}),
            **dict(self.extra_model_params or {}))
        self.shader = self._shader_cls(
            config=config, density_feature_dim=self.sampler.mlps[-1].feature_dim,
            **dict(self.shader_params or {}))
        self.integrator = self._integrator_cls(
            config=config, **dict(self.integrator_params or {}))
        if self.use_surface_light_field and self._has_surface_lf_mem:
            slf_params = dict(self.surface_lf_mem_params or {})
            slf_params.update(distance_near=self.surface_lf_mem_distance_near,
                              distance_far=self.surface_lf_mem_distance_far)
            self.surface_lf_mem = surface_light_field.SurfaceLightFieldMLP(
                config=config, use_env_alpha=True, **slf_params)

    def get_slf_results(self, rng, rays, train_frac, train, stopgrad_cache_weight=None):
        """The memory's incoming radiance along `rays` [..., 3]: one query
        per ray from its origin along its direction, reported as a secondary
        render (``rgb``, ``acc`` and their ``_no_stopgrad`` twins, the
        outputs' gradient scaled by ``stopgrad_cache_weight[1]``; the rays'
        own fields pass theirs in full, as in JAX, whose
        ``stopgrad_slf_weight`` no caller passes) beside the memory's
        ``incoming_*`` outputs."""
        origins = rays.origins[..., None, :]
        slf = self.surface_lf_mem(
            rng, rays, {"means": origins, "covs": torch.ones_like(origins)}, origins,
            rays.viewdirs[..., None, :], roughness=torch.zeros_like(origins[..., :1]),
            shader_bottleneck=None, train=train, train_frac=train_frac)
        out = self._handle_secondary(True, {"rgb": slf["incoming_rgb"], "acc": slf["incoming_acc"]},
                                     stopgrad_cache_weight)
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
        """
        if use_slf:
            return self.get_slf_results(rng, rays, train_frac, train, stopgrad_cache_weight)
        do_resample = self.do_resample(resample, is_secondary, train)
        bg_intensity_range, use_raydist_fn = self.get_bg_and_raydist(is_secondary)
        if not is_secondary:
            stopgrad_cache_weight = None
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
            render = self._handle_secondary(
                is_secondary, {"acc": filtered["weights_no_filter"].sum(dim=-1)},
                stopgrad_cache_weight)
            return {"main": dict(sampler=sampler_results, integrator=render), "render": render}

        key, rng = torchutil.random_split(rng)
        shader_results, integrator_results = self.apply_shader_and_integrator(
            key, rays, filtered, self.geometry_stopgrad_map(do_resample),
            train, train_frac, is_secondary, bg_intensity_range,
            stopgrad_cache_weight=stopgrad_cache_weight, vignette=vignette, **render_kwargs)

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

    def get_slf_results(self, rng, rays, train_frac, train, stopgrad_cache_weight=None):
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
