"""Model composition: sampler -> (resample) -> shader -> integrator
(counterpart of ``Model`` and ``NeRFModel`` in ``models/nerf_model.py``).

``Model`` carries the resampled estimator (a categorical draw of
num_resample samples proportional to the weights, with the weights divided
by the detached N * p so the estimate stays unbiased) and the secondary-ray
bookkeeping. ``NeRFModel`` is the radiance cache: primary rays without
resampling, and secondary rays (``is_secondary``) with it when
``resample_secondary`` is set, as the material stage traces them.
``TransientNeRFModel`` is the transient (time-resolved) cache, with its
weights-only rendering (unit colours and transients, for shadow-ray
visibility).

Not ported yet: resampling of primary rays, weights-only rendering of the
steady cache, volume control variates, environment maps and the
surface-light-field memory (they raise), and the argmax resample and
ray-distance warps of secondary rays.
"""

from __future__ import annotations

import torch
from torch import nn

from neural_radiance_caching_tpu_torch.models import integrator as integrator_lib
from neural_radiance_caching_tpu_torch.models import nerf_shader, sampler as sampler_lib
from neural_radiance_caching_tpu_torch.models.layers import Configurable
from neural_radiance_caching_tpu_torch.ops import math
from neural_radiance_caching_tpu_torch.utils import torchutil


class Model(Configurable, nn.Module):
    """Shared base: resampled estimator and secondary-ray bookkeeping."""

    use_env_map = False
    use_surface_light_field = False
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
    train_sampling_strategy = ((0, 0, 64), (1, 1, 64), (2, 2, 32))
    render_sampling_strategy = ((0, 0, 64), (1, 1, 64), (2, 2, 32))

    def _init_model(self, config, kwargs):
        nn.Module.__init__(self)
        self.config = config
        self._set_fields(kwargs)
        self._require(use_env_map=False, use_surface_light_field=False)
        if config.volume_variate or config.volume_variate_secondary:
            raise NotImplementedError("volume control variates are not ported yet")

    def do_resample(self, do_resample, is_secondary, train):
        return (do_resample or (train and self.resample) or (not train and self.resample_render)
                or (is_secondary and self.resample_secondary))

    def get_bg_intensity_range(self, is_secondary):
        """Secondary rays composite over black; primary rays take the
        integrator's own background."""
        return (0.0, 0.0) if is_secondary else None

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

    def _handle_secondary(self, is_secondary, integrator_results):
        """Secondary rays report every rgb/acc output also under
        `<key>_no_stopgrad`, which the material shader reads (the cache's
        partial stop-gradient of secondary rays is not ported: the two
        keys carry the same tensor)."""
        if not is_secondary:
            return integrator_results
        for k in list(integrator_results):
            v = integrator_results[k]
            if v is not None and any(s in k for s in ("rgb", "transient", "acc")):
                integrator_results[f"{k}_no_stopgrad"] = v
        return integrator_results

    def apply_shader_and_integrator(self, rng, rays, filtered_sampler_results, stopgrad_map,
                                    train, train_frac, is_secondary, bg_intensity_range,
                                    **render_kwargs):
        """Shade the (filtered) samples and composite them."""
        weights_only = render_kwargs.pop("weights_only", False)
        inputs = torchutil.apply_stopgrad_fields(filtered_sampler_results, stopgrad_map)
        shared = dict(train_frac=train_frac, train=train, is_secondary=is_secondary)
        key, rng = torchutil.random_split(rng)
        if weights_only:
            shader_results = self.make_weights_only_shader_results(rays, inputs)
        else:
            shader_results = self.shader(rng=key, rays=rays, sampler_results=inputs,
                                         filtered_sampler_results=inputs, **shared,
                                         **render_kwargs)
            shader_results.setdefault("weights_no_filter", shader_results["weights"])
        if is_secondary:
            # Nothing reads the ray-distance statistics of secondary rays.
            render_kwargs["compute_distance"] = False
        key, rng = torchutil.random_split(rng)
        integrator_results = self.integrator(
            rng=key, rays=rays, shader_results=shader_results,
            bg_intensity_range=bg_intensity_range, **shared, **render_kwargs)
        integrator_results = self._handle_secondary(is_secondary, integrator_results)
        return shader_results, integrator_results

    def make_weights_only_shader_results(self, rays, sampler_results):
        raise NotImplementedError(f"weights-only rendering of {type(self).__name__} "
                                  "is not ported yet")


class NeRFModel(Model):
    """Radiance cache: proposal sampler + NeRFMLP + integrator."""

    sampler_params = None
    shader_params = None
    integrator_params = None
    extra_model_params = None
    _shader_cls = nerf_shader.NeRFMLP
    _integrator_cls = integrator_lib.VolumeIntegrator

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

    def forward(self, rng, rays, train_frac=1.0, train=True, sampling_strategy=None,
                is_secondary=False, resample=False, cache_outputs=None,
                filtered_sampler_inds=None, **render_kwargs):
        """Render a ray batch; returns {"main": per-stage results, "render": rgb etc.}.

        cache_outputs: {"sampler": ray history} of an earlier forward to reuse
        instead of sampling again (the gradient-debias pass).
        """
        do_resample = self.do_resample(resample, is_secondary, train)

        if cache_outputs is not None:
            sampler_results = [dict(r) for r in cache_outputs["sampler"]]
        else:
            key, rng = torchutil.random_split(rng)
            sampler_results = self.sampler(
                rng=key, rays=rays, train_frac=train_frac, train=train,
                sampling_strategy=self.get_sampling_strategy(train, sampling_strategy),
                is_secondary=is_secondary, **render_kwargs)

        key, rng = torchutil.random_split(rng)
        filtered, filtered_sampler_inds = self.maybe_resample(
            key, do_resample, sampler_results[-1], self.num_resample,
            inds=filtered_sampler_inds, logits_mult=self._get_logits_mult(is_secondary))

        key, rng = torchutil.random_split(rng)
        shader_results, integrator_results = self.apply_shader_and_integrator(
            key, rays, filtered, self.geometry_stopgrad_map(do_resample),
            train, train_frac, is_secondary, self.get_bg_intensity_range(is_secondary),
            **render_kwargs)

        main = dict(
            loss_weight=1.0, sampler=sampler_results, filtered_sampler_inds=filtered_sampler_inds,
            shader=shader_results, geometry=sampler_results[-1], integrator=integrator_results,
        )
        return {"main": main, "render": integrator_results}


class TransientNeRFModel(NeRFModel):
    """Time-resolved radiance cache (InvProp): proposal sampler +
    TransientNeRFMLP + TransientVolumeIntegrator."""

    _shader_cls = nerf_shader.TransientNeRFMLP
    _integrator_cls = integrator_lib.TransientVolumeIntegrator

    def make_weights_only_shader_results(self, rays, sampler_results):
        """Unit colours and transients over the sampler's weights, with the
        distances the transient integrator bins by."""
        out = dict(sampler_results)
        means = sampler_results["means"]
        out["light_dists"] = torch.linalg.norm(rays.lights[..., None, :] - means, dim=-1,
                                               keepdim=True)
        out["ray_dists"] = torch.linalg.norm(rays.origins[..., None, :] - means, dim=-1,
                                             keepdim=True)
        weights = sampler_results["weights"]
        t_shape = weights.shape + (self.config.n_bins, self.config.num_rgb_channels)
        for k in ("transient_indirect", "transient_indirect_specular",
                  "transient_indirect_diffuse"):
            out[k] = torch.ones(t_shape, dtype=weights.dtype, device=weights.device)
        out["rgb"] = out["direct_rgb"] = torch.ones_like(weights)[..., None].expand(
            weights.shape + (self.config.num_rgb_channels,))
        return out
