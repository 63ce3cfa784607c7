"""Stage-dependent extra losses (counterpart of the part of
``parallel/extra_losses.py`` the material stages reach): the cache/material
consistency loss, steady and transient, with its weight ease-in, the
light-sampling fit of the vMF mixture, the secondary-ray sampler's
supervision (``material_ray_sampler``), the material smoothness
regularizer, the geometry smoothness regularizer (the InvProp cache
stage's), and the surface light field's distillation from the cache
(``material_surface_light_field``, also dispatched as
``surface_light_field``) with its weight ease-in, the emission and
residual-albedo regularizers, and the losses the JAX package turns on by a
Config weight as well as by name: the maximum radiance, the weight
normalisation tether (0 where no model emits the weights it ties, as in
JAX), the material / irradiance decorrelation (``material_correlation``,
on the SLF variate's ``irradiance_cache``) and, on the material output
alone, the extra-ray consistency (``extra_ray``: two more model forwards
along the rays' views turned into uniform hemisphere directions at their
first sample's normal, the second reusing the first's cache samples
without a graph).

``Config.extra_losses`` maps a loss name to {output key: {"mult", ...}}; the
staged trainer binds its material stages' losses (``configs/trainer.gin``)
and ``direct_indirect_consistency`` on ``main`` for every material stage
(``flagship.trainer_consistency_losses``). The losses of
``EXTRA_LOSS_FUNCTIONS`` take (model, rng, rays, config, batch, results,
full_results, train_frac), `results` being one output's dict and
`full_results` the whole model output; each draws from `rng` in dict
order, as the JAX losses take their keys from one split chain. The
consistency losses read the material shader's outputs and their
``cache_*`` counterparts (the cache shader at the same surface points), and
the ``_nocorr`` outputs of the gradient-debias forward only under a
stop-gradient, so that forward needs no graph (``parallel/train.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from neural_radiance_caching_tpu_torch.ops import math, render_utils
from neural_radiance_caching_tpu_torch.parallel import losses as losses_lib
from neural_radiance_caching_tpu_torch.utils import torchutil
from neural_radiance_caching_tpu_torch.utils.torchutil import stopgrad_with_weight

CONSISTENCY = "direct_indirect_consistency"


def _weight_ease(train_frac, use, start, frac, min_val):
    if not use:
        return 1.0
    if frac > 0:
        w = float(np.clip(np.float32((train_frac - start) / frac), 0.0, 1.0))
        return min_val * (1.0 - w) + w
    return float(train_frac - start >= 0.0)


def surface_light_field_weight_ease(config, train_frac):
    return _weight_ease(train_frac, config.use_surface_light_field_weight_ease,
                        config.surface_light_field_weight_ease_start,
                        config.surface_light_field_weight_ease_frac,
                        config.surface_light_field_weight_ease_min)


def extra_ray_weight_ease(config, train_frac):
    return _weight_ease(train_frac, config.use_extra_ray_weight_ease,
                        config.extra_ray_weight_ease_start, config.extra_ray_weight_ease_frac,
                        config.extra_ray_weight_ease_min)


def consistency_weight_ease(config, train_frac):
    return _weight_ease(train_frac, config.use_consistency_weight_ease,
                        config.consistency_weight_ease_start, config.consistency_weight_ease_frac,
                        config.consistency_weight_ease_min)


def _consistency_data_loss(config, batch, rays, rgb, rgb_nocorr, rgb_cache, rgb_cache_nocorr,
                           lossmult, transient=False):
    """The data loss of the material's `rgb` against the cache's `rgb_cache`
    as its target, under ``cache_consistency_loss_type``."""
    rgb = stopgrad_with_weight(rgb, config.cache_consistency_stopgrad_weight_material)
    rgb_nocorr = stopgrad_with_weight(rgb_nocorr, config.cache_consistency_stopgrad_weight_material)
    rgb_cache = stopgrad_with_weight(rgb_cache, config.cache_consistency_stopgrad_weight_cache)
    rgb_cache_nocorr = stopgrad_with_weight(rgb_cache_nocorr,
                                            config.cache_consistency_stopgrad_weight_cache)
    rendering = {"rgb": torch.nan_to_num(rgb),
                 "rgb_nocorr": torch.nan_to_num(rgb_nocorr).detach(),
                 "cache_rgb": torch.nan_to_num(rgb_cache).detach()}
    if not config.cache_consistency_use_integrated:
        rendering["gt_nocorr"] = torch.nan_to_num(rgb_cache_nocorr).detach()
    masks = batch.masks if batch.masks is not None else torch.ones_like(rays.lossmult)
    if transient:
        masks = masks.reshape(masks.shape[0], 1)
    else:
        shape = rgb.shape[:-1] + (1,)
        masks = torch.broadcast_to(masks.reshape((masks.shape[0],) + (1,) * (len(shape) - 1)),
                                   shape)
    target = batch.replace(rgb=torch.nan_to_num(rgb_cache), masks=masks)
    cfg = dataclasses.replace(config, data_loss_type=config.cache_consistency_loss_type,
                              is_material=True)
    return losses_lib.compute_data_loss(target, rendering, rays.replace(lossmult=lossmult), cfg,
                                        transient=transient)[0]


def _consistency_term(config, batch, rays, shader, prefix, transient):
    """(weight group, loss) of one shader output against its cache_ twin, or
    None where the output is absent or a disabled (scalar) component."""
    rgb = shader.get(prefix)
    if f"cache_{prefix}" not in shader or not isinstance(rgb, torch.Tensor) or rgb.dim() < 2:
        return None
    rgb_cache = shader[f"cache_{prefix}"].reshape(rgb.shape)
    rgb_cache_nocorr = shader.get(f"cache_{prefix}_nocorr", rgb_cache).reshape(rgb.shape)
    if transient:
        lossmult = rays.lossmult.reshape(rgb.shape[:1] + (1,) * (rgb.dim() - 2)) * \
            torch.ones_like(rgb[..., 0, :1])
    else:
        lossmult = rays.lossmult.reshape(rgb.shape[:1] + (1,) * (rgb.dim() - 1)) * \
            torch.ones_like(rgb[..., :1])
    loss = _consistency_data_loss(config, batch, rays, rgb, shader.get(f"{prefix}_nocorr", rgb),
                                  rgb_cache, rgb_cache_nocorr, lossmult, transient=transient)
    if "indirect" in prefix:
        return loss * config.cache_consistency_indirect_weight
    if "direct" in prefix:
        return loss * config.cache_consistency_direct_weight
    return loss  # diffuse_rgb, specular_rgb: unweighted


def direct_indirect_consistency_loss(config, batch, rays, results):
    """Per-sample cache-vs-material agreement of the diffuse, specular,
    direct and indirect components (the steady material stage)."""
    loss = 0.0
    for prefix in ("diffuse_rgb", "specular_rgb", "direct_rgb", "indirect_rgb"):
        term = _consistency_term(config, batch, rays, results["shader"], prefix, False)
        if term is not None:
            loss = loss + term
    return loss


def transient_direct_indirect_consistency_loss(config, batch, rays, results):
    """Transient variant: the direct radiance and the time-binned indirect
    transient."""
    loss = 0.0
    for prefix, transient in (("direct_rgb", False), ("transient_indirect", True)):
        term = _consistency_term(config, batch, rays, results["shader"], prefix, transient)
        if term is not None:
            loss = loss + term
    return loss


# --- light sampler fitting ---------------------------------------------------------


def light_sampling_loss(model, rng, rays, config, batch, results, full_results,
                        train_frac=1.0):
    """Fit the vMF mixture of the light sampler to the norms of the radiance
    the indirect lobes' secondary rays brought back (time-integrated on a
    transient model), half per lobe; a lobe that is absent doubles the
    other's."""
    ls = results.get("light_sampler")
    if not ls:
        return 0.0
    shader = results["shader"]
    data_loss, multiplier = 0.0, 1.0
    for suffix in ("_indirect_diffuse", "_indirect_specular"):
        extra_rays = shader.get(f"ref_rays{suffix}")
        if extra_rays is None:
            multiplier = 2.0
            continue
        ref_samples = shader[f"ref_samples{suffix}"]
        radiance = ref_samples["radiance_in"].detach()
        if config.use_transient:
            radiance = radiance.reshape(radiance.shape[:2] + (-1, radiance.shape[-1])).sum(-2)
        function_vals = torch.linalg.norm(radiance, dim=-1)
        viewdirs = extra_rays.viewdirs.reshape(function_vals.shape + (3,)).detach()
        k = ls["vmf_means"].shape[-2]
        vmf_vars = (ls["vmf_means"].reshape(-1, k, 3), ls["vmf_kappas"].reshape(-1, k, 1),
                    ls["vmf_logits"].reshape(-1, k, 1))
        vmf_normals = ls["vmf_normals"].reshape(-1, 3)
        lossmult = rays.lossmult.reshape(-1, 1, 1)
        lossmult = lossmult * torch.ones_like(function_vals.reshape(lossmult.shape[0], -1, 1))
        lossmult = (lossmult / lossmult.shape[-2]).reshape(function_vals.shape)
        # The fit reads the sample records' pdf and weight only (the binned
        # radiance of a transient lobe has no [P, S, d] layout).
        samples = {key: ref_samples[key].detach().reshape(function_vals.shape + (-1,))
                   for key in ("pdf", "weight")}
        data_loss = data_loss + render_utils.vmf_loss_fn(
            vmf_vars, vmf_normals, viewdirs, samples, function_vals, function_vals, lossmult,
            linear_to_srgb=config.light_sampling_linear_to_srgb) / 2.0
    return data_loss * multiplier


# --- secondary-ray proposal supervision ----------------------------------------------


def material_ray_sampler_loss(model, rng, rays, config, batch, results, full_results,
                              train_frac=1.0):
    """The cache-stage geometry losses (interlevel, distortion, orientation,
    predicted normals) on the diffuse lobe's secondary rays, each times its
    ``material_ray_sampler_*_mult``. A term whose multipliers make it 0 is
    not computed: its value and gradient are 0 (JAX multiplies it by 0)."""
    shader = results["shader"]
    ref_sampler_results = shader.get("ref_sampler_results_indirect_diffuse")
    ref_rays = shader.get("ref_rays_indirect_diffuse")
    if ref_sampler_results is None or ref_rays is None:
        return 0.0
    if "weights" not in ref_sampler_results[-1]:
        raise NotImplementedError(
            "material_ray_sampler on secondary rays that queried the SLF memory (an SLF "
            "material stage without MaterialModel.slf_variate): they have no sampler "
            "weights, and the JAX loss raises KeyError 'weights' (extra_losses.py:158)")
    shape = ref_rays.viewdirs[..., :1].shape
    lossmult = rays.lossmult.reshape(-1, 1, 1)
    lossmult = (lossmult * torch.ones_like(
        ref_rays.viewdirs[..., :1].reshape(lossmult.shape[0], -1, 1))).reshape(shape)
    ref_sampler_results = [dict(r, weights=r["weights"] * lossmult) for r in ref_sampler_results]
    last = ref_sampler_results[-1]

    loss = 0.0
    if config.material_ray_sampler_interlevel_loss_mult != 0:
        loss = loss + sum(losses_lib.compute_interlevel_loss(
            ref_sampler_results, config.interlevel_loss_mults, config.interlevel_loss_blurs,
            config)) * config.material_ray_sampler_interlevel_loss_mult
    normal_mult = config.material_ray_sampler_normal_loss_mult
    distortion_mult = normal_mult * config.material_ray_sampler_distortion_loss_mult
    if config.distortion_loss_mult > 0 and distortion_mult != 0:
        loss = loss + losses_lib.compute_distortion_loss(
            ref_sampler_results, config.distortion_loss_mult, config) * distortion_mult
    if config.orientation_loss_mult > 0 and config.material_ray_sampler_orientation_loss_mult != 0:
        loss = loss + losses_lib.orientation_loss(ref_rays, last, config) * \
            config.material_ray_sampler_orientation_loss_mult
    beta = torch.ones_like(last["weights"][..., None])
    if config.predicted_normal_loss_mult > 0 and normal_mult != 0:
        loss = loss + losses_lib.predicted_normal_loss(
            last, beta, config, mult=config.predicted_normal_loss_mult, gt="normals_pred",
            pred="normals", stopgrad=config.predicted_normal_loss_stopgrad,
            stopgrad_weight=config.predicted_normal_loss_stopgrad_weight) * normal_mult
    if config.predicted_normal_reverse_loss_mult > 0 and normal_mult != 0:
        loss = loss + losses_lib.predicted_normal_loss(
            last, beta, config, mult=config.predicted_normal_reverse_loss_mult, gt="normals",
            pred="normals_pred", stopgrad=True) * normal_mult
    if not isinstance(loss, torch.Tensor):
        return torch.zeros((), device=ref_rays.viewdirs.device)
    return torch.nan_to_num(loss)


# --- surface light field distillation ------------------------------------------------


def material_surface_light_field_loss(model, rng, rays, config, batch, results, full_results,
                                      train_frac=1.0):
    """Distil the cache into the SLF memory along the SLF variate's shared
    secondary rays, half per indirect lobe (an absent lobe doubles the
    other's, and an output without the variate's rays gives 0): the data
    loss (``surface_light_field_loss_type``, sRGB under
    ``surface_light_field_linear_to_srgb``) of the memory's radiance against
    the cache's, each scaled by its ``surface_light_field_stopgrad_weight_*``,
    on the rays inside ``surface_light_field_loss_radius`` (and above the
    surface under ``surface_light_field_is_secondary``); plus the memory's
    opacity against the cache's within ``env_map_distance`` and, under
    ``surface_light_field_loss_depth_scale``, its distance against the
    cache's, both with the cache's side detached. The secondary rays' final
    sampler level is read only detached."""
    shader = results["shader"]
    data_loss, multiplier = 0.0, 1.0
    for suffix in ("_indirect_diffuse", "_indirect_specular"):
        extra_rays = shader.get(f"ref_rays{suffix}_cache")
        if extra_rays is None:
            multiplier = 2.0
            continue
        ref_samples = shader[f"ref_samples{suffix}_cache"]
        ref_samples_slf = shader[f"ref_samples{suffix}_slf"]
        ref_sampler = shader[f"ref_sampler_results{suffix}_cache"][-1]
        ref_sampler_slf = shader[f"ref_sampler_results{suffix}_slf"][-1]

        sh = ref_samples["radiance_in_no_stopgrad"].shape
        cache_rgb = stopgrad_with_weight(ref_samples["radiance_in_no_stopgrad"],
                                         config.surface_light_field_stopgrad_weight_forward)
        pred_rgb = stopgrad_with_weight(ref_samples_slf["radiance_in_no_stopgrad"].reshape(sh),
                                        config.surface_light_field_stopgrad_weight_backward)
        if config.use_transient:
            cache_rgb = cache_rgb.reshape(sh[:2] + (-1, sh[-1])).sum(dim=-2)
            pred_rgb = pred_rgb.reshape(cache_rgb.shape)
            sh = cache_rgb.shape
        cache_weights = ref_sampler["weights"].detach().reshape(sh[:-1] + (-1,))

        if config.surface_light_field_loss_radius < float("inf"):
            lossmult = (torch.linalg.norm(extra_rays.origins, dim=-1, keepdim=True)
                        < config.surface_light_field_loss_radius).reshape(
                sh[:-1] + (1,)).to(torch.float32)
        else:
            lossmult = torch.ones_like(cache_rgb[..., :1])
        if config.surface_light_field_is_secondary:
            lossmult = torch.where(
                ref_samples["local_lightdirs"][..., -1].reshape(lossmult.shape) > 0.0,
                lossmult, torch.zeros_like(lossmult))
        lossmult = lossmult.detach()

        extra_batch = batch.replace(rgb=cache_rgb, masks=torch.ones_like(cache_rgb[..., :1]))
        cur_config = dataclasses.replace(
            config, data_loss_type=config.surface_light_field_loss_type,
            convert_srgb=config.surface_light_field_linear_to_srgb, loss_clip=float("inf"),
            loss_thresh=float("inf"))
        cur_loss = losses_lib.compute_data_loss(
            extra_batch, {"rgb": pred_rgb, "cache_rgb": cache_rgb},
            extra_rays.replace(lossmult=lossmult), cur_config)[0]

        # The memory's opacity within the environment distance against the cache's.
        if "incoming_weights" in ref_sampler_slf:
            pred_dist = ref_sampler_slf["incoming_dist"].reshape(sh[:-1] + (-1,))
            pred_weights = ref_sampler_slf["incoming_weights"].reshape(sh[:-1] + (-1,))
            pred_env_acc = torch.where(pred_dist < config.env_map_distance, pred_weights,
                                       torch.zeros_like(pred_weights)).sum(dim=-1).reshape(
                sh[:-1] + (1,))
            cache_tdist = ref_sampler["tdist"][..., :-1].detach().reshape(sh[:-1] + (-1,))
            env_acc = torch.where(cache_tdist < config.env_map_distance, cache_weights,
                                  torch.zeros_like(cache_weights)).sum(dim=-1).reshape(
                sh[:-1] + (1,))
            acc_loss = torch.square(env_acc - pred_env_acc) * lossmult
            acc_loss = torch.where(env_acc > 0.5,
                                   acc_loss * config.surface_light_field_loss_acc_scale_opaque,
                                   acc_loss * config.surface_light_field_loss_acc_scale_empty)
            cur_loss = cur_loss + acc_loss.mean()

            if config.surface_light_field_loss_depth_scale > 0 and (
                    "incoming_s_dist" in ref_sampler_slf and ref_sampler.get("sdist") is not None):
                pred_sdist = ref_sampler_slf["incoming_s_dist"].reshape(sh[:-1] + (1,))
                cache_sdist = ref_sampler["sdist"][..., :-1].detach().reshape(sh[:-1] + (-1,))
                cur_loss = cur_loss + (
                    torch.abs(cache_sdist - pred_sdist) * cache_weights * lossmult
                ).sum(dim=-1).mean() * config.surface_light_field_loss_depth_scale

        data_loss = data_loss + cur_loss / 2.0
    return data_loss * multiplier


# --- material smoothness -------------------------------------------------------------

_MATERIAL_SMOOTHNESS_KEYS = ("material_albedo", "material_roughness", "material_F_0",
                             "material_metalness", "material_diffuseness", "material_mirrorness")


def _filter_tensors(d):
    """The tensor entries of a shader dict (it also holds rays, sample
    records and per-level lists)."""
    return {k: v for k, v in d.items() if isinstance(v, torch.Tensor)}


def material_smoothness_loss(model, rng, rays, config, batch, results, full_results,
                             train_frac=1.0):
    """Penalise the material heads' change between one resampled surface
    point per ray and a Gaussian jitter of it (``material_smoothness_noise``),
    L1 or L2, relative for the albedo under ``material_smoothness_tensoir_albedo``,
    optionally weighted down across shadow boundaries by the similarity of
    the cache's radiance at the two points (the irradiance weight).

    Draws in JAX's order: the resample, the jitter, the perturbed pass. That
    pass runs the material heads only (``material_only``) and the cache
    shader: the loss reads nothing else, and the full material shader would
    trace its secondary rays through the cache.
    """
    key, rng = torchutil.random_split(rng)
    shader_results, inds = model.maybe_resample(key, True, _filter_tensors(results["shader"]), 1)
    cache_shader = full_results.get("cache_main", {}).get("shader")
    if cache_shader is None:
        return 0.0
    key, rng = torchutil.random_split(rng)
    cache_shader_results, _ = model.maybe_resample(key, True, _filter_tensors(cache_shader), 1,
                                                   inds=inds)
    weights = {"material_albedo": config.material_smoothness_weight_albedo}
    weights.update({k: config.material_smoothness_weight_other
                    for k in _MATERIAL_SMOOTHNESS_KEYS[1:]})

    means = shader_results["means"]
    key, rng = torchutil.random_split(rng)
    noise = torchutil.normal(key, means.shape, means.device)
    perturbed_inputs = {k: v.detach() for k, v in shader_results.items()}
    perturbed_inputs["means"] = (means + noise * config.material_smoothness_noise).detach()
    key, rng = torchutil.random_split(rng)
    perturbed = model(key, rays, train_frac=train_frac, train=True, compute_extras=False,
                      passes=("material_cache_shader",), sampler_results=perturbed_inputs,
                      material_only=True)
    perturbed_cache, perturbed_mat = (
        {k: torch.nan_to_num(v) for k, v in _filter_tensors(perturbed[part]).items()}
        for part in ("cache", "material"))

    lossmult = rays.lossmult.reshape(-1, 1, 1)
    lossmult = (lossmult * torch.ones_like(means[..., :1].reshape(lossmult.shape[0], -1, 1))
                ).reshape(means[..., :1].shape) * (
        shader_results["weights"][..., None] * shader_results["weights"].shape[-1]).detach()

    # Unit irradiance: the SLF variate's irradiance_cache is an output of its
    # own shader pass, and the material model copies only that pass's ref_*
    # keys into these shader results (as in JAX).
    nc = config.num_rgb_channels
    irr = torch.ones_like(means[..., :nc])
    cache_rgb_key = "rgb" if "rgb" in cache_shader_results else "direct_rgb"
    cache_rgb = torch.abs(cache_shader_results[cache_rgb_key]).reshape(
        irr.shape[:-1] + (-1,))[..., :nc].detach() / (torch.clamp(irr, min=0.0) + 1e-5)
    perturbed_rgb = torch.abs(perturbed_cache[cache_rgb_key]).reshape(
        cache_rgb.shape).detach() / (torch.clamp(irr, min=0.0) + 1e-5)
    irradiance_weight = 2.0 * torch.sigmoid(-torch.sum(
        torch.abs(cache_rgb - perturbed_rgb) / (torch.maximum(cache_rgb, perturbed_rgb) + 1e-5),
        dim=-1, keepdim=True) * config.material_smoothness_irradiance_multiplier)
    if config.material_smoothness_irradiance_weight:
        w = irradiance_weight + config.material_smoothness_base
    else:
        w = torch.ones_like(irradiance_weight)

    loss = 0.0
    for k in _MATERIAL_SMOOTHNESS_KEYS:
        if k not in shader_results or k not in perturbed_mat:
            continue
        value, other = shader_results[k], perturbed_mat[k].reshape(shader_results[k].shape)
        diff = value - other
        if "albedo" in k and config.material_smoothness_tensoir_albedo:
            denom = torch.maximum(value, other)
            if config.material_smoothness_albedo_stopgrad:
                denom = denom.detach()
            diff = diff / torch.clamp(denom, min=1e-6)
        penalty = torch.abs(diff) if config.material_smoothness_l1_loss else torch.square(diff)
        loss = loss + (penalty * w * lossmult.reshape(value.shape[:-1] + (-1,))
                       * weights[k]).mean()
    return loss


# --- geometry smoothness -------------------------------------------------------------


def geometry_smoothness_loss(model, rng, rays, config, batch, results, full_results,
                             train_frac=1.0):
    """Penalise the final density MLP's change (normals, predicted normals,
    density, each under its ``geometry_smoothness_weight_*``) between the
    output's final samples and a Gaussian jitter of them
    (``geometry_smoothness_noise``), L1, weighted by the samples'
    compositing weights. The jittered pass is the model's "geometry" pass
    at the detached, jittered samples; its outputs keep their graph (the
    density normals a second-order one)."""
    geometry = results.get("geometry")
    if geometry is None:
        return 0.0
    weights = {"normals": config.geometry_smoothness_weight_normals,
               "normals_pred": config.geometry_smoothness_weight_normals_pred,
               "density": config.geometry_smoothness_weight_density}
    geometry = _filter_tensors(geometry)
    means = geometry["means"]
    key, rng = torchutil.random_split(rng)
    noise = torchutil.normal(key, means.shape, means.device)
    inputs = {k: v.detach() for k, v in geometry.items()}
    inputs["means"] = (means + noise * config.geometry_smoothness_noise).detach()
    key, rng = torchutil.random_split(rng)
    perturbed = model(key, rays, train_frac=train_frac, train=True, compute_extras=False,
                      passes=("geometry",), sampler_results=inputs)
    perturbed = {k: torch.nan_to_num(v) for k, v in _filter_tensors(perturbed).items()}

    lossmult = rays.lossmult.reshape(-1, 1, 1)
    lossmult = (lossmult * torch.ones_like(means[..., :1].reshape(lossmult.shape[0], -1, 1))
                ).reshape(means[..., :1].shape) * (
        geometry["weights"][..., None] * geometry["weights"].shape[-1]).detach()
    loss = 0.0
    for k, w in weights.items():
        if k not in geometry or k not in perturbed:
            continue
        diff = torch.abs(geometry[k] - perturbed[k].reshape(geometry[k].shape))
        shape = geometry[k].shape if k == "density" else geometry[k].shape[:-1] + (1,)
        loss = loss + (diff * w * lossmult.reshape(shape)).mean()
    return loss


# --- emission and residual albedo ------------------------------------------------------


def _point_weights(results, like):
    """The detached surface weights [..., S, 1] of a results dict with a
    geometry level, else ones like `like`."""
    if results.get("geometry") is not None:
        return results["geometry"]["weights"].detach()[..., None]
    return torch.ones_like(like)


def emission_loss(model, rng, rays, config, batch, results, full_results, train_frac=1.0):
    """The emission's square root against the cache's rendered colour's
    (emission_zero_loss_mult) and its (zero) variate difference
    (emission_constant_loss_mult), summed over the samples."""
    shader = results["shader"]
    if "lighting_emission" not in shader:
        return 0.0
    emission = shader["lighting_emission"]
    cache_rgb = results["integrator"]["cache_rgb"]
    lossmult = rays.lossmult.reshape(emission.shape[:-2] + (-1, 1))
    zero_loss = (math.safe_sqrt(emission + 1e-5)
                 / math.safe_sqrt(cache_rgb.reshape(emission.shape[:-2] + (-1, 3)) + 1e-3)
                 ) * config.emission_zero_loss_mult * lossmult
    diff_loss = torch.square(emission - emission.detach()) * config.emission_constant_loss_mult \
        * lossmult
    weights = _point_weights(results, zero_loss)
    return (zero_loss * weights).sum(dim=-2).mean() + (diff_loss * weights).sum(dim=-2).mean()


def residual_albedo_loss(model, rng, rays, config, batch, results, full_results,
                         train_frac=1.0):
    """The residual albedo times the (detached) irradiance against the
    emission, debiased (and RawNeRF-scaled under a rawnerf data loss)."""
    shader = results["shader"]
    if "lighting_emission" not in shader or "material_residual_albedo" not in shader:
        return 0.0
    emission = shader["lighting_emission"]
    irradiance = shader["lighting_irradiance"]
    irradiance_nocorr = shader.get("lighting_irradiance_nocorr", irradiance)
    residual_albedo = shader["material_residual_albedo"]
    material_results = {"rgb": residual_albedo * irradiance.detach(),
                        "rgb_nocorr": residual_albedo * irradiance_nocorr.detach(),
                        "cache_rgb": emission.detach()}
    lossmult = rays.lossmult.reshape(emission.shape[:-2] + (-1, 1))
    gt = emission.detach()
    if "rawnerf" in config.data_loss_type:
        diff = losses_lib.compute_unbiased_loss_rawnerf(material_results, gt, config,
                                                        gt_nocorr=gt) * lossmult
    else:
        diff = losses_lib.compute_unbiased_loss(material_results, gt, gt) * lossmult
    return (diff * _point_weights(results, diff)).sum(dim=-2).mean()


# --- radiance bound and weight tether ---------------------------------------------------


def maximum_radiance_loss(model, rng, rays, config, batch, results, full_results,
                          train_frac=1.0):
    """The squared excess of each sample's shaded colour over its pixel's."""
    shader = results.get("shader") or {}
    if "rgb" not in shader or batch.rgb is None:
        return 0.0
    excess = torch.clamp(shader["rgb"] - batch.rgb[..., None, :3], min=0.0)
    return torch.square(excess).mean()


def normalize_weight_loss(model, rng, rays, config, batch, results, full_results,
                          train_frac=1.0):
    """The L1 tether of the weights before normalisation to their (detached)
    normalised value; 0 where the geometry carries neither, which no model
    emits (as in JAX)."""
    geometry = results.get("geometry") or {}
    if (config.normalize_weight_loss_weight == 0.0 or "weights_original" not in geometry
            or "weights_new" not in geometry):
        return 0.0
    diff = torch.abs(geometry["weights_original"] - geometry["weights_new"].detach())
    return diff.mean() * config.normalize_weight_loss_weight


# --- material / irradiance decorrelation -----------------------------------------------


def _center_normalize(x, lossmult):
    """x centred under lossmult, each column over its L1 norm plus the row
    count, times the row count."""
    n = x.shape[0]
    x = x * lossmult
    x = x - x.sum(dim=0, keepdim=True) / (lossmult.sum(dim=0, keepdim=True) + 1e-3)
    x = x * lossmult
    return x / (torch.abs(x).sum(dim=0, keepdim=True) + n) * n


def material_correlation_loss(model, rng, rays, config, batch, results, full_results,
                              train_frac=1.0):
    """At one surface point per ray (resampled by the weights): the absolute
    correlation of each material channel with the irradiance, the
    irradiance's debiased tether to the SLF variate's ``irradiance_cache``
    and its whitening; 0 without the SLF variate's output."""
    shader = results.get("shader") or {}
    if "lighting_irradiance" not in shader or "irradiance_cache" not in shader:
        return 0.0
    key, rng = torchutil.random_split(rng)
    shader_results, _ = model.maybe_resample(key, True, _filter_tensors(shader), 1)
    n_rays = rays.lossmult.reshape(-1, 1).shape[0]
    irradiance = shader_results["lighting_irradiance"].reshape(-1, 3)
    irradiance_nocorr = shader_results.get("lighting_irradiance_nocorr",
                                           shader_results["lighting_irradiance"]).reshape(-1, 3)
    irradiance_cache = shader_results["irradiance_cache"].reshape(-1, 3)
    weights = shader_results["weights"]
    lossmult = rays.lossmult.reshape(-1, 1, 1)
    lossmult = (lossmult * torch.ones_like(shader_results["lighting_irradiance"][..., :1].reshape(
        n_rays, -1, 1))).reshape(-1, 1)
    lossmult = lossmult * (weights.reshape(-1, 1) * weights.shape[-1]).detach()
    irradiance_target = _center_normalize(irradiance, lossmult).detach()

    material_weights = {
        "material_albedo": config.material_correlation_weight_albedo,
        "material_roughness": config.material_correlation_weight_other,
        "material_F_0": config.material_correlation_weight_other,
        "material_metalness": config.material_correlation_weight_other,
        "material_diffuseness": config.material_correlation_weight_other,
        "material_mirrorness": config.material_correlation_weight_other,
    }
    loss = 0.0
    for mat_key, mat_weight in material_weights.items():
        if mat_key not in shader_results:
            continue
        channel = _center_normalize(
            shader_results[mat_key].reshape(irradiance_target.shape[0], -1), lossmult)
        loss = loss + torch.abs((channel * irradiance_target).mean(dim=0)).sum() * mat_weight

    tether = {"rgb": stopgrad_with_weight(irradiance, config.irradiance_cache_stopgrad_weight),
              "rgb_nocorr": irradiance_nocorr, "cache_rgb": irradiance_cache}
    gt = stopgrad_with_weight(irradiance_cache, config.irradiance_cache_stopgrad_weight_backwards)
    if "rawnerf" in config.data_loss_type:
        diff = losses_lib.compute_unbiased_loss_rawnerf(tether, gt, config,
                                                        gt_nocorr=irradiance_cache) * lossmult
    else:
        diff = losses_lib.compute_unbiased_loss(tether, gt, irradiance_cache) * lossmult
    loss = loss + diff.mean() * config.irradiance_cache_loss_weight
    whitening = losses_lib.compute_unbiased_loss(
        {"rgb": irradiance, "rgb_nocorr": irradiance_nocorr},
        irradiance.mean(dim=-1, keepdim=True).detach(),
        irradiance_nocorr.mean(dim=-1, keepdim=True).detach())
    return loss + (whitening * lossmult).mean() * config.whitening_loss_weight


# --- extra rays ---------------------------------------------------------------------------


def extra_ray_loss(model, rng, rays, config, batch, results, full_results, train_frac=1.0):
    """The material render against the cache's along the rays with their
    view direction turned to one uniform hemisphere direction at their
    first sample's normal (origins and directions kept, as in JAX): one
    more model forward, and a debias forward over its cache samples whose
    values enter only under a stop-gradient (so it runs without a graph),
    in the debiased squared error (RawNeRF-scaled under a rawnerf data
    loss)."""
    normals = results["shader"].get(config.material_normals_target)
    if not isinstance(normals, torch.Tensor):
        return 0.0
    key, rng = torchutil.random_split(rng)
    extra_rays = render_utils.get_outgoing_rays(
        key, rays, rays.viewdirs.detach(), normals[..., :1, :].detach(), {},
        random_generator_2d=model.random_generator_2d, use_mis=False,
        samplers=model.uniform_importance_samplers, num_secondary_samples=1)
    kw = dict(train_frac=train_frac, train=True, compute_extras=False,
              secondary_proposal_grad=False)
    key, rng = torchutil.random_split(rng)
    extra = model(key, extra_rays, **kw)
    key, rng = torchutil.random_split(rng)
    with torch.no_grad():
        nocorr = model(key, extra_rays,
                       cache_outputs={"sampler": extra["cache_main"]["sampler"]},
                       filtered_sampler_inds=extra["cache_main"]["filtered_sampler_inds"], **kw)
    rgb_gt = stopgrad_with_weight(extra["render"]["cache_rgb"],
                                  config.extra_ray_loss_stopgrad_weight_gt)
    rgb_gt_nocorr = nocorr["render"]["cache_rgb"]
    rgb = stopgrad_with_weight(extra["render"]["rgb"].reshape(rgb_gt.shape),
                               config.extra_ray_loss_stopgrad_weight_pred)
    pred = {"rgb": rgb, "rgb_nocorr": nocorr["render"]["rgb"].reshape(rgb_gt.shape),
            "cache_rgb": rgb_gt}
    if "rawnerf" in config.data_loss_type:
        return losses_lib.compute_unbiased_loss_rawnerf(pred, rgb_gt, config,
                                                        gt_nocorr=rgb_gt_nocorr).mean()
    return losses_lib.compute_unbiased_loss(pred, rgb_gt, rgb_gt_nocorr).mean()


# --- dispatch ------------------------------------------------------------------------

EXTRA_LOSS_FUNCTIONS = {
    "emission": emission_loss,
    "residual_albedo": residual_albedo_loss,
    "light_sampling": light_sampling_loss,
    "material_surface_light_field": material_surface_light_field_loss,
    "material_smoothness": material_smoothness_loss,
    "geometry_smoothness": geometry_smoothness_loss,
    "material_ray_sampler": material_ray_sampler_loss,
    "material_correlation": material_correlation_loss,
    "maximum_radiance": maximum_radiance_loss,
    "normalize_weight": normalize_weight_loss,
    # The JAX dispatch's alias (both eased in by surface_light_field_weight_ease).
    "surface_light_field": material_surface_light_field_loss,
}
_SURFACE_LIGHT_FIELD_LOSSES = ("surface_light_field", "material_surface_light_field")


def reads_secondary_proposals(config):
    """Whether a loss of `config` reads the secondary rays' proposal levels:
    only the interlevel term of material_ray_sampler does."""
    return ("material_ray_sampler" in (config.extra_losses or {})
            and config.material_ray_sampler_interlevel_loss_mult != 0)


def compute_extra_losses(config, batch, rays, full_results, output_key, losses, train_frac,
                         model=None, rng=None):
    """Every configured extra loss of one output ('main' / 'cache_main'),
    added to `losses` under the output's prefix, in the dict order of
    ``Config.extra_losses`` (a name in no table is skipped, as the JAX
    dispatch skips it); then the losses turned on by their Config weight
    and not by name: the maximum radiance and the material correlation on
    'main', the weight tether on each output, and the extra rays on the
    material model's 'main'."""
    results = full_results.get(output_key)
    if results is None:
        return losses
    prefix = "" if output_key == "main" else output_key.replace("main", "")
    for name, spec in (config.extra_losses or {}).items():
        if output_key not in spec:
            continue
        if name not in EXTRA_LOSS_FUNCTIONS and name != CONSISTENCY:
            continue
        key, rng = torchutil.random_split(rng)
        mult = spec[output_key]["mult"]
        if name == CONSISTENCY:
            fn = (transient_direct_indirect_consistency_loss if config.use_transient
                  else direct_indirect_consistency_loss)
            mult = mult * consistency_weight_ease(config, train_frac)
            loss = fn(config, batch, rays, results)
        else:
            if name in _SURFACE_LIGHT_FIELD_LOSSES:
                mult = mult * surface_light_field_weight_ease(config, train_frac)
            loss = EXTRA_LOSS_FUNCTIONS[name](model, key, rays, config, batch, results,
                                              full_results, train_frac=train_frac)
        losses[prefix + name] = mult * loss

    names = set(config.extra_losses or {})
    args = (model, rng, rays, config, batch, results, full_results)
    if output_key == "main":
        if "maximum_radiance" not in names and config.maximum_radiance_loss_weight > 0.0:
            losses["maximum_radiance"] = config.maximum_radiance_loss_weight * \
                maximum_radiance_loss(*args, train_frac=train_frac)
        if ("material_correlation" not in names and config.is_material
                and (config.material_correlation_weight_albedo > 0.0
                     or config.material_correlation_weight_other > 0.0)):
            losses["material_correlation"] = material_correlation_loss(
                *args, train_frac=train_frac)
    if "normalize_weight" not in names and config.normalize_weight_loss_weight > 0.0:
        losses[prefix + "normalize_weight"] = normalize_weight_loss(*args, train_frac=train_frac)
    if output_key == "main" and config.extra_ray_loss_mult > 0.0 and config.is_material:
        losses["extra_ray"] = (config.extra_ray_loss_mult
                               * extra_ray_weight_ease(config, train_frac)
                               * extra_ray_loss(*args, train_frac=train_frac))
    return losses
