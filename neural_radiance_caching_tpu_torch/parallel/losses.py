"""Losses of the cache, material and transient stages (counterpart of
``parallel/losses.py``): every data loss type of the JAX dispatch (the
squared error, its square-root form ``mse_fwp``, the Charbonnier and its
clipped form, the gradient-debiased squared error, RawNeRF and its
debiased, transient and Charbonnier forms under the rendering's, the
target's (``use_gt_rawnerf``), their maximum's (``use_combined_rawnerf``)
or their norm's (``use_norm_rawnerf``) scaling, the transient ones with the
Gaussian pyramid of ``render_utils.dtof_to_gauss`` under
``Config.transient_gauss_sigma_scales``, and the iToF types, the residual
projected by ``render_utils.dtof_to_itof``), the spline and the original
interlevel losses, distortion, the predicted-normal regularizers, the
eikonal loss, the opaque/empty mask loss, the parameter regularizers and
gradient clipping. A rendering may carry ``gt_nocorr``, the target of the
debiased second estimate (the consistency loss's nocorr cache target)."""

from __future__ import annotations

import collections

import numpy as np
import torch

from neural_radiance_caching_tpu_torch.ops import image, render_utils, stepfun
from neural_radiance_caching_tpu_torch.utils import torchutil, weights


def compute_weight_ease_in(train_frac, use_weight_schedule, start_frac, transition_frac,
                           min_value=0.0):
    """Linearly ease a weight in from min_value to 1 over training."""
    if not use_weight_schedule:
        return 1.0
    if transition_frac > 0:
        w = float(np.clip((train_frac - start_frac) / transition_frac, 0.0, 1.0))
        return min_value * (1.0 - w) + w
    return float(train_frac >= start_frac)


def compute_weight_decay(train_frac, use_weight_schedule, start_frac, transition_frac,
                         min_value=0.0):
    if not use_weight_schedule:
        return 1.0
    w = float(np.clip((train_frac - start_frac) / transition_frac, 0.0, 1.0))
    return min_value * w + (1.0 - w)


def compute_loss_charb(rendering, gt, config):
    return torch.sqrt((rendering["rgb"] - gt) ** 2 + config.charb_padding**2)


def _rgb_clip_for_rawnerf(rendering, gt, config, clip_val):
    """The clipped colour that scales a RawNeRF loss: the target's
    (``use_gt_rawnerf``), or the rendering's (the material model's rendering
    carries the cache's rgb, which scales its loss), or the larger of the
    two (``use_combined_rawnerf``); its norm over the channels with
    ``use_norm_rawnerf``."""
    if config.use_gt_rawnerf:
        rgb_clip = torch.clamp(gt, 0.0, clip_val)
    else:
        key = "cache_rgb" if "cache_rgb" in rendering else "rgb"
        rgb_clip = torch.clamp(rendering[key], 0.0, clip_val)
        if config.use_combined_rawnerf:
            rgb_clip = torch.clamp(torch.maximum(rgb_clip, gt), 0.0, clip_val)
    if config.use_norm_rawnerf:
        rgb_clip = torch.linalg.norm(rgb_clip, dim=-1, keepdim=True)
    return rgb_clip


def _rawnerf_scaling(rendering, gt, config, clip_val, exponent, eps, transient=False):
    """1 / (sg(the clipped colour)^exponent + eps); a transient rendering
    [..., bins, C] is summed over its bins first."""
    rgb_clip = _rgb_clip_for_rawnerf(rendering, gt, config, clip_val)
    if transient:
        rgb_clip = rgb_clip.sum(-2)[..., None, :]
    return 1.0 / (torch.pow(rgb_clip.detach(), exponent) + eps)


def compute_unbiased_loss(rendering, gt, gt_nocorr):
    """Gradient-debiased squared error: 2 (x - gt) sg(x' - gt'), with x' from
    an independent second forward and gt' its target."""
    diff = rendering["rgb"] - gt
    diff_nocorr = rendering["rgb_nocorr"] - gt_nocorr
    return 2 * diff * diff_nocorr.detach()


def _itof(x, config):
    return render_utils.dtof_to_itof(x, config.itof_frequency_phase_shifts, config.exposure_time)


def compute_unbiased_loss_itof(rendering, gt, gt_nocorr, config):
    """The debiased squared error of the iToF projections of the residuals."""
    diff = _itof(rendering["rgb"] - gt, config)
    diff_nocorr = _itof(rendering["rgb_nocorr"] - gt_nocorr, config)
    return 2 * diff * diff_nocorr.detach()


def compute_unbiased_loss_transient_gauss(rendering, gt, gt_nocorr, config):
    """The debiased squared error of the Gaussian pyramids of the residuals."""
    def gauss(x):
        return render_utils.dtof_to_gauss(x, config.transient_gauss_sigma_scales,
                                          config.transient_gauss_constant_scale)

    diff = gauss(rendering["rgb"] - gt)
    diff_nocorr = gauss(rendering["rgb_nocorr"] - gt_nocorr)
    return 2 * diff * diff_nocorr.detach()


def compute_loss_rawnerf(rendering, gt, config, clip_val=10000.0, exponent=1.0, eps=1e-3,
                         transient=False):
    scale = _rawnerf_scaling(rendering, gt, config, clip_val, exponent, eps, transient)
    return ((rendering["rgb"] - gt) ** 2) * scale


def compute_unbiased_loss_rawnerf(rendering, gt, config, clip_val=10000.0, exponent=1.0,
                                  eps=1e-3, transient=False, gt_nocorr=None):
    scale = _rawnerf_scaling(rendering, gt, config, clip_val, exponent, eps, transient)
    return compute_unbiased_loss(rendering, gt, gt if gt_nocorr is None else gt_nocorr) * scale


def _with_gauss(loss, gauss_loss, rendering, gt, config, rawnerf_eps, rawnerf_exponent):
    """A transient RawNeRF loss plus its Gaussian-pyramid term: scaled as the
    loss is, times data_loss_gauss_mult over the bin count, summed over the
    pyramid's rows and added to every bin."""
    scale = _rawnerf_scaling(rendering, gt, config, 10000.0, rawnerf_exponent, rawnerf_eps, True)
    gauss = gauss_loss * scale * config.data_loss_gauss_mult / loss.shape[-2]
    return loss + gauss.sum(dim=-2, keepdim=True)


def select_data_loss_fn(config, rendering, gt, gt_nocorr, rawnerf_eps, rawnerf_exponent,
                        transient=False):
    """Dispatch on config.data_loss_type, as the JAX package's. The iToF
    types give [..., 2 P + 1, C] for P (frequency, phase) pairs; the
    transient rawnerf ones scale by the rendering summed over its bins,
    whatever `transient` says, and add the Gaussian pyramid's term when
    `transient` and ``Config.transient_gauss_sigma_scales``."""
    t = config.data_loss_type
    if t == "mse":
        return (rendering["rgb"] - gt) ** 2
    if t == "mse_unbiased":
        return compute_unbiased_loss(rendering, gt, gt_nocorr)
    if t == "mse_itof":
        return _itof(rendering["rgb"] - gt, config) ** 2
    if t == "mse_itof_unbiased":
        return compute_unbiased_loss_itof(rendering, gt, gt_nocorr, config)
    if t == "mse_fwp":
        return ((rendering["rgb"] + 1e-5) ** 0.5 - (gt + 1e-5) ** 0.5) ** 2
    if t == "rawnerf":
        return compute_loss_rawnerf(rendering, gt, config, eps=rawnerf_eps,
                                    exponent=rawnerf_exponent)
    if t == "rawnerf_unbiased":
        return compute_unbiased_loss_rawnerf(
            rendering, gt, config, eps=rawnerf_eps, exponent=rawnerf_exponent,
            gt_nocorr=gt_nocorr)
    if t == "rawnerf_transient":
        loss = compute_loss_rawnerf(rendering, gt, config, eps=rawnerf_eps,
                                    exponent=rawnerf_exponent, transient=transient)
        if transient and config.transient_gauss_sigma_scales:
            gauss = render_utils.dtof_to_gauss(rendering["rgb"] - gt,
                                               config.transient_gauss_sigma_scales,
                                               config.transient_gauss_constant_scale) ** 2
            loss = _with_gauss(loss, gauss, rendering, gt, config, rawnerf_eps, rawnerf_exponent)
        return loss
    if t == "rawnerf_transient_unbiased":
        loss = compute_unbiased_loss_rawnerf(
            rendering, gt, config, eps=rawnerf_eps, exponent=rawnerf_exponent,
            transient=transient, gt_nocorr=gt_nocorr)
        if transient and config.transient_gauss_sigma_scales:
            gauss = compute_unbiased_loss_transient_gauss(rendering, gt, gt_nocorr, config)
            loss = _with_gauss(loss, gauss, rendering, gt, config, rawnerf_eps, rawnerf_exponent)
        return loss
    if t in ("rawnerf_transient_itof", "rawnerf_transient_itof_unbiased"):
        scale = _rawnerf_scaling(rendering, gt, config, 10000.0, rawnerf_exponent, rawnerf_eps,
                                 True)
        if t == "rawnerf_transient_itof":
            return _itof(rendering["rgb"] - gt, config) ** 2 * scale
        return compute_unbiased_loss_itof(rendering, gt, gt_nocorr, config) * scale
    if t == "rawnerf_charb":
        loss = compute_loss_rawnerf(rendering, gt, config, exponent=2.0, eps=rawnerf_eps) ** 2
        return torch.sqrt(loss + config.charb_padding**2)
    if t == "charb":
        return compute_loss_charb(rendering, gt, config)
    if t == "charb_clip":
        resid_sq = (torch.clamp(rendering["rgb"], max=1.0) - torch.clamp(gt, max=1.0)) ** 2
        return torch.sqrt(resid_sq + config.charb_padding**2)
    raise ValueError(f"Unknown data loss type: {t}")


def compute_data_loss(batch, rendering, rays, config, main=False, transient=False):
    """RGB data loss + stats. A transient target [B, bins, C] gets one loss
    weight per (ray, bin), and a ray whose peak exceeds `loss_thresh` is
    dropped whole."""
    stats = collections.defaultdict(list)
    # The per-ray lossmult broadcasts over the target, bin axis included.
    lm = rays.lossmult
    while lm.dim() < batch.rgb[..., :3].dim():
        lm = lm[..., None, :]
    lossmult = torch.broadcast_to(lm, batch.rgb[..., :3].shape)

    rendering = dict(rendering)
    gt = batch.rgb if transient else batch.rgb[..., :3]
    if config.convert_srgb:
        rendering["rgb"] = image.linear_to_srgb(rendering["rgb"])
        gt = image.linear_to_srgb(gt)

    if batch.masks is not None:
        masks = batch.masks
        while masks.dim() < lossmult.dim():
            masks = masks[..., None, :]
    else:
        masks = torch.ones_like(lossmult)
    unbiased = "unbiased" in config.data_loss_type
    if config.mask_lossmult or unbiased:
        lossmult = lossmult * masks
        if not unbiased:
            lossmult = lossmult + lossmult * (1.0 - masks) * config.mask_lossmult_weight
    if transient:
        lossmult = lossmult[..., :1]

    if main and config.use_loss_clip and not unbiased:
        clip = lambda x: torch.clamp(x, config.loss_clip_min, config.loss_clip)
        for k in ("rgb", "rgb_nocorr", "gt_nocorr"):
            if k in rendering:
                rendering[k] = clip(rendering[k])
        gt = clip(gt)

    if transient:
        peak = gt.amax(dim=(-2, -1), keepdim=True)
        lossmult = torch.where(peak > config.loss_thresh, torch.zeros_like(lossmult), lossmult)
    else:
        lossmult = torch.where(gt[..., :1] > config.loss_thresh, torch.zeros_like(lossmult),
                               lossmult)
    if config.clip_eval:
        resid_sq = (torch.clamp(rendering["rgb"], 0.0, 1.0) - torch.clamp(gt, 0.0, 1.0)) ** 2
    else:
        resid_sq = (rendering["rgb"] - gt) ** 2
    mse = ((masks[..., :1] if transient else masks) * lossmult * resid_sq).mean()

    # Without a debias forward the second estimate is the first, and so is
    # its target.
    rendering.setdefault("rgb_nocorr", rendering["rgb"])
    gt_nocorr = rendering.get("gt_nocorr", gt)
    if config.is_material:
        exponent, eps = config.rawnerf_exponent_material, config.rawnerf_eps_material
    else:
        exponent, eps = config.rawnerf_exponent, config.rawnerf_eps
    data_loss = select_data_loss_fn(config, rendering, gt, gt_nocorr, eps, exponent,
                                    transient=transient)
    try:
        torch.broadcast_shapes(lossmult.shape, data_loss.shape)
    except RuntimeError:
        # The iToF projection of P (frequency, phase) pairs has 2 P + 1 rows
        # where the loss weights have one per bin.
        raise NotImplementedError(
            f"data loss {config.data_loss_type!r} of shape {tuple(data_loss.shape)} against "
            f"loss weights of shape {tuple(lossmult.shape)}: the JAX package's "
            "compute_data_loss raises there too (TypeError: mul got incompatible shapes for "
            "broadcasting, parallel/losses.py:293); the frequency-iToF configs run only "
            "where 2 x their pairs + 1 equals Config.n_bins") from None
    if "bg_noise" in rendering and not transient:
        # A random background's share of the render, which it must not keep.
        data_loss = data_loss + (rendering["bg_noise"] ** 2) * masks
    sub_loss = (lossmult * data_loss).mean()
    stats["mses"].append(mse * config.data_loss_mult)
    return sub_loss, {k: torch.stack(v) for k, v in stats.items()}


def patch_loss(batch, rendering, config):
    """Bilateral depth smoothness over the batch's patches of
    ``Config.patch_size``^2 contiguous rays: the Charbonnier of every pair's
    rendered-depth difference within a patch, weighted down across colour
    edges of the ground truth (the bilateral term) and in patches of high
    colour variance."""
    p = max(config.patch_size, 1)
    rgb_gt = batch.rgb[..., :3].reshape(-1, p * p, 3)
    depth = rendering["distance_mean"].reshape(-1, p * p)
    pair_loss = torch.sqrt((depth[..., :, None] - depth[..., None, :]) ** 2
                           + config.charb_padding**2)
    rgb_resid_sq = torch.sum((rgb_gt[..., :, None, :] - rgb_gt[..., None, :, :]) ** 2, dim=-1)
    bilateral = torch.exp(-config.bilateral_strength * rgb_resid_sq)
    patch_mean = torch.mean(rgb_gt, dim=-2, keepdim=True)
    patch_var = torch.mean(torch.square(rgb_gt - patch_mean), dim=(-2, -1))
    weight = torch.exp(-(config.patch_variance_weighting**2) * patch_var)
    weight = weight[..., None, None] * bilateral
    return config.patch_loss_mult * torch.mean(pair_loss * weight)


def compute_mask_loss(batch, rendering, rays, config, train_frac=1.0, empty_loss_weight=None):
    """Opaque/empty acc supervision: a Charbonnier of acc against the mask,
    weighted by opaque_loss_weight inside the mask and empty_loss_weight
    outside (or by `empty_loss_weight` outside only)."""
    lossmult = rays.lossmult
    masks = batch.masks if batch.masks is not None else torch.ones_like(lossmult)
    if rendering.get("acc") is None:
        return torch.zeros((), device=lossmult.device)
    decay = compute_weight_decay(
        train_frac, config.use_mask_weight_decay, config.mask_weight_decay_start,
        config.mask_weight_decay_frac, config.mask_weight_decay_min)
    ease = compute_weight_ease_in(
        train_frac, config.use_mask_weight_ease, config.mask_weight_ease_start,
        config.mask_weight_ease_frac, config.mask_weight_ease_min)
    data_loss = torch.sqrt((rendering["acc"][..., None] - masks) ** 2
                           + config.charb_padding**2) * decay * ease
    zero = torch.zeros_like(data_loss)
    if empty_loss_weight is not None:
        data_loss = torch.where(masks > 0.5, zero, data_loss * empty_loss_weight)
    else:
        data_loss = torch.where(masks > 0.5, data_loss * config.opaque_loss_weight,
                                data_loss * config.empty_loss_weight)
    return torch.mean(lossmult * data_loss)


def spline_interlevel_loss(ray_history, *, mults, blurs, eps=1e-5):
    """Blurred-envelope proposal loss."""
    num_rounds = len(ray_history) - 1
    if not isinstance(mults, tuple):
        mults = (mults,) * num_rounds
    c = ray_history[-1]["sdist"]
    w = ray_history[-1]["weights"] * ray_history[-1]["lossmult"]
    losses = []
    for mult, blur, ray_results in zip(mults, blurs, ray_history[:-1]):
        cp = ray_results["sdist"]
        wp = ray_results["weights"] * ray_results["lossmult"]
        w_blur = stepfun.blur_and_resample_weights(cp, c, w, blur).detach()
        losses.append(mult * torch.mean(torch.clamp(w_blur - wp, min=0) ** 2 / (wp + eps)))
    return losses


def interlevel_loss(ray_history, *, mults):
    """The original proposal loss of mip-NeRF 360: each proposal level's
    weights against the outer measure of the final level's (detached)."""
    num_rounds = len(ray_history) - 1
    if not isinstance(mults, tuple):
        mults = (mults,) * num_rounds
    c = ray_history[-1]["sdist"].detach()
    w = (ray_history[-1]["weights"] * ray_history[-1]["lossmult"]).detach()
    losses = []
    for mult, ray_results in zip(mults, ray_history[:-1]):
        cp = ray_results["sdist"]
        wp = ray_results["weights"] * ray_results["lossmult"]
        losses.append(mult * torch.mean(stepfun.lossfun_outer(c, w, cp, wp)))
    return losses


def compute_interlevel_loss(ray_history, loss_mults, loss_blurs, config):
    if config.use_spline_interlevel_loss:
        return spline_interlevel_loss(ray_history, mults=tuple(loss_mults), blurs=loss_blurs)
    return interlevel_loss(ray_history, mults=tuple(loss_mults))


def distortion_loss(ray_history, *, target="sdist", mult=1.0, curve_fn=lambda x: x,
                    normalize=False):
    last = ray_history[-1]
    c = curve_fn(last[target])
    w = last["weights"] * last["lossmult"]
    return mult * torch.mean(stepfun.lossfun_distortion(c, w, normalize))


def compute_distortion_loss(ray_history, distortion_loss_mult, config):
    if config.distortion_loss_curve_fn is None:
        curve_fn = lambda x: x
    else:
        fn, kwargs = config.distortion_loss_curve_fn
        curve_fn = lambda x: fn(x, **kwargs)
    return distortion_loss(ray_history, target=config.distortion_loss_target,
                           mult=distortion_loss_mult, curve_fn=curve_fn,
                           normalize=config.normalize_distortion_loss)


def orientation_loss(rays, ray_results, config):
    """Ref-NeRF orientation regularizer: weighted squared back-facing part of
    the `orientation_loss_target` normals (0.0 when they are absent)."""
    n = ray_results.get(config.orientation_loss_target)
    if n is None:
        return 0.0
    w = ray_results["weights"] * ray_results["lossmult"]
    if config.orientation_loss_normalize:
        w = w / torch.sum(w, dim=-1, keepdim=True)
    if config.orientation_loss_stopgrad:
        w = w.detach()
    n = torch.nan_to_num(n)
    n_dot_v = (n * -rays.viewdirs[..., None, :]).sum(dim=-1)
    loss = torch.mean(torch.abs(
        torch.abs(w * torch.clamp(n_dot_v, max=0.0) ** 2).sum(dim=-1) + 1e-5))
    return loss * config.orientation_loss_mult


def predicted_normal_loss(ray_results, beta, config, *, mult, gt="normals",
                          pred="normals_pred", stopgrad=False, stopgrad_weight=1.0):
    """Ref-NeRF predicted normal supervision (0.0 when either normal is absent)."""
    if ray_results.get(gt) is None or ray_results.get(pred) is None:
        return 0.0
    w = ray_results["weights"] * ray_results["lossmult"]
    if config.predicted_normal_loss_normalize:
        w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-8)
    w = w.detach() if stopgrad else torchutil.stopgrad_with_weight(w, stopgrad_weight)
    n = torch.nan_to_num(ray_results[gt]).detach()
    n_pred = torch.nan_to_num(ray_results[pred])
    loss = torch.mean(torch.abs(
        (torch.abs(w * (1.0 - torch.sum(n * n_pred, dim=-1))) * beta[..., 0]).sum(
            dim=-1, keepdim=True) + 1e-5))
    return loss * mult


def eikonal_loss(ray_history, config):
    """The eikonal term on every level's gradient normals: the mean of
    (|n| - 1)^2, weighted by eikonal_coarse_loss_mult on the proposal
    levels and eikonal_loss_mult on the final one."""
    total = 0.0
    tiny = float(np.finfo(np.float32).tiny)
    for i, ray_results in enumerate(ray_history):
        n = ray_results.get("normals")
        if n is None:
            raise ValueError("Gradient normals cannot be None if eikonal loss is on.")
        norm = torch.sqrt(torch.clamp(torch.sum(n**2, dim=-1), min=tiny))
        loss = torch.mean((norm - 1.0) ** 2.0)
        mult = (config.eikonal_coarse_loss_mult if i < len(ray_history) - 1
                else config.eikonal_loss_mult)
        total = total + mult * loss
    return total


def param_regularizer_loss(model, config, material):
    """Parameter-norm regularizers (``Config.param_regularizers``: {name:
    (mult, agg_fn, alpha, scale)}): mult * the sum, over the parameters
    whose JAX path has `name` in the str of one of its keys, of
    agg_fn(|p * scale| ** alpha). The JAX path of a state_dict key is
    ``utils/weights.jax_path``'s under 'params', each key written as JAX
    prints a path key (``['name']``); `material` says whether `model` is a
    material model. A name that matches no parameter adds no term, as in
    JAX."""
    params = [(["['params']"] + [f"['{c}']" for c in weights.jax_path(key, material)], p)
              for key, p in model.named_parameters()]
    losses = {}
    for name, (mult, agg_fn, alpha, scale) in (config.param_regularizers or {}).items():
        terms = [agg_fn(torch.abs(p * scale) ** alpha) for path, p in params
                 if any(name in c for c in path)]
        if terms:
            losses[name] = mult * sum(terms)
    return losses


def tree_norm(tensors):
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in tensors))


def clip_gradients(model, config):
    """Per-top-level-module value/norm clipping of the .grad tensors, in place."""
    if config.grad_max_val <= 0 and config.grad_max_norm <= 0:
        return
    for _, module in model.named_children():
        grads = [p.grad for p in module.parameters() if p.grad is not None]
        if not grads:
            continue
        if config.grad_max_val > 0:
            for g in grads:
                g.clamp_(-config.grad_max_val, config.grad_max_val)
        if config.grad_max_norm > 0:
            mult = torch.clamp(
                config.grad_max_norm / (float(np.finfo(np.float32).eps) + tree_norm(grads)), max=1)
            for g in grads:
                g.mul_(mult)
