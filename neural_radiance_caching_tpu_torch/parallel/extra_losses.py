"""Stage-dependent extra losses (counterpart of the part of
``parallel/extra_losses.py`` the material stages reach): the cache/material
consistency loss, steady and transient, with its weight ease-in.

``Config.extra_losses`` maps a loss name to {output key: {"mult", ...}}; the
staged trainer binds ``direct_indirect_consistency`` on ``main`` for every
material stage (``flagship.trainer_consistency_losses``). The consistency
losses read the material shader's outputs and their ``cache_*``
counterparts (the cache shader at the same surface points), and the
``_nocorr`` outputs of the gradient-debias forward only under a
stop-gradient, so that forward needs no graph (``parallel/train.py``).

Every other extra loss, and each loss the JAX package turns on by a Config
weight (maximum radiance, material correlation, weight normalisation, extra
rays), raises: they are ROADMAP queue 1 item 5.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from neural_radiance_caching_tpu_torch.parallel import losses as losses_lib
from neural_radiance_caching_tpu_torch.utils.torchutil import stopgrad_with_weight

CONSISTENCY = "direct_indirect_consistency"


def _weight_ease(train_frac, use, start, frac, min_val):
    if not use:
        return 1.0
    if frac > 0:
        w = float(np.clip(np.float32((train_frac - start) / frac), 0.0, 1.0))
        return min_val * (1.0 - w) + w
    return float(train_frac - start >= 0.0)


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


def unported(config):
    """The extra losses `config` turns on that are not ported."""
    names = [k for k in (config.extra_losses or {}) if k != CONSISTENCY]
    weights = {"maximum_radiance": config.maximum_radiance_loss_weight,
               "material_correlation": max(config.material_correlation_weight_albedo,
                                           config.material_correlation_weight_other),
               "normalize_weight": config.normalize_weight_loss_weight,
               "extra_ray": config.extra_ray_loss_mult}
    return names + [f"{k} (by its weight)" for k, w in weights.items() if w > 0]


def compute_extra_losses(config, batch, rays, full_results, output_key, losses, train_frac):
    """Every configured extra loss of one output ('main' / 'cache_main'),
    added to `losses` under the output's prefix. `create_train_step` has
    refused every loss but the consistency loss (`unported`)."""
    results = full_results.get(output_key)
    spec = (config.extra_losses or {}).get(CONSISTENCY, {})
    if results is None or output_key not in spec:
        return losses
    fn = (transient_direct_indirect_consistency_loss if config.use_transient
          else direct_indirect_consistency_loss)
    mult = spec[output_key]["mult"] * consistency_weight_ease(config, train_frac)
    prefix = "" if output_key == "main" else output_key.replace("main", "")
    losses[prefix + CONSISTENCY] = mult * fn(config, batch, rays, results)
    return losses
