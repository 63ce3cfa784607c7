"""Optimizer, train step and eval render function (counterpart of
``parallel/train.py``).

One process, one device: the step runs eagerly on the model's device. The
optimizer is ``torch.optim.Adam``, which places eps exactly as the JAX
package's Adam does; every step sets the learning rate from ``learning_rate_decay``
evaluated at the step count before the update (the JAX optimizer's
schedule convention).

Losses cover every model output whose key ends in ``main`` (the material
model's ``cache_main`` and ``main``), each with the loss type and weight
its target carries. ``Config.use_gradient_debias`` runs the second,
independent forward of the gradient-debiased losses;
``Config.gradient_checkpointing`` is read by the density MLPs, which
recompute their activations in the backward (``models/geometry.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict

import torch

from neural_radiance_caching_tpu_torch.ops import math
from neural_radiance_caching_tpu_torch.parallel import losses as losses_lib


@dataclasses.dataclass
class TrainState:
    """Model, optimizer, learning-rate schedule and step count."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_fn: Callable[[int], float]
    step: int = 0


def create_optimizer(config, model):
    """Adam over every parameter with the `learning_rate_decay` schedule.

    Returns (TrainState, lr_fn). Per-module overrides (extra_opt_params) and
    gradient accumulation are not ported yet and raise.
    """
    if config.extra_opt_params or config.grad_accum_steps > 1 or config.is_material:
        raise NotImplementedError(
            "extra_opt_params, gradient accumulation and material schedules are not ported yet")
    lr_fn = functools.partial(
        math.learning_rate_decay, lr_init=config.lr_init, lr_final=config.lr_final,
        max_steps=config.max_steps, lr_delay_steps=config.lr_delay_steps,
        lr_delay_mult=config.lr_delay_mult)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr_fn(0),
                                 betas=(config.adam_beta1, config.adam_beta2), eps=config.adam_eps)
    return TrainState(model=model, optimizer=optimizer, lr_fn=lr_fn), lr_fn


def _compute_losses_for_output(batch, rays, model_results, config, train_frac, main_name,
                               losses, stats):
    """Losses over one 'main'-style results dict, under its own loss type,
    weight and sRGB flag; geometry losses only where it has a sampler."""
    results = model_results[main_name]
    rendering = model_results["render"] if main_name == "main" else results["integrator"]
    prefix = "" if main_name == "main" else main_name.replace("main", "")
    out_config, loss_weight = config, 1.0
    if "loss_type" in results:
        out_config = dataclasses.replace(
            config, data_loss_type=results["loss_type"],
            linear_to_srgb=results.get("linear_to_srgb", config.linear_to_srgb),
            is_material=(main_name == "main" and results.get("sampler") is None))
        loss_weight = results.get("loss_weight", 1.0)
    data_loss, data_stats = losses_lib.compute_data_loss(
        batch, rendering, rays, out_config, main=(main_name == "main"),
        transient=config.use_transient)
    losses[prefix + "data"] = config.data_loss_mult * loss_weight * data_loss
    for k, v in data_stats.items():
        stats[prefix + k] = v

    ray_history = results["sampler"]
    last = results["geometry"]
    if ray_history is None or last is None:
        return losses, stats
    if any(m > 0 for m in config.interlevel_loss_mults):
        interlevel = losses_lib.compute_interlevel_loss(
            ray_history, config.interlevel_loss_mults, config.interlevel_loss_blurs, config)
        for i, loss in enumerate(interlevel):
            losses[f"{prefix}interlevel_{i}"] = loss
    if config.distortion_loss_mult > 0:
        losses[prefix + "distortion"] = losses_lib.compute_distortion_loss(
            ray_history, config.distortion_loss_mult, config)

    decay = losses_lib.compute_weight_decay(
        train_frac, config.use_normal_weight_decay, config.normal_weight_decay_start,
        config.normal_weight_decay_frac, config.normal_weight_decay_min)
    decay_bwd = decay if config.use_normal_weight_decay_backward else 1.0
    ease = losses_lib.compute_weight_ease_in(
        train_frac, config.use_normal_weight_ease, config.normal_weight_ease_start,
        config.normal_weight_ease_frac, config.normal_weight_ease_min) * decay
    ease_bwd = losses_lib.compute_weight_ease_in(
        train_frac, config.use_normal_weight_ease_backward, config.normal_weight_ease_start,
        config.normal_weight_ease_frac, config.normal_weight_ease_min) * decay_bwd
    beta = torch.ones_like(last["weights"][..., None])
    if config.predicted_normal_loss_mult > 0:
        losses[prefix + "predicted_normals"] = losses_lib.predicted_normal_loss(
            last, beta, config, mult=config.predicted_normal_loss_mult * ease,
            gt="normals_pred", pred="normals", stopgrad=config.predicted_normal_loss_stopgrad,
            stopgrad_weight=config.predicted_normal_loss_stopgrad_weight)
    if config.predicted_normal_reverse_loss_mult > 0:
        losses[prefix + "predicted_normals_reverse"] = losses_lib.predicted_normal_loss(
            last, beta, config, mult=config.predicted_normal_reverse_loss_mult * ease_bwd,
            gt="normals", pred="normals_pred", stopgrad=True)
    return losses, stats


def _check_config(config):
    unported = {
        "cast_rays_in_train_step": config.cast_rays_in_train_step,
        "debug_mode": config.debug_mode,
        "orientation_loss_mult": config.orientation_loss_mult > 0,
        "eikonal_loss_mult": config.eikonal_loss_mult > 0 or config.eikonal_coarse_loss_mult > 0,
        "opaque/empty_loss_weight": config.opaque_loss_weight > 0 or config.empty_loss_weight > 0,
        "patch_loss_mult": config.patch_loss_mult > 0,
        "param_regularizers": bool(config.param_regularizers),
        "extra_losses": bool(config.extra_losses) or config.maximum_radiance_loss_weight > 0,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


def _debias_forward(model, rng, rays, train_frac, model_results):
    """The gradient-debias second forward: independent secondary-ray draws
    over the same cache sampler results; its rgb becomes `rgb_nocorr`.

    The data losses read `rgb_nocorr` only under a stop-gradient, and the
    losses that would read the pass's shader outputs (consistency, residual
    albedo) are extra losses, which _check_config refuses. So the pass runs
    without a graph: the torch counterpart of the dead-code elimination that
    drops its backward under XLA. That keeps its activations out of memory
    and its encoders out of the backward.
    """
    with torch.no_grad():
        nocorr = model(rng, rays, train_frac=train_frac, train=True, compute_extras=False,
                       cache_outputs={"sampler": model_results["cache_main"]["sampler"]},
                       filtered_sampler_inds=model_results["cache_main"]["filtered_sampler_inds"])
    model_results["render"]["rgb_nocorr"] = nocorr["render"]["rgb"]


def create_train_step(model, config):
    """Build the train step: (rng, state, batch, train_frac) -> (state, stats).

    rng is a torch.Generator on the model's device (or None for the
    deterministic sampler). `batch` must already be on that device. Stats are
    device tensors; nothing in the step waits for the device.
    """
    _check_config(config)

    def loss_fn(rng, batch, train_frac):
        rays = batch.rays
        model_results = model(rng, rays, train_frac=train_frac, train=True, compute_extras=False)
        if config.use_gradient_debias and "cache_main" in model_results:
            _debias_forward(model, rng, rays, train_frac, model_results)
        losses: Dict[str, Any] = {}
        stats: Dict[str, Any] = {}
        for key in sorted(k for k in model_results if k.endswith("main")):
            _compute_losses_for_output(batch, rays, model_results, config, train_frac, key,
                                       losses, stats)
        total = sum(losses.values())
        stats["losses"] = losses
        return total, stats

    def train_step(rng, state, batch, train_frac):
        state.optimizer.zero_grad(set_to_none=True)
        loss, stats = loss_fn(rng, batch, train_frac)
        loss.backward()
        params = [p for g in state.optimizer.param_groups for p in g["params"]]
        with torch.no_grad():
            for p in params:
                # Adam sees every parameter, as the JAX optimizer does: unused ones get
                # zero gradients rather than being skipped.
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                p.grad.nan_to_num_()
            losses_lib.clip_gradients(state.model, config)
            stats["grad_norm"] = losses_lib.tree_norm([p.grad for p in params])
            stats["param_norm"] = losses_lib.tree_norm([p.detach() for p in params])
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr_fn(state.step)
        state.optimizer.step()
        state.step += 1
        stats["loss"] = loss.detach()
        return state, stats

    return train_step


def create_render_fn(model, **apply_kwargs):
    """Eval-mode render function: (rng, train_frac, rays) -> the model's
    ``render`` outputs, with ``train=False`` and ``compute_extras`` (default
    True; False gives the rgb-centred outputs of a preview render).

    The module holds its own parameters, so unlike the JAX function's the
    render function takes no `variables` argument. It runs under
    ``torch.no_grad()``: no graph is built and no output requires grad (the
    JAX function's jit drops the graph by itself). Not under
    ``inference_mode``, whose tensors could not enter a later train step if a
    module kept one.
    """
    compute_extras = apply_kwargs.pop("compute_extras", True)

    def render_fn(rng, train_frac, rays):
        with torch.no_grad():
            return model(rng, rays, train_frac=train_frac, train=False,
                         compute_extras=compute_extras, **apply_kwargs)["render"]

    return render_fn
