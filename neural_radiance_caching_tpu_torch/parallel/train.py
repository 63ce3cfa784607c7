"""Optimizer, train step and eval render function (counterpart of
``parallel/train.py``).

One process, one device: the step runs eagerly on the model's device. In
a data-parallel group (``parallel/mesh.py``) each rank runs the step on its
block of the global batch: every random draw is taken at the global batch's
shape and the rank keeps its block (``utils/torchutil.ray_shard``), and
every gradient is averaged over the ranks (``mesh.allreduce_gradients``, a
parameter's missing gradient first made zeros) before ``nan_to_num``, the
clipping and the norms, so that each of them sees the global gradient, as
in JAX's step over its mesh. A world of one runs the step as it is. The
optimizer is ``torch.optim.Adam``, which places eps exactly as the JAX
package's Adam does. ``Config.extra_opt_params`` gives a module its own
schedule and Adam settings: one parameter group per entry, holding the
parameters whose JAX path (``utils/weights.jax_path``) has the entry's name
as a component, the last matching entry winning (the JAX optimizer chains
one masked Adam per entry, in dict order); the rest form the main group.
Every step sets each group's learning rate from its own
``learning_rate_decay`` evaluated at the step count before the update (the
JAX optimizer's schedule convention).

With ``Config.cast_rays_in_train_step`` a batch holds Pixels, which the
step casts on the device against the dataset's cameras before the forward.
Losses cover every model output whose key ends in ``main`` (the material
model's ``cache_main`` and ``main``), each with the loss type and weight
its target carries, then that output's extra losses
(``parallel/extra_losses.py``), then the parameter regularizers
(``regularizer_<name>``). ``Config.use_gradient_debias`` runs the
second, independent forward of the gradient-debiased losses;
``Config.gradient_checkpointing`` is read by the density MLPs, which
recompute their activations in the backward (``models/geometry.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, List

import torch

from neural_radiance_caching_tpu_torch.data import camera_utils
from neural_radiance_caching_tpu_torch.ops import math
from neural_radiance_caching_tpu_torch.parallel import extra_losses as extra_losses_lib
from neural_radiance_caching_tpu_torch.parallel import losses as losses_lib
from neural_radiance_caching_tpu_torch.parallel import mesh as mesh_lib
from neural_radiance_caching_tpu_torch.utils import pytrees, torchutil, weights


@dataclasses.dataclass
class TrainState:
    """Model, optimizer, the main learning-rate schedule, one schedule per
    parameter group (in the optimizer's order) and the step count."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_fn: Callable[[int], float]
    group_lr_fns: List[Callable[[int], float]] = dataclasses.field(default_factory=list)
    step: int = 0


def is_material_model(model):
    from neural_radiance_caching_tpu_torch.models import material_model

    return isinstance(model, material_model.BaseMaterialModel)


def param_group_names(config, model):
    """{state_dict key: the extra_opt_params entry whose schedule it takes,
    or None for the main schedule}."""
    material = is_material_model(model)
    names = {}
    for key, _ in model.named_parameters():
        path = weights.jax_path(key, material)
        names[key] = None
        for prefix in config.extra_opt_params or {}:
            if prefix in path:
                names[key] = prefix
    return names


def create_optimizer(config, model):
    """Adam with the `learning_rate_decay` schedule, and a group of its own
    for each ``extra_opt_params`` entry that holds parameters.

    Returns (TrainState, lr_fn of the main schedule). ``is_material`` picks
    the entries' ``*_material`` values. Gradient accumulation is not ported
    yet and raises.
    """
    if config.grad_accum_steps > 1:
        raise NotImplementedError("gradient accumulation is not ported yet")
    suffix = "_material" if config.is_material else ""

    def lr_fn_of(opt_params):
        def get(name, default):
            return opt_params.get(name + suffix, opt_params.get(name, default))

        return functools.partial(
            math.learning_rate_decay, lr_init=get("lr_init", config.lr_init),
            lr_final=get("lr_final", config.lr_final),
            max_steps=get("max_steps", config.max_steps),
            lr_delay_steps=get("lr_delay_steps", config.lr_delay_steps),
            lr_delay_mult=get("lr_delay_mult", config.lr_delay_mult)), dict(
            betas=(get("adam_b1", config.adam_beta1), get("adam_b2", config.adam_beta2)),
            eps=get("adam_eps", config.adam_eps))

    lr_fn, adam_main = lr_fn_of({})
    names = param_group_names(config, model)
    groups, lr_fns = [], []
    for name in [None] + list(config.extra_opt_params or {}):
        params = [p for key, p in model.named_parameters() if names[key] == name]
        if not params:
            continue
        fn, adam = (lr_fn, adam_main) if name is None else lr_fn_of(config.extra_opt_params[name])
        groups.append(dict(params=params, lr=fn(0), name=name, **adam))
        lr_fns.append(fn)
    optimizer = torch.optim.Adam(groups, lr=lr_fn(0), **adam_main)
    return TrainState(model=model, optimizer=optimizer, lr_fn=lr_fn, group_lr_fns=lr_fns), lr_fn


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
    # Depth smoothness over the batch's pixel patches (``Config.patch_size``).
    if config.patch_loss_mult > 0 and config.patch_size > 1 and \
            rendering.get("distance_mean") is not None and batch.rgb is not None:
        losses[prefix + "patch"] = losses_lib.patch_loss(batch, rendering, out_config)

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

    # The late-training ramp-down shared by the orientation and
    # predicted-normal losses.
    decay = losses_lib.compute_weight_decay(
        train_frac, config.use_normal_weight_decay, config.normal_weight_decay_start,
        config.normal_weight_decay_frac, config.normal_weight_decay_min)
    decay_bwd = decay if config.use_normal_weight_decay_backward else 1.0
    if config.orientation_loss_mult > 0:
        losses[prefix + "orientation"] = losses_lib.orientation_loss(rays, last, config) * decay
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
    if (config.opaque_loss_weight > 0 or config.empty_loss_weight > 0) and \
            batch.masks is not None:
        losses[prefix + "mask"] = losses_lib.compute_mask_loss(
            batch, rendering, rays, config, train_frac=train_frac)
    return losses, stats


def _check_config(config):
    unported = {
        "debug_mode": config.debug_mode,
        "eikonal_loss_mult": config.eikonal_loss_mult > 0 or config.eikonal_coarse_loss_mult > 0,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")
    bad = extra_losses_lib.unported(config)
    if bad:
        raise NotImplementedError(f"extra losses not ported yet (the model and loss options "
                                  f"no runnable config reaches): {', '.join(bad)}")


# Shader outputs of the debias forward grafted as `<key>_nocorr` onto the
# `main` and `cache_main` shader results, for the consistency losses.
_NOCORR_SHADER_KEYS = ("diffuse_rgb", "specular_rgb", "direct_rgb", "indirect_rgb",
                       "transient_indirect", "lighting_irradiance", "cache_diffuse_rgb",
                       "cache_specular_rgb", "cache_direct_rgb", "cache_indirect_rgb",
                       "cache_transient_indirect")


def _debias_forward(model, rng, rays, train_frac, model_results):
    """The gradient-debias second forward: independent secondary-ray draws
    over the same cache sampler results; its rgb becomes `rgb_nocorr`, and
    its shader outputs the `_nocorr` keys of the shader results.

    Every loss reads the `_nocorr` values only under a stop-gradient (the
    data losses' `rgb_nocorr`, the consistency losses' material and cache
    estimates). So the pass runs without a graph: the torch counterpart of
    the dead-code elimination that drops its backward under XLA. That keeps
    its activations out of memory and its encoders out of the backward.
    """
    with torch.no_grad():
        nocorr = model(rng, rays, train_frac=train_frac, train=True, compute_extras=False,
                       cache_outputs={"sampler": model_results["cache_main"]["sampler"]},
                       filtered_sampler_inds=model_results["cache_main"]["filtered_sampler_inds"])
    model_results["render"]["rgb_nocorr"] = nocorr["render"]["rgb"]
    for out_key in ("main", "cache_main"):
        shader = model_results.get(out_key, {}).get("shader")
        nocorr_shader = nocorr.get(out_key, {}).get("shader")
        if shader is None or nocorr_shader is None:
            continue
        for k in _NOCORR_SHADER_KEYS:
            if k in nocorr_shader:
                shader[k + "_nocorr"] = nocorr_shader[k]


def _ray_caster(config, dataset, model):
    """rays(rng, rays) of the train step: a Pixels batch cast against the
    dataset's cameras (their lens distortion and NDC warp too) and lights,
    held on the model's device (the JAX step's jnp casting, with
    ``Config.jitter_rays``); a Rays batch as it is."""
    cast = None
    if config.cast_rays_in_train_step and dataset is not None:
        device = next(model.parameters()).device
        cameras = camera_utils.cameras_to(dataset.cameras, device)
        lights, impulse, virtual = camera_utils.cameras_to(
            (dataset.lights, dataset.impulse_response, dataset.virtual_camtoworlds), device)
        cast = functools.partial(camera_utils.cast_ray_batch, cameras, lights,
                                 jitter=config.jitter_rays, impulse_response=impulse,
                                 virtual_camtoworlds=virtual)

    def maybe_cast_rays(rng, rays):
        if not isinstance(rays, pytrees.Pixels):
            return rays
        if cast is None:
            raise ValueError("Batch contains Pixels but the train step has no cameras; pass "
                             "dataset= to create_train_step or disable "
                             "Config.cast_rays_in_train_step.")
        return cast(rays, rng=rng)

    return maybe_cast_rays


def create_train_step(model, config, dataset=None):
    """Build the train step: (rng, state, batch, train_frac) -> (state, stats).

    rng is a torch.Generator on the model's device (or None for the
    deterministic sampler). `batch` must already be on that device; a batch
    of Pixels (``Config.cast_rays_in_train_step``) is cast against
    `dataset`'s cameras, drawing its jitter first. Stats are device tensors;
    nothing in the step waits for the device. In a group of N ranks, `batch`
    is this rank's block of the global batch (``mesh.shard_batch``) and
    `rng` is seeded alike on every rank; the stats are the rank's own.
    """
    _check_config(config)
    material = is_material_model(model)
    # A material model's secondary proposal levels keep a graph only where a
    # loss reads them.
    forward_kwargs = dict(secondary_proposal_grad=extra_losses_lib.reads_secondary_proposals(
        config)) if material else {}
    maybe_cast_rays = _ray_caster(config, dataset, model)

    def loss_fn(rng, batch, train_frac):
        rays = maybe_cast_rays(rng, batch.rays)
        batch = batch.replace(rays=rays)
        model_results = model(rng, rays, train_frac=train_frac, train=True, compute_extras=False,
                              **forward_kwargs)
        if config.use_gradient_debias and "cache_main" in model_results:
            _debias_forward(model, rng, rays, train_frac, model_results)
        losses: Dict[str, Any] = {}
        stats: Dict[str, Any] = {}
        for key in sorted(k for k in model_results if k.endswith("main")):
            _compute_losses_for_output(batch, rays, model_results, config, train_frac, key,
                                       losses, stats)
            extra_losses_lib.compute_extra_losses(config, batch, rays, model_results, key, losses,
                                                  train_frac, model=model, rng=rng)
        for k, v in losses_lib.param_regularizer_loss(model, config, material).items():
            losses["regularizer_" + k] = v
        total = sum(losses.values())
        stats["losses"] = losses
        return total, stats

    def train_step(rng, state, batch, train_frac):
        state.optimizer.zero_grad(set_to_none=True)
        world = mesh_lib.process_count()
        shard = contextlib.nullcontext()
        if world > 1:
            rows = mesh_lib.leading_rows(batch)
            start = mesh_lib.process_index() * rows
            shard = torchutil.ray_shard(rows * world, torch.arange(start, start + rows))
        with shard:  # the backward too: checkpointed passes draw again there
            loss, stats = loss_fn(rng, batch, train_frac)
            loss.backward()
        params = [p for g in state.optimizer.param_groups for p in g["params"]]
        with torch.no_grad():
            for p in params:
                # Adam sees every parameter, as the JAX optimizer does: unused ones get
                # zero gradients rather than being skipped.
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            mesh_lib.allreduce_gradients(params)
            for p in params:
                p.grad.nan_to_num_()
            losses_lib.clip_gradients(state.model, config)
            stats["grad_norm"] = losses_lib.tree_norm([p.grad for p in params])
            stats["param_norm"] = losses_lib.tree_norm([p.detach() for p in params])
        for group, lr_fn in zip(state.optimizer.param_groups, state.group_lr_fns):
            group["lr"] = lr_fn(state.step)
        state.optimizer.step()
        state.step += 1
        stats["loss"] = loss.detach()
        stats["losses"] = {k: v.detach() if isinstance(v, torch.Tensor) else v
                           for k, v in stats["losses"].items()}
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


def setup_model(config, dataset=None, device="cuda"):
    """Model, optimizer state, eval render function, train step (casting
    `dataset`'s Pixels batches) and the main learning-rate schedule, on
    `device` (the card unless the caller asks for the CPU)."""
    from neural_radiance_caching_tpu_torch.models import construct

    model = construct.make_model(config, device=device)
    state, lr_fn = create_optimizer(config, model)
    return (model, state, create_render_fn(model), create_train_step(model, config, dataset),
            lr_fn)


# --- Checkpoint surgery ----------------------------------------------------------
#
# The stage warm starts match on the JAX parameter paths, "params/Cache/...",
# of both the source state_dict and the model.


def _jax_flat(state_dict, material):
    return {"/".join(("params",) + weights.jax_path(k, material)): (k, v)
            for k, v in state_dict.items()}


def replace_param_subset(model, source_state_dict, put_prefix="", take_prefix="",
                         exclude_prefixes=(), source_material=None):
    """Copy the source's parameters under `take_prefix` into `model` under
    `put_prefix`, except those under an `exclude_prefixes` entry; a path the
    model lacks is skipped, a shape mismatch raises. `source_material` says
    whether the source is a material model's state_dict (default: the
    model's kind)."""
    material = is_material_model(model)
    source_material = material if source_material is None else source_material
    target = _jax_flat(model.state_dict(), material)
    updates = {}
    for k_src, (_, v) in _jax_flat(source_state_dict, source_material).items():
        if not k_src.startswith(take_prefix):
            continue
        k_dst = put_prefix + k_src[len(take_prefix):]
        if any(k_dst.startswith(p) for p in exclude_prefixes) or k_dst not in target:
            continue
        key, current = target[k_dst]
        if tuple(current.shape) != tuple(v.shape):
            raise ValueError(f"Shape mismatch restoring {k_dst}: {tuple(current.shape)} vs "
                             f"{tuple(v.shape)}")
        updates[key] = v
    with torch.no_grad():
        params = dict(model.named_parameters())
        params.update(dict(model.named_buffers()))
        for key, v in updates.items():
            params[key].copy_(v.to(params[key].device, params[key].dtype))
    return model


def restore_partial_checkpoint(model, source_state_dict, prefixes=None, exclude_prefixes=(),
                               replace_dict=None, source_material=None):
    """Prefix-filtered restore with optional put/take prefix renaming
    ({put_prefix: take_prefix})."""
    kwargs = dict(exclude_prefixes=tuple(exclude_prefixes), source_material=source_material)
    if replace_dict:
        for put_prefix, take_prefix in replace_dict.items():
            replace_param_subset(model, source_state_dict, put_prefix, take_prefix, **kwargs)
        return model
    for prefix in prefixes if prefixes is not None else [""]:
        replace_param_subset(model, source_state_dict, prefix, prefix, **kwargs)
    return model
