"""Data-parallel process group and sharding (counterpart of ``parallel/mesh.py``).

The JAX package trains with one jitted program over a 1-D
``Mesh(("data",))``: ray batches sharded along their leading axis,
parameters replicated, the gradient all-reduce inserted by XLA from the
shardings. Here each rank is a process with one device in a
``torch.distributed`` process group, and the "mesh" is that single data
axis:

- its ``Dataset`` yields ``batch_size // world`` rays, drawn from numpy seed
  ``np_rng_seed + rank`` (``data/datasets.py``);
- the train step draws every random number at the global batch's shape and
  keeps its block (``utils/torchutil.ray_shard``), then averages every
  gradient over the ranks before it cleans and clips them
  (``allreduce_gradients``), so that N ranks compute what one process
  computes on the global batch;
- ``replicate`` broadcasts rank 0's parameters and optimizer state;
- the eval render splits each chunk across the ranks (``engine/renderer``).

A world of one with no ``torchrun`` environment creates no group, and every
function here then leaves its arguments as they are. The backend follows
the device: NCCL on the card, gloo on the CPU (``backend`` overrides it per
call; gloo ranks may share one card, NCCL ranks may not). A failed NCCL
setup raises; nothing falls back to gloo.

``spawn`` runs a function in N ranks of one group on this host, each a
fresh process meeting over a ``FileStore``; ``dryrun_multichip`` uses it for
one sharded step of the transient material stage on tiny shapes.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import os
import subprocess
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from neural_radiance_caching_tpu_torch.utils import torchutil

DATA_AXIS = "data"
# A collective that the ranks call in different orders fails after this
# long rather than hanging.
TIMEOUT_S = 600.0
# Leaves that one sensor kernel fills for every ray: replicated, never split.
GLOBAL_FIELDS = ("impulse_response",)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data axis: rank, world size, its device,
    and the group's backend (None for a world of one with no group)."""

    rank: int
    world_size: int
    device: str
    backend: Optional[str]


def process_count():
    """The number of ranks (1 without a group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index():
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _rank_device(device, local_rank):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return f"cuda:{local_rank}"
    return str(device)


def create_mesh(device="cuda", backend=None, rank=None, world_size=None, store=None,
                timeout_s=TIMEOUT_S):
    """The data-parallel group of this process (counterpart of `create_mesh`).

    From explicit `rank`, `world_size` and `store`, else from ``torchrun``'s
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
    with neither, a world of one and no group, on `device` as given. The
    backend defaults to NCCL on the card and gloo on the CPU. A rank's
    device is ``cuda:LOCAL_RANK`` where `device` names no index. The group
    is checked with one all-reduce, so a backend that cannot run raises
    here. A group that exists already is reused.
    """
    torchutil.check_device(device, "the process group", "run it on the CPU")
    if dist.is_initialized():
        rank = dist.get_rank()
        local = int(os.environ.get("LOCAL_RANK", rank))
        return Mesh(rank, dist.get_world_size(), _rank_device(device, local), dist.get_backend())
    if rank is None and "WORLD_SIZE" not in os.environ:
        return Mesh(0, 1, str(device), None)
    if rank is None:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init = dict(init_method="env://")
    else:
        if store is None or world_size is None:
            raise ValueError("an explicit rank needs world_size and a store")
        init = dict(store=store)
    local = int(os.environ.get("LOCAL_RANK", rank))
    rank_device = _rank_device(device, local)
    on_card = torch.device(rank_device).type == "cuda"
    if backend is None:
        backend = "nccl" if on_card else "gloo"
    if on_card:
        torch.cuda.set_device(rank_device)
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **init)
    # NCCL connects at its first collective: make that here.
    probe = torch.ones(1, device=rank_device if backend == "nccl" else "cpu")
    dist.all_reduce(probe)
    if int(probe.item()) != world_size:
        raise RuntimeError(f"process group check summed {probe.item()}, not {world_size}")
    return Mesh(rank, world_size, rank_device, backend)


def destroy():
    """Leave the group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier():
    """Wait for every rank (nothing without a group)."""
    if process_count() > 1:
        dist.barrier()


# --- sharding ------------------------------------------------------------------------


def _per_ray_fields(tree):
    """(name, value) of every per-ray field of a batch or rays dataclass,
    nested dataclasses walked, the global fields left out."""
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if v is None or f.name in GLOBAL_FIELDS:
            continue
        if dataclasses.is_dataclass(v):
            yield from _per_ray_fields(v)
        else:
            yield f.name, v


def leading_rows(tree):
    """The leading (ray) size of a batch or rays dataclass."""
    for _, v in _per_ray_fields(tree):
        return int(v.shape[0])
    raise ValueError(f"{type(tree).__name__} has no per-ray field")


def _map_per_ray(tree, fn):
    kwargs = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if v is not None and f.name not in GLOBAL_FIELDS:
            v = _map_per_ray(v, fn) if dataclasses.is_dataclass(v) else fn(f.name, v)
        kwargs[f.name] = v
    return type(tree)(**kwargs)


def shard_batch(batch, rank=None, world_size=None):
    """This rank's block of rows of every per-ray field of `batch` (numpy or
    torch); ``impulse_response``, the 1-D sensor kernel every ray shares, is
    replicated. A leading size that the world does not divide raises, as
    JAX's sharding does."""
    rank = process_index() if rank is None else rank
    world_size = process_count() if world_size is None else world_size
    if world_size == 1:
        return batch

    def block(name, v):
        n = v.shape[0]
        if n % world_size:
            raise ValueError(f"{name}: leading size {n} is not divisible by the {world_size} "
                             f"ranks of the {DATA_AXIS!r} axis")
        rows = n // world_size
        return v[rank * rows:(rank + 1) * rows]

    return _map_per_ray(batch, block)


def pad_rays_to_devices(tree, num_devices):
    """Pad the leading axis of every per-ray field to a multiple of
    `num_devices` by repeating its last row; returns (tree, pad). The global
    fields stay as they are."""
    pad = (-leading_rows(tree)) % num_devices
    if pad == 0:
        return tree, 0

    def pad_fn(_, x):
        if isinstance(x, np.ndarray):
            return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1), mode="edge")
        return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))], dim=0)

    return _map_per_ray(tree, pad_fn), pad


def shard_index(global_rows, rank=None, world_size=None, device="cpu"):
    """The rows of a global batch of `global_rows` that this rank takes when
    the batch is padded as `pad_rays_to_devices` pads it and split in equal
    blocks: ceil(global_rows / world) rows, the padding repeating the last
    row."""
    rank = process_index() if rank is None else rank
    world_size = process_count() if world_size is None else world_size
    per_rank = -(-global_rows // world_size)
    index = torch.arange(rank * per_rank, (rank + 1) * per_rank, device=device)
    return torch.clamp(index, max=global_rows - 1)


# --- collectives -----------------------------------------------------------------------


def _groups(tensors):
    """Tensors grouped by (device, dtype), in first-seen order."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    return list(groups.values())


def _coalesced(tensors, collective):
    """Run `collective(flat)` on one flat buffer per (device, dtype) group
    and copy the result back; NCCL's host tensors travel through the card."""
    for group in _groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        on_host = dist.get_backend() == "nccl" and flat.device.type == "cpu"
        buf = flat.to(torch.cuda.current_device()) if on_host else flat
        collective(buf)
        flat = buf.cpu() if on_host else buf
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def allreduce_gradients(params):
    """Average every parameter's gradient over the ranks, in the order of
    `params` (every gradient must be a tensor: a parameter one rank leaves
    unused has a zero gradient there, so that every rank reduces the same
    buffers): one SUM all-reduce per (device, dtype) group, then / world."""
    if process_count() > 1:
        _coalesced([p.grad for p in params], allreduce_mean)


def allreduce_mean(tensor):
    """`tensor` averaged over the ranks, in place; returned."""
    world = process_count()
    if world > 1:
        dist.all_reduce(tensor)
        tensor.div_(world)
    return tensor


def replicate(model, optimizer=None, src=0):
    """Broadcast rank `src`'s parameters, buffers and optimizer state to
    every rank (counterpart of `replicate`): once at setup and after every
    restore or warm start."""
    if process_count() == 1:
        return
    tensors = list(model.state_dict().values())
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                state = optimizer.state.get(p, {})
                tensors += [state[k] for k in sorted(state) if isinstance(state[k],
                                                                          torch.Tensor)]
    with torch.no_grad():
        _coalesced(tensors, lambda buf: dist.broadcast(buf, src))


# --- ranks on this host ------------------------------------------------------------------


def _tail(path, limit=6000):
    try:
        with open(path, errors="replace") as f:
            return f.read()[-limit:]
    except OSError:
        return "(no output)"


def spawn(target, world_size, kwargs=None, *, workdir, device="cpu", backend=None,
          timeout_s=600.0, group_timeout_s=TIMEOUT_S, paths=(), threads=1):
    """Run ``target(mesh, **kwargs)`` in `world_size` ranks of one group.

    `target` is "module:function". Each rank is a fresh
    ``python -m neural_radiance_caching_tpu_torch.parallel.mesh`` process
    (`paths` prepended to its PYTHONPATH; `threads` CPU threads) that meets
    the others over a FileStore in `workdir`, on `device` with `backend`
    (default: as `create_mesh` picks it) and the group's collective timeout
    `group_timeout_s`. Waits at most `timeout_s` for all of them; a rank
    that fails, or the time running out, kills every rank left and raises
    with each rank's output. Returns the ranks' return values, in rank
    order.
    """
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    torch.save(kwargs or {}, os.path.join(workdir, "kwargs.pt"))
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root, *paths] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = str(threads)
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    procs, logs = [], []
    for rank in range(world_size):
        log = os.path.join(workdir, f"rank{rank}.log")
        logs.append(log)
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, "--target", target, "--rank", str(rank),
                 "--world_size", str(world_size), "--workdir", workdir, "--device", device,
                 "--backend", backend or "", "--timeout_s", str(group_timeout_s),
                 "--threads", str(threads)],
                stdout=out, stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + timeout_s
    def running():
        return [p.poll() for p in procs].count(None)

    try:
        while running() and time.monotonic() < deadline:
            if any(p.returncode not in (None, 0) for p in procs):
                # The others are failing too, or waiting on the failed rank:
                # a moment to finish their own reports.
                grace = time.monotonic() + 2.0
                while running() and time.monotonic() < grace:
                    time.sleep(0.05)
                break
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        late = [r for r, p in enumerate(procs) if p.poll() is None]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    if failed or late:
        why = (f"rank(s) {', '.join(map(str, failed))} failed" if failed
               else f"the ranks did not finish within {timeout_s:.0f} s")
        raise RuntimeError(f"spawn({target!r}, {world_size}): {why}\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode}) ---\n{_tail(logs[r])}"
            for r, p in enumerate(procs)))
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world_size)]


def _rank_main(argv=None):
    """One rank of `spawn`: join the group, run the target, save its return
    value."""
    import argparse

    parser = argparse.ArgumentParser()
    for name in ("target", "workdir", "device", "backend"):
        parser.add_argument(f"--{name}", required=name != "backend", default="")
    for name in ("rank", "world_size", "threads"):
        parser.add_argument(f"--{name}", type=int, required=True)
    parser.add_argument("--timeout_s", type=float, required=True)
    args = parser.parse_args(argv)
    torch.set_num_threads(args.threads)
    store = dist.FileStore(os.path.join(args.workdir, "store"), args.world_size)
    mesh = create_mesh(args.device, args.backend or None, rank=args.rank,
                       world_size=args.world_size, store=store, timeout_s=args.timeout_s)
    module, _, name = args.target.partition(":")
    try:
        fn = getattr(importlib.import_module(module), name)
        out = fn(mesh, **torch.load(os.path.join(args.workdir, "kwargs.pt"), weights_only=False))
        torch.save(out, os.path.join(args.workdir, f"rank{args.rank}.pt"))
    except Exception:
        # Leaving the group would wait on the other ranks: exit at once.
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    destroy()


# --- the multi-rank dry run --------------------------------------------------------------


def _tiny_transient_material(device):
    """The transient material model and Config of JAX's dry run
    (``__graft_entry__._dryrun_transient_material_step``): two sampler
    levels of 4 samples, 8-wide MLPs, 1024-row grids, 16 bins, the
    learnable light, the debias pass and the consistency loss; 4 secondary
    rays per surface point where JAX's has 2, which split over the two
    lobes gives the specular lobe's two samplers one ray, and the port
    refuses to draw more directions than rays (``importance_sample_rays``)."""
    from neural_radiance_caching_tpu_torch.engine.configs import Config
    from neural_radiance_caching_tpu_torch.models.layers import softplus
    from neural_radiance_caching_tpu_torch.models.material_model import TransientMaterialModel
    from neural_radiance_caching_tpu_torch.ops import coord

    config = Config(
        dataset_loader="synthetic_spheres", batch_size=8 * process_count(), near=0.2, far=6.0,
        secondary_far=2.0, material_loss_radius=2.0, max_steps=10, use_transient=True,
        n_bins=16, exposure_time=1.0, learnable_light=True,
        light_source_position=[0.0, 0.0, 1.0], data_loss_type="rawnerf_transient_unbiased",
        use_gradient_debias=True, cache_consistency_loss_weight=1.0,
        cache_consistency_loss_type="mse_unbiased", mask_lossmult=False, linear_to_srgb=False)
    grid = {"hash_map_size": 1024, "max_grid_size": 64, "num_features": 2, "bbox_scaling": 2.0}
    mlp = {"net_depth": 1, "net_width": 8, "disable_density_normals": True,
           "enable_pred_normals": True, "warp_fn": coord.contract_radius_2}
    strategy = ((0, 0, 4), (1, 1, 4))
    slf = {"net_depth": 1, "net_width": 8, "skip_layer": 2, "bottleneck_width": 8,
           "use_directional_enc": True, "use_ide": True, "deg_view": 2,
           "net_depth_viewdirs": 1, "net_width_viewdirs": 8, "bottleneck_viewdirs": 8,
           "skip_layer_dir": 2, "use_grid": False, "use_bottleneck": False,
           "use_density_feature": False, "use_shader_bottleneck": True, "use_lights": False}
    model = TransientMaterialModel(
        config=config,
        cache_model_params={
            "sampler_params": {"sampling_strategy": strategy,
                               "mlp_params_per_level": (mlp, mlp),
                               "grid_params_per_level": (grid, grid), "dilation_bias": 0.0,
                               "dilation_multiplier": 0.0, "raydist_fn": None},
            "shader_params": {"net_depth": 0, "net_width": 8, "bottleneck_width": 8,
                              "use_grid": True, "grid_params": grid,
                              "warp_fn": coord.contract_radius_2, "use_reflections": True,
                              "use_ambient": False, "use_indirect": True, "use_active": True,
                              "surface_lf_params": slf, "net_depth_integrated_brdf": 1,
                              "net_width_integrated_brdf": 8, "net_depth_brdf": 1,
                              "net_width_brdf": 8, "net_depth_irradiance": 1,
                              "net_width_irradiance": 8, "rgb_activation": softplus},
            "resample_secondary": True, "train_sampling_strategy": strategy,
            "render_sampling_strategy": strategy},
        use_light_sampler=True,
        light_sampler_params={"net_depth": 1, "net_width": 8, "bottleneck_width": 8,
                              "num_components": 4, "use_density_feature": False,
                              "use_grid": True, "grid_params": grid,
                              "warp_fn": coord.contract_radius_2},
        shader_params={"net_depth": 0, "net_width": 8, "bottleneck_width": 8,
                       "use_density_feature": False, "use_grid": True, "grid_params": grid,
                       "warp_fn": coord.contract_radius_2, "num_secondary_samples": 4,
                       "render_num_secondary_samples": 4, "num_secondary_samples_diff": 1,
                       "render_num_secondary_samples_diff": 1,
                       "cache_train_sampling_strategy": ((1, 1, 4),),
                       "cache_render_sampling_strategy": ((1, 1, 4),), "net_depth_brdf": 1,
                       "net_width_brdf": 8, "use_brdf_correction": False, "use_active": True,
                       "use_indirect": True},
        resample=True, resample_render=True, num_resample=1, slf_variate=False)
    return model.to(device), config


def _dryrun_rank(mesh, seed=0):
    """One sharded step of the tiny transient material stage on this rank:
    its own rows of the batch, the gradients averaged over the ranks.
    Returns (the loss averaged over the ranks, a checksum of the parameters
    after the step)."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.parallel import train

    torch.manual_seed(seed)
    model, config = _tiny_transient_material(mesh.device)
    config.extra_losses = flagship.trainer_consistency_losses(config)
    state, _ = train.create_optimizer(config, model)
    replicate(model, state.optimizer)
    dataset = datasets.SyntheticSpheres("train", None, config, num_images=2, resolution=8,
                                        device=mesh.device)
    rng = torch.Generator(device=mesh.device).manual_seed(seed + 42)
    state, stats = train.create_train_step(model, config, dataset)(
        rng, state, dataset.next_train(), 0.5)
    loss = float(allreduce_mean(stats["loss"].detach().reshape(1).clone()))
    checksum = float(sum(p.detach().double().sum() for p in model.parameters()))
    return loss, checksum


def dryrun_multichip(n_devices=2, timeout_s=600.0, workdir=None):
    """One sharded train step of the transient material stage on tiny shapes
    over `n_devices` gloo ranks on the CPU (counterpart of
    ``__graft_entry__.dryrun_multichip``); prints the loss, raises if a rank
    fails, the loss is not finite or the ranks' parameters differ. Returns
    the loss."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = spawn(f"{__name__}:_dryrun_rank", n_devices, workdir=workdir or tmp,
                    timeout_s=timeout_s)
    losses = {loss for loss, _ in out}
    checksums = {c for _, c in out}
    loss = out[0][0]
    if len(losses) != 1 or not np.isfinite(loss):
        raise AssertionError(f"dryrun_multichip({n_devices}): losses {sorted(losses)}")
    if len(checksums) != 1:
        raise AssertionError(f"dryrun_multichip({n_devices}): the ranks' parameters differ "
                             f"after the step: {sorted(checksums)}")
    print(f"dryrun_multichip({n_devices}): transient material stage sharded step OK, "
          f"loss={loss:.4f}", flush=True)
    return loss


if __name__ == "__main__":
    _rank_main()
