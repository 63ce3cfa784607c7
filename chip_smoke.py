"""Bring-up check of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py [--seed N] [--steps N] [--material-steps N]
                          [--transient-steps N] [--transient-material-steps N]
                          [--trainer-steps N] [--profile FILE]

Phases, one line each (any failure exits nonzero):
  1. device: the card, and nvidia-smi's name and power limit;
  2. build: compile the CUDA source from csrc/ with nvcc;
  3. kernel: the leveled kernel against its plain PyTorch version at the
     flagship cache shape (6 levels x 262,144 points x 4 taps, F = 4,
     524,288 rows), on uniform points and on camera-ray samples;
  4. kernel (planes): the planes kernel against its plain version at the
     flagship material shape (6 levels x 1,572,864 secondary-ray samples x
     4 taps), with the leveled kernel checked and timed on the same updates,
     and each level's slice timed alone;
  5. kernel (rows): the row scatter against its plain version on the
     run-deduplicated update stream of the flagship cache shape (camera-ray
     samples, 6 x 1,048,576 updates), and its padded wrapper at a ragged
     update count; timed against index_add_ there and on the same updates
     before the dedup scan, beside the skip instance on the dedup'd stream
     and the host time of one call;
  6. encoder: hash-grid table gradients, kernel backward against the plain
     backward, at the cache shape (leveled) and the material shape (planes);
  7. reference: a narrow cache model with the flagship's structure, the same
     weights on the GPU and on the CPU (whose path the CPU tests hold
     against the JAX package), loss and gradients compared; the gradient
     limit is checked against a noise floor and two planted scatter faults;
  8. material reference: the same for a narrow material model, with the
     same random draws on both devices, the secondary-ray encoder on the
     planes kernel, and the faults planted in the planes kernel;
  9. transient reference: the same for a narrow transient cache model, once
     with the direct table-gradient scatter and once with its run-dedup (the
     faults planted in the leveled kernel and in its skip instance); the
     dedup and direct table gradients on the card agree to float32 order;
 10. train: the full-width flagship cache model, batch 8192 on
     SyntheticSpheres (8 views, 128^2): 3 warmup + N timed steps; losses
     finite, every parameter the passive shader reads changed, one kernel
     launch per step;
 11. material train: the full-width flagship material model, batch 1536 on
     the same scene: first one step in which every scatter call is held
     against its plain version on the same inputs (both kernels at the
     shapes this path gives them), whose planes inputs then time the planes
     kernel against index_add_ (all levels and each level alone), then 3
     warmup + N timed steps with
     gradient checkpointing
     (the JAX setting), then one step without it for its peak memory;
     losses finite, exactly the parameters no loss reaches unchanged, the
     per-step launch counts of both kernels as the model's structure gives;
 12. transient train: the full-width flagship transient cache model, batch
     2048 x 700 bins on SyntheticSpheres (4 views, 64^2), with the direct
     backward and with scatter_dedup: one checked step each, then 3 warmup
     and N timed steps each in alternating blocks; losses finite, exactly the
     parameters no loss reaches unchanged, the pinned per-step launches,
     peak memory; then one forward + backward of the transient rendering at
     [2048, 32, 700, 3] for each shift form;
 13. kernel (skip): the skip-zero-weight instance against its plain version
     on the dedup'd stream of the transient path's own updates (captured in
     phase 12's checked step), with NaN rows planted under the zero weights,
     the share of zero-weight updates, and both scatter routes timed; then
     the leveled kernel against index_add_ on the same captured updates (all
     levels and each level alone);
 14. eval reference: the narrow cache, material and transient models of
     phases 7-9 (every parameter drawn from U(-0.5, 0.5)), the same weights and
     draws on the GPU and the CPU, render a held-out 16^2 view through
     create_render_fn + render_image in chunks of 96 (the last one ragged)
     with 2 repeats; every output compared in relative L2 against a limit
     bracketed by a CPU noise floor and two encoder faults planted in the GPU
     forward; no scatter launched;
 15. gate: the full-width flagship cache model, fresh, trained 200 steps at
     the gate's learning rate (batch 8192, 8 views at 128^2), then view 0 of
     the held-out 64^2 set rendered and scored; below 20 dB the run fails;
     200 leveled launches;
 16. eval render: bench_eval_render (full extras and rgb-only) of the
     full-width cache model on the 128^2 test view (3 timed images), of the
     material model on a held-out 64^2 view (chunks of 1024, then the whole
     view as one chunk if it fits), of the transient cache model on a
     held-out 64^2 view (one chunk of 4096 rays x 700 bins) and of the
     transient material model on that view (chunks of 1024; 2 timed images
     each): times, the render function's device time, peak memory, raw
     outputs finite, no scatter launched;
 17. transient material reference: a narrow transient material model with
     the flagship's structure (64 bins, the learnable light, 32 secondary
     rays through the transient cache), the same weights and draws on the GPU
     and the CPU, one step under the trainer's consistency binding: every
     loss term (the consistency term included) and every gradient leaf
     compared, the limit bracketed by a noise floor and two faults planted in
     the leveled kernel;
 18. transient material train: the full-width flagship transient material
     model, batch 512 x 700 bins on SyntheticSpheres (4 views, 64^2), in two
     forms (the JAX bench's step with no extra loss, and the staged trainer's
     consistency binding): one checked step each, then 3 warmup and N timed
     steps each with gradient checkpointing in alternating blocks, then one
     step each without it for its peak memory; losses finite, exactly the
     parameters no loss reaches unchanged, 3 leveled launches per step and
     no planes launch;
 19. trainer reference: the staged trainer (engine/trainer.Trainer) on
     configs/synthetic_spheres.gin, cache stage, the same weights, batch and
     draws on the GPU and the CPU, one step: every loss term (the cache_
     duplicates of the cache-only material model included) and every
     gradient leaf, the limit bracketed by a noise floor and two faults
     planted in the leveled kernel; one leveled launch;
 20. trainer train: the train_with_trainer entry point, in-process, on the
     full-width configs/ngp_yobo.gin cache stage (batch 8192 on
     SyntheticSpheres, density normals, the power-ladder ray warp, the mask
     loss, per-module schedules) into a temporary checkpoint_dir: 3 warmup
     + N timed steps by host clock ending in a sync, beside the rays/s of
     the trainer's own train_log.jsonl; losses finite with their cache_
     duplicates, the checkpoint written, a second run resumes and takes no
     step, no kernel launch (the density normals take the plain encoder),
     peak memory; then one 48^2 test view through log_test_set_evaluation.
Then the kernels JSON line, the eval JSON line, the transient material JSON
line, the trainer JSON line, the nvidia-smi line, and the result line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import traceback


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def _patched(module, **attrs):
    """Set attributes of `module` for the length of a block: the planted
    faults, the checking wrappers and the reference layout threshold."""
    saved = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


def _cuda_ms(fn, repeats=11, warmup=2):
    """Median of per-call device times (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _abs_sum_bound(idx, w, ct, num_rows, corners, plain=None, **kw):
    """Per-entry sum of |w * ct| over the updates it receives."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    plain = plain or scatter_cuda.scatter_add_weighted_leveled_plain
    features = ct.shape[-1] if idx.dim() == 2 else ct.shape[1]
    return plain(idx, w.abs(), ct.abs(), num_rows=num_rows, features=features, corners=corners,
                 **kw)


# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes/s and float32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def _bound(nbytes, flops):
    """(bound_ms, bound_by): the least time for `nbytes` of device memory
    traffic (each input read once, each output written once) and `flops`
    float32 operations, and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _index_add_call(idx, rows, num_rows):
    """One PyTorch call of a row scatter's sum, for `library_ms`: index_add_
    of the update rows [L, N, F] (for a weighted scatter, the products
    w * ct formed beforehand) into a fresh flat [L * num_rows, F] table."""
    import torch

    levels, features = idx.shape[0], rows.shape[-1]
    offsets = torch.arange(levels, device=idx.device, dtype=torch.int64)[:, None] * num_rows
    flat_idx = (idx.reshape(levels, -1).to(torch.int64) + offsets).reshape(-1)
    flat_rows = rows.reshape(-1, features).contiguous()
    return lambda: torch.zeros(levels * num_rows, features, device=rows.device).index_add_(
        0, flat_idx, flat_rows)


def _update_rows(kind, w, ct, corners):
    """The products w * ct of a weighted scatter's updates, in the order of
    its idx: leveled [L, P*U, F] from ct [L, P, F], planes [L, U, P, F] from
    ct [L, F, P]."""
    if kind == "planes":
        return w[..., None] * ct.transpose(1, 2)[:, None]
    return w[..., None] * ct.repeat_interleave(corners, dim=1)


def _alternating_ms(fns, rounds=2):
    """Per-call device time of each of `fns` (name -> function): medians of
    11 calls by CUDA events (_cuda_ms), taken in turns, the functions in
    order and then in reverse; each is the median of its `rounds` turns."""
    names, times = list(fns), {k: [] for k in fns}
    for r in range(rounds):
        for k in names if r % 2 == 0 else names[::-1]:
            times[k].append(_cuda_ms(fns[k]))
    return {k: statistics.median(v) for k, v in times.items()}


def _kernel_vs_library(kind, idx, w, ct, kw):
    """On one update set: the `kind` kernel and one index_add_ of its update
    rows, timed in turns (_alternating_ms: "kernel", "library")."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    kernel = getattr(scatter_cuda, f"scatter_add_weighted_{kind}")
    fns = {"kernel": lambda: kernel(idx, w, ct, **kw),
           "library": _index_add_call(idx, _update_rows(kind, w, ct, kw["corners"]),
                                      kw["num_rows"])}
    return _alternating_ms(fns)


def _host_ms(torch, fn, repeats=11):
    """Median host time of one call of `fn`, which returns without
    synchronising: what the call costs the host (its Python, allocations and
    launches), the floor of its time on an idle card."""
    times = []
    for _ in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times[1:]) * 1e3


def _per_level_ms(kind, idx, w, ct, kw):
    """[{"kernel": ms, "library": ms}] of each level's slice alone."""
    return [_kernel_vs_library(kind, idx[lv:lv + 1], w[lv:lv + 1], ct[lv:lv + 1], kw)
            for lv in range(idx.shape[0])]


def _levels_text(per_level, sizes):
    return ", ".join(f"{s}^3 {t['kernel']:.4f}/{t['library']:.4f}"
                     for s, t in zip(sizes, per_level))


# Float32 sums of the same terms in another order (atomics vs index_add_)
# differ by at most (n - 1) * eps * sum|terms|; rounding errors grow like
# sqrt(n) in practice. 2e-5 * sum|terms| (~170 eps) covers a 16^3-level cell
# receiving up to ~3e4 updates.
SUM_ORDER_TOL = 2e-5


def phase_kernel(torch, device, seed):
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda

    levels, points, corners, features, num_rows = 6, 262144, 4, 4, 524288
    gen = torch.Generator(device=device).manual_seed(seed)
    # Real encoder taps of uniform points: the 16^3 dense level funnels
    # ~1M updates into 4,096 rows, as on the main path.
    x = torch.rand((points, 3), generator=gen, device=device)
    rows, weights = hashgrid._tap_rows_and_weights(
        x, None, (16, 32, 64, 128, 256, 512), num_rows, 3, "simplex")
    idx = rows.permute(1, 0, 2).reshape(levels, -1).contiguous()
    w = weights.permute(1, 0, 2).reshape(levels, -1).contiguous()
    ct = torch.randn((levels, points, features), generator=gen, device=device)
    kw = dict(num_rows=num_rows, features=features, corners=corners)

    def check(idx, w, ct):
        got = scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, **kw)
        want = scatter_cuda.scatter_add_weighted_leveled_plain(idx, w, ct, **kw)
        bound = _abs_sum_bound(idx, w, ct, num_rows, corners)
        torch.cuda.synchronize()
        err = (got - want).abs()
        max_rel = float((err / want.abs().clamp(min=1e-30))[want.abs() > 1e-3].max())
        return float(err.max()), max_rel, bool((err <= SUM_ORDER_TOL * bound + 1e-30).all())

    max_abs, max_rel, ok = check(idx, w, ct)
    hot = int(torch.bincount(idx[0].long(), minlength=4096).max())
    del rows, weights
    ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, **kw))
    plain_ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled_plain(idx, w, ct, **kw))
    library_ms = _cuda_ms(_index_add_call(idx, _update_rows("leveled", w, ct, corners), num_rows))
    n = levels * points * corners
    bound_ms, bound_by = _bound(4 * (2 * n + levels * points * features
                                     + levels * num_rows * features), 2 * n * features)

    # The same shape on camera-ray samples (8192 rays x 32 sorted samples,
    # as the rows phase draws them): neighbouring points share cells, as on
    # the path.
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    x = _primary_sample_points(torch, device, gen, 8192, 32).reshape(-1, 3)
    rows, weights = hashgrid._tap_rows_and_weights(x, None, MATERIAL_LEVELS, num_rows, 3,
                                                   "simplex")
    r_idx = rows.permute(1, 0, 2).reshape(levels, -1).contiguous()
    r_w = weights.permute(1, 0, 2).reshape(levels, -1).contiguous()
    r_ct = torch.randn((levels, points, features), generator=gen, device=device)
    del x, rows, weights
    ray_abs, _, ray_ok = check(r_idx, r_w, r_ct)
    ray = _kernel_vs_library("leveled", r_idx, r_w, r_ct, kw)
    print(f"kernel: scatter_add_weighted_leveled L={levels} P={points} U={corners} F={features} "
          f"rows={num_rows} (16^3 level: max {hot} updates on one row) "
          f"max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"tol=|err|<={SUM_ORDER_TOL}*sum|w*ct| {'ok' if ok else 'FAIL'} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms(index_add_ of w*ct rows)="
          f"{library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) (median of 11, CUDA events); "
          f"on camera-ray samples (8192 rays x 32): max_abs_err={ray_abs:.3e} same tol "
          f"{'ok' if ray_ok else 'FAIL'} kernel_ms={ray['kernel']:.4f} "
          f"library_ms={ray['library']:.4f} (medians of 11 in 2 alternating turns)", flush=True)
    if not (ok and ray_ok):
        raise AssertionError("kernel disagrees with its plain version")
    return dict(max_abs_err=max(max_abs, ray_abs), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                camera_ray_ms=ray["kernel"], camera_ray_library_ms=ray["library"])


def phase_encoder(torch, device, seed):
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.models import grids
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda

    params = flagship.flagship_cache_params()["sampler_params"]["grid_params_per_level"][2]
    grid = grids.HashEncoding(**params).to(device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.rand((8192, 32, 1, 3), generator=gen, device=device)
    ct = torch.randn((8192, 32, 6 * 4), generator=gen, device=device)
    sizes = tuple(int(s) for s in grid.grid_sizes[:6])
    statics = dict(grid_sizes=sizes, table_size=grid.hash_map_size,
                   dense_offsets=grid.dense_offsets, interpolation="simplex")

    def grads(scatter_fn):
        grid.zero_grad(set_to_none=True)
        f = hashgrid.multires_grid_encode(
            x, grid.hash_levels[:3], grid.dense_levels, scatter_fn=scatter_fn, **statics)
        f.backward(ct)
        return grid.hash_levels.grad.clone(), grid.dense_levels.grad.clone()

    before = scatter_cuda.launches["leveled"]
    h_k, d_k = grads(None)
    launched = scatter_cuda.launches["leveled"] - before
    h_p, d_p = grads(scatter_cuda.scatter_add_weighted_leveled_plain)
    torch.cuda.synchronize()
    errs = []
    for a, b in ((h_k, h_p), (d_k, d_p)):
        scale = float(b.abs().max())
        errs.append(float((a - b).abs().max()) / scale)
    ok = launched == 1 and max(errs) <= 1e-5 and float(h_k[3:].abs().max()) == 0.0
    print(f"encoder: flagship grid backward (8192x32 points, 6 of 8 levels) kernel vs plain "
          f"rel_err hash={errs[0]:.3e} dense={errs[1]:.3e} (tol 1e-5 of max |grad|), "
          f"clamped levels zero, launches={launched} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("encoder gradients disagree")


def _narrow(params):
    p = copy.deepcopy(params)
    sp = p["sampler_params"]
    mlps = [dict(m) for m in sp["mlp_params_per_level"]]
    for m in mlps[:2]:
        m.update(net_width=32, net_depth=2, use_bf16_compute=False)
    mlps[2].update(net_width=32)
    sp["mlp_params_per_level"] = tuple(mlps)
    sp["grid_params_per_level"] = (None, None, dict(sp["grid_params_per_level"][2],
                                                    hash_map_size=2**14, max_grid_size=512))
    p["shader_params"].update(net_width=32, bottleneck_width=32, use_bf16_compute=False)
    return p


# Model-level gradients are held per leaf in relative L2 norm, not entry by
# entry: a sample that moves by a rounding error can cross a grid cell and
# move its table update to a neighbouring row. The limit sits between two
# readings the reference phase takes in every run: the noise floor (the CPU
# path against itself with the ray origins moved by one float32 ulp), which
# must read below it, and planted faults in the GPU scatter, which must read
# above it.
GRAD_REL_L2_TOL = 5e-2


def _planted_fault(fault, kind="leveled"):
    """A scatter with a deliberate fault, for the reference phases' check
    that their gradient limit would catch one. On the dedup'd stream (one
    update per row, corners 1), "taps rotated" moves each update's weight to
    the next update."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    real = getattr(scatter_cuda, f"scatter_add_weighted_{kind}")

    def scatter(idx, w, ct, **kw):
        if fault == "taps rotated" and kind == "planes":  # [L, U, P]: roll the taps
            w = w.roll(1, dims=1).contiguous()
        elif fault == "taps rotated" and kw["corners"] == 1:
            w = w.roll(1, dims=-1).contiguous()
        elif fault == "taps rotated":  # each tap's weight goes to the next corner
            w = w.reshape(w.shape[0], -1, kw["corners"]).roll(1, dims=-1).reshape(w.shape)
            w = w.contiguous()
        out = real(idx, w, ct, **kw)
        if fault == "finest level dropped":
            out[-1] = 0
        return out

    return scatter


def phase_reference(torch, device, seed):
    """Same narrow model and batch on the GPU (kernel) and the CPU (plain)."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    cfg = flagship.cache_config(batch_size=512, lr_delay_steps=0)
    params = _narrow(flagship.flagship_cache_params())
    batch = datasets.SyntheticSpheres("train", None, cfg, num_images=4, resolution=32,
                                      device="cpu").next_train()
    origins = batch.rays.origins
    nudged = batch.replace(rays=batch.rays.replace(
        origins=torch.nextafter(origins, torch.full_like(origins, float("inf")))))

    def step(dev, b, fault=None):
        torch.manual_seed(seed)
        model = flagship.build_flagship_cache_model(cfg, params, device=dev)
        state, _ = train.create_optimizer(cfg, model)
        before = scatter_cuda.launches["leveled"]
        patch = dict(scatter_add_weighted_leveled=_planted_fault(fault)) if fault else {}
        with _patched(scatter_cuda, **patch):
            _, stats = train.create_train_step(model, cfg)(None, state, b.to(dev), 0.5)
        losses = {k: float(torch.as_tensor(v).detach()) for k, v in stats["losses"].items()}
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        return losses, grads, scatter_cuda.launches["leveled"] - before

    def worst_grad_err(g, ref):
        errs = {k: float((g[k] - ref[k]).norm()) / max(float(ref[k].norm()), 1e-30) for k in ref}
        worst = max(errs, key=errs.get)
        return errs[worst], worst

    l_cpu, g_cpu, n_cpu = step("cpu", batch)
    floor, floor_at = worst_grad_err(step("cpu", nudged)[1], g_cpu)
    l_gpu, g_gpu, n_gpu = step(device, batch)
    loss_err = max(abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu)
    err, err_at = worst_grad_err(g_gpu, g_cpu)
    faults = {f: worst_grad_err(step(device, batch, f)[1], g_cpu)
              for f in ("taps rotated", "finest level dropped")}
    finite = all(torch.isfinite(g).all() for g in g_gpu.values())
    # Same float32 math on two devices, summed in other orders: losses agree
    # to 1e-4.
    ok = (finite and loss_err <= 1e-4 and n_cpu == 0 and n_gpu == 1
          and floor <= GRAD_REL_L2_TOL and err <= GRAD_REL_L2_TOL
          and all(v > GRAD_REL_L2_TOL for v, _ in faults.values()))
    print(f"reference: narrow cache model, batch 512, gpu vs cpu: loss rel_err={loss_err:.3e} "
          f"(tol 1e-4) grad rel_l2_err max={err:.3e} at {err_at} (tol {GRAD_REL_L2_TOL}; "
          f"noise floor, cpu vs cpu with origins +1 ulp: {floor:.3e} at {floor_at}; planted "
          + ", ".join(f"{f}: {v:.3e} at {at}" for f, (v, at) in faults.items())
          + f", each must exceed the tol) kernel launches gpu={n_gpu} cpu={n_cpu} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("GPU path disagrees with the CPU reference path")


# The flagship material shape: 1536 rays x 32 secondary rays x 32 final
# samples, the secondary-ray level clamp of 6 (16^3, 32^3, 64^3 dense; 128,
# 256, 512 hashed), simplex taps, F = 4, T = 2^19 rows.
MATERIAL_POINTS = 1536 * 32 * 32
MATERIAL_LEVELS = (16, 32, 64, 128, 256, 512)


def _secondary_sample_points(torch, device, gen, num_rays, samples_per_ray):
    """Grid coordinates of samples spread as secondary samples are: rays from
    points on the central sphere in random directions, sampled from 0.1 to
    the secondary far plane 4, warped by the flagship's contraction."""
    from neural_radiance_caching_tpu_torch.ops import coord

    n = torch.randn((num_rays, 3), generator=gen, device=device)
    origins = 0.55 * n / n.norm(dim=-1, keepdim=True)
    d = torch.randn((num_rays, 3), generator=gen, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    t = 0.1 + 3.9 * torch.rand((num_rays, samples_per_ray), generator=gen, device=device)
    points = origins[:, None] + t[..., None] * d[:, None]
    return (coord.contract_radius_2(points) + 2.0) / 4.0  # bbox [-2, 2]^3 -> [0, 1]^3


def phase_kernel_planes(torch, device, seed):
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda

    levels, corners, features, num_rows = len(MATERIAL_LEVELS), 4, 4, 524288
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    x = _secondary_sample_points(torch, device, gen, 1536 * 32, 32).reshape(-1, 3)
    rows, weights = hashgrid._tap_rows_and_weights(
        x, None, MATERIAL_LEVELS, num_rows, 3, "simplex")
    del x
    idx = rows.permute(1, 2, 0).contiguous()  # [L, U, P]
    w = weights.permute(1, 2, 0).contiguous()
    del rows, weights
    ct = torch.randn((levels, features, MATERIAL_POINTS), generator=gen, device=device)
    kw = dict(num_rows=num_rows, features=features, corners=corners)

    # The leveled kernel on the same updates, in its own layout, is held to
    # the same plain sum.
    l_idx = idx.permute(0, 2, 1).reshape(levels, -1).contiguous()
    l_w = w.permute(0, 2, 1).reshape(levels, -1).contiguous()
    l_ct = ct.permute(0, 2, 1).contiguous()
    got = scatter_cuda.scatter_add_weighted_planes(idx, w, ct, **kw)
    lev = scatter_cuda.scatter_add_weighted_leveled(l_idx, l_w, l_ct, **kw)
    want = scatter_cuda.scatter_add_weighted_planes_plain(idx, w, ct, **kw)
    limit = SUM_ORDER_TOL * _abs_sum_bound(
        idx, w, ct, num_rows, corners, plain=scatter_cuda.scatter_add_weighted_planes_plain) + 1e-30
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    lev_err = float((lev - want).abs().max())
    ok = bool(((got - want).abs() <= limit).all())
    lev_ok = bool(((lev - want).abs() <= limit).all())
    del got, lev, want, limit
    hot = int(torch.bincount(idx[0].reshape(-1).long(), minlength=4096).max())
    ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_planes(idx, w, ct, **kw))
    plain_ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_planes_plain(idx, w, ct, **kw))
    leveled_ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled(l_idx, l_w, l_ct, **kw))
    library_ms = _cuda_ms(_index_add_call(idx, _update_rows("planes", w, ct, corners), num_rows))
    n = levels * corners * MATERIAL_POINTS
    bound_ms, bound_by = _bound(4 * (2 * n + levels * features * MATERIAL_POINTS
                                     + levels * num_rows * features), 2 * n * features)
    per_level = _per_level_ms("planes", idx, w, ct, kw)
    print(f"kernel (planes): scatter_add_weighted_planes L={levels} U={corners} "
          f"P={MATERIAL_POINTS} F={features} rows={num_rows} (secondary-ray samples; 16^3 level: "
          f"max {hot} updates on one row) max_abs_err={max_abs:.3e} "
          f"tol=|err|<={SUM_ORDER_TOL}*sum|w*ct| {'ok' if ok else 'FAIL'}; leveled kernel on the "
          f"same updates max_abs_err={lev_err:.3e} same tol {'ok' if lev_ok else 'FAIL'}; "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} leveled_kernel_same_updates_ms="
          f"{leveled_ms:.4f} library_ms(index_add_ of w*ct rows)={library_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) (median of 11, CUDA events); each level's "
          f"slice alone, kernel/library ms: {_levels_text(per_level, MATERIAL_LEVELS)} "
          f"(medians of 11 in 2 alternating turns)", flush=True)
    if not (ok and lev_ok):
        raise AssertionError("a kernel disagrees with the plain sum at the planes shape")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, leveled_ms=leveled_ms,
                leveled_max_abs_err=lev_err, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, per_level_ms=[t["kernel"] for t in per_level],
                per_level_library_ms=[t["library"] for t in per_level])


def phase_encoder_planes(torch, device, seed):
    """Table gradients through the planes backward at the material shape."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.models import grids
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda

    params = flagship.flagship_cache_params()["sampler_params"]["grid_params_per_level"][2]
    grid = grids.HashEncoding(**params).to(device)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    x = _secondary_sample_points(torch, device, gen, 1536 * 32, 32)[:, :, None]
    ct = torch.randn((1536 * 32, 32, len(MATERIAL_LEVELS) * 4), generator=gen, device=device)
    statics = dict(grid_sizes=MATERIAL_LEVELS, table_size=grid.hash_map_size,
                   dense_offsets=grid.dense_offsets, interpolation="simplex")
    assert hashgrid.use_planes_layout(x.shape[0] * x.shape[1], "mean")

    def grads(planes_fn):
        grid.zero_grad(set_to_none=True)
        f = hashgrid.multires_grid_encode(
            x, grid.hash_levels[:3], grid.dense_levels, planes_scatter_fn=planes_fn, **statics)
        f.backward(ct)
        return grid.hash_levels.grad.clone(), grid.dense_levels.grad.clone()

    before = dict(scatter_cuda.launches)
    h_k, d_k = grads(None)
    launched = {k: scatter_cuda.launches[k] - before[k] for k in before}
    h_p, d_p = grads(scatter_cuda.scatter_add_weighted_planes_plain)
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in ((h_k, h_p), (d_k, d_p))]
    ok = (launched == _launch_counts(planes=1) and max(errs) <= 1e-5
          and float(h_k[3:].abs().max()) == 0.0)
    print(f"encoder (planes): flagship grid backward at the material shape (1536x32x32 points, "
          f"6 of 8 levels) kernel vs plain rel_err hash={errs[0]:.3e} dense={errs[1]:.3e} "
          f"(tol 1e-5 of max |grad|), clamped levels zero, launches={launched} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("planes encoder gradients disagree")


# No loss reaches these parameters of the material model: the light
# sampler's outputs feed only the (unused) light importance sampler under a
# stop-gradient, the passive shaders read no light power, and the cache
# SLF's rgba head is unread. tests/test_torch_material_slice.py pins the
# same set against the JAX package's zero gradients.
_MATERIAL_UNREACHED = {
    "cache.shader.light_power", "cache.shader.surface_lf.output_rgba_layer.weight",
    "cache.shader.surface_lf.output_rgba_layer.bias", "shader.light_power",
    "light_sampler.layers.0.weight", "light_sampler.layers.0.bias",
    "light_sampler.layers.1.weight", "light_sampler.layers.1.bias",
    "light_sampler.output_layer.weight", "light_sampler.output_layer.bias",
    "light_sampler.grid.dense_levels", "light_sampler.grid.hash_levels",
}


def _launch_counts(**counts):
    """Launch counts of every kernel, zero unless given."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    return {k: counts.get(k, 0) for k in scatter_cuda.launches}


# Scatter launches per material train step: the encoder backwards a loss
# reaches, one each. Leveled: the cache's primary samples (1536 x 32 points)
# and the material grid (1536 points). Planes: the cache's secondary samples
# (1536 x 32 x 32 points). The light sampler's grid gets no gradient, and
# the gradient-debias forward runs without a graph.
_MATERIAL_LAUNCHES_PER_STEP = {"leveled": 2, "leveled_skip": 0, "planes": 1, "rows": 0}


def _narrow_material():
    """The flagship material structure at reference-phase widths. The
    secondary encoder takes the planes layout from 4,096 points on, and the
    primary-ray clamp (3) sits below the secondary one (5), so hash levels
    64^3 and 128^3... of the cache grid are reached through the planes
    kernel alone."""
    from neural_radiance_caching_tpu_torch import flagship

    strategy = ((0, 0, 16), (1, 1, 16), (2, 2, 16))
    cache = _narrow(flagship.flagship_cache_params())
    cache["sampler_params"]["sampling_strategy"] = strategy
    cache["train_sampling_strategy"] = cache["render_sampling_strategy"] = strategy
    mlps = [dict(m) for m in cache["sampler_params"]["mlp_params_per_level"]]
    mlps[2].update(primary_grid_level_clamp=3, secondary_grid_level_clamp=5)
    cache["sampler_params"]["mlp_params_per_level"] = tuple(mlps)
    return _narrow_material_shader(flagship.flagship_material_params(cache), strategy)


def _narrow_material_shader(params, strategy):
    """The light sampler and material shader of a material model's `params`
    at reference-phase widths, the shader's cache queries on `strategy`."""
    grid = dict(hash_map_size=2**14, max_grid_size=512)
    params["light_sampler_params"] = dict(
        params["light_sampler_params"], net_width=32, num_components=16,
        grid_params=dict(params["light_sampler_params"]["grid_params"], **grid))
    params["shader_params"] = dict(
        params["shader_params"], bottleneck_width=32, cache_train_sampling_strategy=strategy,
        cache_render_sampling_strategy=strategy,
        grid_params=dict(params["shader_params"]["grid_params"], **grid))
    return params


MATERIAL_REF_BATCH = 96
MATERIAL_PLANES_MIN_POINTS = 4096
# Material-model gradients are held per leaf, with each hash table split into
# its levels, in relative L2 norm. The levels only secondary rays reach sum
# few, sensitive terms: a rounding error turns a secondary ray and moves its
# samples across cells. The limit sits between the same two readings as the
# cache's: the noise floor (5.9e-2 on the CPU path, one core of the build
# sandbox) below it, the planted planes-kernel faults (1.0) above it.
MATERIAL_GRAD_REL_L2_TOL = 0.2


def _material_step(torch, device, seed, batch, fault=None):
    """One train step of the narrow material model on `device`; the random
    draws come from a CPU generator, so both devices see the same numbers."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    cfg = flagship.material_config(batch_size=MATERIAL_REF_BATCH, lr_delay_steps=0)
    torch.manual_seed(seed)
    model = flagship.build_flagship_material_model(cfg, _narrow_material(), device=device)
    state, _ = train.create_optimizer(cfg, model)
    before = dict(scatter_cuda.launches)
    patch = dict(scatter_add_weighted_planes=_planted_fault(fault, "planes")) if fault else {}
    with _patched(hashgrid, PLANES_MIN_POINTS=MATERIAL_PLANES_MIN_POINTS), \
            _patched(scatter_cuda, **patch):
        rng = torch.Generator().manual_seed(seed + 5)
        _, stats = train.create_train_step(model, cfg)(rng, state, batch.to(device), 0.5)
    losses = {k: float(torch.as_tensor(v).detach()) for k, v in stats["losses"].items()}
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    return losses, grads, {k: scatter_cuda.launches[k] - before[k] for k in before}


def _per_level(grads):
    """Gradient leaves with each stacked hash table split into its levels."""
    out = {}
    for k, g in grads.items():
        if k.endswith("grid.hash_levels"):
            out.update({f"{k}[{i}]": g[i] for i in range(g.shape[0])})
        else:
            out[k] = g
    return out


def _worst_grad_err(g, ref, keys=None):
    g, ref = _per_level(g), _per_level(ref)
    keys = [k for k in ref if keys is None or k.split("[")[0] in keys]
    errs = {k: float((g[k] - ref[k]).norm()) / max(float(ref[k].norm()), 1e-30) for k in keys
            if float(ref[k].norm()) > 0}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def phase_material_reference(torch, device, seed):
    """Same narrow material model, batch and draws on the GPU and the CPU."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets

    cfg = flagship.material_config(batch_size=MATERIAL_REF_BATCH)
    batch = datasets.SyntheticSpheres("train", None, cfg, num_images=4, resolution=32,
                                      device="cpu").next_train()
    origins = batch.rays.origins
    nudged = batch.replace(rays=batch.rays.replace(
        origins=torch.nextafter(origins, torch.full_like(origins, float("inf")))))
    l_cpu, g_cpu, n_cpu = _material_step(torch, "cpu", seed, batch)
    reached = [k for k in g_cpu if k not in _MATERIAL_UNREACHED]
    floor, floor_at = _worst_grad_err(_material_step(torch, "cpu", seed, nudged)[1], g_cpu,
                                      reached)
    l_gpu, g_gpu, n_gpu = _material_step(torch, device, seed, batch)
    loss_err = max(abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu)
    err, err_at = _worst_grad_err(g_gpu, g_cpu, reached)
    faults = {f: _worst_grad_err(_material_step(torch, device, seed, batch, f)[1], g_cpu, reached)
              for f in ("taps rotated", "finest level dropped")}
    finite = all(torch.isfinite(g).all() for g in g_gpu.values())
    tol = MATERIAL_GRAD_REL_L2_TOL
    ok = (finite and loss_err <= 1e-3 and n_cpu == _launch_counts()
          and n_gpu == _MATERIAL_LAUNCHES_PER_STEP and floor <= tol and err <= tol
          and all(v > tol for v, _ in faults.values()))
    print(f"material reference: narrow material model, batch {MATERIAL_REF_BATCH} x 32 secondary "
          f"rays, same draws, gpu vs cpu: loss rel_err={loss_err:.3e} (tol 1e-3) grad rel_l2_err "
          f"max={err:.3e} at {err_at} (tol {tol}; noise floor, cpu vs cpu with origins +1 ulp: "
          f"{floor:.3e} at {floor_at}; planted in the planes kernel "
          + ", ".join(f"{f}: {v:.3e} at {at}" for f, (v, at) in faults.items())
          + f", each must exceed the tol) kernel launches gpu={n_gpu} cpu={n_cpu} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("GPU material path disagrees with the CPU reference path")


_UNREAD_PARAMS = {"shader.light_power", "shader.surface_lf.output_rgba_layer.weight",
                  "shader.surface_lf.output_rgba_layer.bias"}


def phase_train(torch, device, seed, steps, smi, profile):
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    config = flagship.cache_config()
    t0 = time.perf_counter()
    torch.manual_seed(seed)
    model = flagship.build_flagship_cache_model(config, device=device)
    dataset = datasets.SyntheticSpheres("train", None, config, num_images=8, resolution=128,
                                        device=device)
    state, _ = train.create_optimizer(config, model)
    train_step = train.create_train_step(model, config)
    rng = torch.Generator(device=device).manual_seed(seed + 42)
    # Batches made ahead, so data loading is off the timed path.
    batches = [dataset.next_train() for _ in range(8)]
    n_params = sum(p.numel() for p in model.parameters())
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    setup_s = time.perf_counter() - t0

    warmup = 3
    losses = []
    scatter_cuda.reset_launch_count()
    for i in range(warmup):
        state, stats = train_step(rng, state, batches[i % len(batches)], 0.5)
        losses.append(stats["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        state, stats = train_step(rng, state, batches[(warmup + i) % len(batches)], 0.5)
        losses.append(stats["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launches = dict(scatter_cuda.launches)

    losses = [float(v) for v in losses]
    finite = all(map(lambda v: v == v and abs(v) != float("inf"), losses))
    unchanged = {k for k, v in model.state_dict().items() if torch.equal(v, before[k])}
    changed = len(before) - len(unchanged)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # The passive shader reads neither the light power nor the SLF's rgba
    # head: those three, and only those, keep their initial values.
    ok = (finite and unchanged == _UNREAD_PARAMS
          and launches == _launch_counts(leveled=warmup + steps))
    print(f"train: flagship cache model ({n_params} params) batch {config.batch_size} "
          f"SyntheticSpheres 8x128^2 setup {setup_s:.1f}s; {warmup} warmup + {steps} timed "
          f"steps: step_ms={dt * 1e3:.2f} rays_per_s={config.batch_size / dt:.0f} on [{smi}]; "
          f"losses finite={finite} first={losses[0]:.5f} last={losses[-1]:.5f}; "
          f"{changed}/{len(before)} param tensors changed, unchanged={sorted(unchanged)}; "
          f"scatter launches={launches} "
          f"(expected leveled {warmup + steps}, planes 0); peak {peak_gib:.2f} GiB "
          f"{'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("train phase failed")
    if profile:
        _profile(torch, train_step, state, rng, batches, profile)
    return launches["leveled"], dt


def _checking_scatter(kind, calls, capture=None):
    """The `kind` scatter wrapper, with its plain version run on the same
    inputs after each call and held to SUM_ORDER_TOL x sum|w * ct|; each
    call is appended to `calls` (a leveled call with skip_zero_w as kind
    "leveled_skip"). With `capture`, the first call's inputs are kept there."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    real = getattr(scatter_cuda, f"scatter_add_weighted_{kind}")
    plain = getattr(scatter_cuda, f"scatter_add_weighted_{kind}_plain")

    def scatter(idx, w, ct, **kw):
        if capture is not None and not capture:
            capture.update(idx=idx, w=w, ct=ct, **kw)
        out = real(idx, w, ct, **kw)
        want = plain(idx, w, ct, **kw)
        bound_kw = {k: v for k, v in kw.items() if k not in ("num_rows", "corners", "features")}
        limit = SUM_ORDER_TOL * _abs_sum_bound(idx, w, ct, kw["num_rows"], kw["corners"],
                                               plain=plain, **bound_kw) + 1e-30
        err = (out - want).abs()
        calls.append(dict(kind=kind + ("_skip" if kw.get("skip_zero_w") else ""),
                          shape=tuple(idx.shape), max_abs_err=float(err.max()),
                          ok=bool((err <= limit).all())))
        return out

    return scatter


def phase_kernel_path(kind, capture, sizes, label):
    """The `kind` kernel on the updates a train step gave it (captured by
    _checking_scatter) against one index_add_ of the same update rows, in
    turns, over all levels and on each level's slice alone; the plain
    version's time, the bound, and the host time of one call of kernel and
    library."""
    import torch

    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    idx, w, ct = capture["idx"], capture["w"], capture["ct"]
    kw = {k: capture[k] for k in ("num_rows", "features", "corners")}
    times = _kernel_vs_library(kind, idx, w, ct, kw)
    per_level = _per_level_ms(kind, idx, w, ct, kw)
    kernel = getattr(scatter_cuda, f"scatter_add_weighted_{kind}")
    host = {"kernel": _host_ms(torch, lambda: kernel(idx, w, ct, **kw)),
            "library": _host_ms(torch, _index_add_call(
                idx, _update_rows(kind, w, ct, kw["corners"]), kw["num_rows"]))}
    plain = getattr(scatter_cuda, f"scatter_add_weighted_{kind}_plain")
    plain_ms = _cuda_ms(lambda: plain(idx, w, ct, **kw))
    n = idx.numel()
    bound_ms, bound_by = _bound(4 * (2 * n + ct.numel() + idx.shape[0] * kw["num_rows"]
                                     * kw["features"]), 2 * n * kw["features"])
    print(f"kernel ({kind}, path): scatter_add_weighted_{kind} on the {label}, idx"
          f"{list(idx.shape)} F={kw['features']} rows={kw['num_rows']}: kernel_ms="
          f"{times['kernel']:.4f} library_ms(index_add_ of w*ct rows)={times['library']:.4f} "
          f"ratio={times['kernel'] / times['library']:.3f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}); each level's slice alone, "
          f"kernel/library ms: {_levels_text(per_level, sizes)} (medians of 11 in 2 alternating "
          f"turns, CUDA events); host time of one call (no sync): kernel {host['kernel']:.4f} "
          f"ms, library {host['library']:.4f} ms", flush=True)
    return dict(path_ms=times["kernel"], path_library_ms=times["library"],
                path_plain_ms=plain_ms, path_bound_ms=bound_ms,
                path_host_ms=host["kernel"], path_library_host_ms=host["library"],
                path_per_level_ms=[t["kernel"] for t in per_level],
                path_per_level_library_ms=[t["library"] for t in per_level])


def phase_material_check(torch, train_step, state, rng, batch, capture=None):
    """One material train step with every scatter the path launches held
    against its plain version on the same inputs, at the path's shapes; with
    `capture`, the planes call's inputs are kept there."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    calls = []
    with _patched(scatter_cuda,
                  scatter_add_weighted_leveled=_checking_scatter("leveled", calls),
                  scatter_add_weighted_planes=_checking_scatter("planes", calls, capture)):
        state, stats = train_step(rng, state, batch, 0.5)
    torch.cuda.synchronize()
    per_kind = {k: sum(c["kind"] == k for c in calls) for k in _MATERIAL_LAUNCHES_PER_STEP}
    ok = (per_kind == _MATERIAL_LAUNCHES_PER_STEP and all(c["ok"] for c in calls)
          and bool(torch.isfinite(stats["loss"])))
    print("material train (checked step): each scatter of one step against its plain version "
          f"on the same inputs, tol=|err|<={SUM_ORDER_TOL}*sum|w*ct|: "
          + "; ".join(f"{c['kind']} idx{list(c['shape'])} max_abs_err={c['max_abs_err']:.3e} "
                      f"{'ok' if c['ok'] else 'FAIL'}" for c in calls)
          + f" (calls {per_kind}, expected {_MATERIAL_LAUNCHES_PER_STEP}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version on the material path")
    return state, {k: max(c["max_abs_err"] for c in calls if c["kind"] == k)
                   for k, n in per_kind.items() if n}


def phase_material_train(torch, device, seed, steps, smi, profile):
    """The full-width flagship material model: one checked step, whose planes
    inputs time the planes kernel, then timed steps with gradient
    checkpointing (the JAX setting), then one step without it."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    config = flagship.material_config()
    t0 = time.perf_counter()
    torch.manual_seed(seed)
    model = flagship.build_flagship_material_model(config, device=device)
    dataset = datasets.SyntheticSpheres("train", None, config, num_images=8, resolution=128,
                                        device=device)
    state, _ = train.create_optimizer(config, model)
    train_step = train.create_train_step(model, config)
    rng = torch.Generator(device=device).manual_seed(seed + 43)
    batches = [dataset.next_train() for _ in range(8)]
    n_params = sum(p.numel() for p in model.parameters())
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    setup_s = time.perf_counter() - t0
    capture = {}
    state, checked_err = phase_material_check(torch, train_step, state, rng, batches[-1], capture)
    # Timed before the train steps, and dropped, so that the peak memory
    # below is the steps' own.
    planes_path = phase_kernel_path(
        "planes", capture, MATERIAL_LEVELS,
        "material path's own updates (secondary samples of one checked step)")
    del capture

    warmup = 3
    losses = []
    torch.cuda.reset_peak_memory_stats()
    scatter_cuda.reset_launch_count()
    for i in range(warmup):
        state, stats = train_step(rng, state, batches[i % len(batches)], 0.5)
        losses.append(stats["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        state, stats = train_step(rng, state, batches[(warmup + i) % len(batches)], 0.5)
        losses.append(stats["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launches = dict(scatter_cuda.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    unchanged = {k for k, v in model.state_dict().items() if torch.equal(v, before[k])}

    # One more step without checkpointing: its peak memory.
    config.gradient_checkpointing = False
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    state, stats = train_step(rng, state, batches[0], 0.5)
    losses.append(stats["loss"])
    torch.cuda.synchronize()
    nockpt_s = time.perf_counter() - t1
    nockpt_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    config.gradient_checkpointing = True

    losses = [float(v) for v in losses]
    finite = all(map(lambda v: v == v and abs(v) != float("inf"), losses))
    per_step = {k: n * (warmup + steps) for k, n in _MATERIAL_LAUNCHES_PER_STEP.items()}
    ok = finite and unchanged == _MATERIAL_UNREACHED and launches == per_step
    print(f"material train: flagship material model ({n_params} params) batch "
          f"{config.batch_size} x 32 secondary rays x 64+64+32 samples, SyntheticSpheres 8x128^2, "
          f"setup {setup_s:.1f}s; {warmup} warmup + {steps} timed steps with gradient "
          f"checkpointing: step_ms={dt * 1e3:.2f} rays_per_s={config.batch_size / dt:.1f} "
          f"peak {peak_gib:.2f} GiB; one step without checkpointing: {nockpt_s * 1e3:.1f} ms, "
          f"peak {nockpt_peak_gib:.2f} GiB; on [{smi}]; losses finite={finite} "
          f"first={losses[0]:.5f} last={losses[-1]:.5f}; {len(before) - len(unchanged)}/"
          f"{len(before)} param tensors changed, unchanged={sorted(unchanged)} "
          f"(expected the {len(_MATERIAL_UNREACHED)} no loss reaches); scatter launches="
          f"{launches} (expected {per_step}: {_MATERIAL_LAUNCHES_PER_STEP} per step) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("material train phase failed")
    if profile:
        path = str(profile)
        stem, dot, ext = path.rpartition(".")
        _profile(torch, train_step, state, rng, batches,
                 f"{stem}.material.{ext}" if dot else path + ".material", steps=2)
    return launches, dt, checked_err, planes_path


def _primary_sample_points(torch, device, gen, num_rays, samples_per_ray):
    """Grid coordinates of samples along camera rays as the cache stage takes
    them: cameras on the sphere of radius 4, rays toward the scene, sorted
    depths between near 2 and far 6, warped by the flagship's contraction."""
    from neural_radiance_caching_tpu_torch.ops import coord

    c = torch.randn((num_rays, 3), generator=gen, device=device)
    origins = 4.0 * c / c.norm(dim=-1, keepdim=True)
    d = -origins / 4.0 + 0.3 * torch.randn((num_rays, 3), generator=gen, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    t, _ = torch.sort(2.0 + 4.0 * torch.rand((num_rays, samples_per_ray), generator=gen,
                                             device=device), dim=-1)
    return (coord.contract_radius_2(origins[:, None] + t[..., None] * d[:, None]) + 2.0) / 4.0


def phase_kernel_rows(torch, device, seed):
    """The row scatter on the run-deduplicated update stream of the flagship
    cache shape (8192 camera rays x 32 samples, 6 levels x 4 taps), one row
    per update, as the dedup stream feeds the skip kernel; and on the same
    updates before the dedup scan (w * ct per tap)."""
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda

    levels, points, corners, features, num_rows = 6, 262144, 4, 4, 524288
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    x = _primary_sample_points(torch, device, gen, 8192, 32).reshape(-1, 3)
    taps, weights = hashgrid._tap_rows_and_weights(x, None, MATERIAL_LEVELS, num_rows, 3,
                                                   "simplex")
    idx = taps.permute(1, 0, 2).reshape(levels, -1).contiguous()
    w = weights.permute(1, 0, 2).reshape(levels, -1).contiguous()
    del x, taps, weights
    ct = torch.randn((levels, points, features), generator=gen, device=device)
    keep, upd = hashgrid.dedup_runs(idx, w, ct, corners=corners)
    g = (keep[..., None] * upd).contiguous()  # [6, 1,048,576, 4]: one row per update
    raw = _update_rows("leveled", w, ct, corners).contiguous()  # the same, not dedup'd
    kw = dict(num_rows=num_rows, features=features)
    skip_kw = dict(kw, corners=1, skip_zero_w=True)
    ragged = 1_000_003
    rows_kernel = scatter_cuda.scatter_add_rows_leveled
    plain = scatter_cuda.scatter_add_rows_leveled_plain

    before = scatter_cuda.launches["rows"]
    got = rows_kernel(idx, g, **kw)
    got_p = scatter_cuda.scatter_add_rows_padded(idx[0, :ragged], g[0, :ragged], **kw)
    launched = scatter_cuda.launches["rows"] - before
    got_raw = rows_kernel(idx, raw, **kw)
    want = plain(idx, g, **kw)
    limit = SUM_ORDER_TOL * plain(idx, g.abs(), **kw) + 1e-30
    want_p = plain(idx[:1, :ragged], g[:1, :ragged], **kw)[0]
    want_raw = plain(idx, raw, **kw)
    raw_limit = SUM_ORDER_TOL * plain(idx, raw.abs(), **kw) + 1e-30
    skip = scatter_cuda.scatter_add_weighted_leveled(idx, keep, upd, **skip_kw)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    raw_abs = float((got_raw - want_raw).abs().max())
    ok = (launched == 2 and bool(((got - want).abs() <= limit).all())
          and bool(((got_p - want_p).abs() <= limit[0]).all())
          and bool(((skip - got).abs() <= 2 * limit).all())
          and bool(((got_raw - want_raw).abs() <= raw_limit).all()))
    share = 1.0 - float(keep.mean())
    del got, got_p, got_raw, want, want_p, want_raw, limit, raw_limit, skip
    ms = _cuda_ms(lambda: rows_kernel(idx, g, **kw))
    plain_ms = _cuda_ms(lambda: plain(idx, g, **kw))
    library_ms = _cuda_ms(_index_add_call(idx, g, num_rows))
    skip_ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled(idx, keep, upd, **skip_kw))
    undedup = _alternating_ms({"kernel": lambda: rows_kernel(idx, raw, **kw),
                               "library": _index_add_call(idx, raw, num_rows)})
    host = {"kernel": _host_ms(torch, lambda: rows_kernel(idx, g, **kw)),
            "library": _host_ms(torch, _index_add_call(idx, g, num_rows))}
    n = levels * points * corners
    # Both streams have one row per update: the same bytes.
    bound_ms, bound_by = _bound(4 * (n + n * features + levels * num_rows * features),
                                n * features)
    print(f"kernel (rows): scatter_add_rows_leveled L={levels} N={n // levels} F={features} "
          f"rows={num_rows} (dedup'd stream of 8192 camera rays x 32 samples: {share:.1%} of "
          f"rows zero) max_abs_err={max_abs:.3e} tol=|err|<={SUM_ORDER_TOL}*sum|g|; "
          f"scatter_add_rows_padded at N={ragged} same tol; the skip kernel on the same "
          f"stream agrees; the same updates before the dedup scan (w*ct per tap) "
          f"max_abs_err={raw_abs:.3e} same tol; launches={launched} {'ok' if ok else 'FAIL'}; "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms(index_add_)={library_ms:.4f} "
          f"ratio={ms / library_ms:.3f} skip_same_stream_ms={skip_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) (median of 11, CUDA events); before the "
          f"dedup scan: kernel_ms={undedup['kernel']:.4f} library_ms={undedup['library']:.4f} "
          f"ratio={undedup['kernel'] / undedup['library']:.3f} (medians of 11 in 2 alternating "
          f"turns); host time of one call (no sync): kernel {host['kernel']:.4f} ms, library "
          f"{host['library']:.4f} ms", flush=True)
    if not ok:
        raise AssertionError("the row scatter disagrees with its plain version")
    return dict(launches=launched, max_abs_err=max(max_abs, raw_abs), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                skip_same_stream_ms=skip_ms, undedup_ms=undedup["kernel"],
                undedup_library_ms=undedup["library"], host_ms=host["kernel"],
                library_host_ms=host["library"])


# The transient reference: 64 bins of 0.25 cover the scene's two-bounce path
# lengths (up to ~11 units) at a narrow width.
TRANSIENT_REF_BATCH = 256
TRANSIENT_REF_BINS = 64
# Transient-model gradients are held per leaf, each hash table split into
# its levels, in relative L2 norm, between the same two readings as the
# cache's: the noise floor below the limit, the planted faults above it.
TRANSIENT_GRAD_REL_L2_TOL = 5e-2
# No loss reaches these parameters of the transient cache model: its
# ambient term is off (use_ambient=False), so neither the shader's ambient
# irradiance head nor the SLF's ambient head is read.
# tests/test_torch_transient_slice.py pins the same set against the JAX
# package's zero gradients.
_TRANSIENT_UNREACHED = {
    "shader.ambient_irradiance_layer.weight", "shader.ambient_irradiance_layer.bias",
    "shader.surface_lf.output_ambient_rgb_layer.weight",
    "shader.surface_lf.output_ambient_rgb_layer.bias",
}


def _narrow_transient(scatter_dedup):
    """The flagship transient structure at reference-phase widths."""
    from neural_radiance_caching_tpu_torch import flagship

    params = _narrow(flagship.flagship_transient_cache_params(scatter_dedup))
    params["shader_params"].update(net_width_irradiance=32, net_width_brdf=32,
                                   net_width_integrated_brdf=32)
    return params


def _transient_ref_config():
    from neural_radiance_caching_tpu_torch import flagship

    return flagship.transient_config(batch_size=TRANSIENT_REF_BATCH, n_bins=TRANSIENT_REF_BINS,
                                     exposure_time=0.25, lr_delay_steps=0)


def _transient_step(torch, device, seed, batch, scatter_dedup, fault=None):
    """One train step of the narrow transient model on `device`; the random
    draws come from a CPU generator, so both devices see the same numbers."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    cfg = _transient_ref_config()
    torch.manual_seed(seed)
    model = flagship.build_flagship_transient_cache_model(
        cfg, _narrow_transient(scatter_dedup), device=device)
    state, _ = train.create_optimizer(cfg, model)
    before = dict(scatter_cuda.launches)
    patch = dict(scatter_add_weighted_leveled=_planted_fault(fault)) if fault else {}
    with _patched(scatter_cuda, **patch):
        rng = torch.Generator().manual_seed(seed + 6)
        _, stats = train.create_train_step(model, cfg)(rng, state, batch.to(device), 0.5)
    losses = {k: float(torch.as_tensor(v).detach()) for k, v in stats["losses"].items()}
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    return losses, grads, {k: scatter_cuda.launches[k] - before[k] for k in before}


def phase_transient_reference(torch, device, seed):
    """Same narrow transient model, batch and draws on the GPU and the CPU,
    with the direct and with the run-dedup table-gradient scatter."""
    from neural_radiance_caching_tpu_torch.data import datasets

    batch = datasets.SyntheticSpheres("train", None, _transient_ref_config(), num_images=4,
                                      resolution=32, device="cpu").next_train()
    origins = batch.rays.origins
    nudged = batch.replace(rays=batch.rays.replace(
        origins=torch.nextafter(origins, torch.full_like(origins, float("inf")))))
    tol = TRANSIENT_GRAD_REL_L2_TOL
    gpu_grads = {}
    for dedup in (False, True):
        kind = "leveled_skip" if dedup else "leveled"
        l_cpu, g_cpu, n_cpu = _transient_step(torch, "cpu", seed, batch, dedup)
        reached = [k for k in g_cpu if k not in _TRANSIENT_UNREACHED]
        floor, floor_at = _worst_grad_err(
            _transient_step(torch, "cpu", seed, nudged, dedup)[1], g_cpu, reached)
        l_gpu, g_gpu, n_gpu = _transient_step(torch, device, seed, batch, dedup)
        loss_err = max(abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu)
        err, err_at = _worst_grad_err(g_gpu, g_cpu, reached)
        faults = {f: _worst_grad_err(_transient_step(torch, device, seed, batch, dedup, f)[1],
                                     g_cpu, reached)
                  for f in ("taps rotated", "finest level dropped")}
        finite = all(torch.isfinite(g).all() for g in g_gpu.values())
        ok = (finite and loss_err <= 1e-4 and n_cpu == _launch_counts()
              and n_gpu == _launch_counts(**{kind: 1}) and floor <= tol and err <= tol
              and all(v > tol for v, _ in faults.values()))
        print(f"transient reference ({'scatter_dedup' if dedup else 'direct scatter'}): narrow "
              f"transient cache model, batch {TRANSIENT_REF_BATCH} x {TRANSIENT_REF_BINS} bins, "
              f"same draws, gpu vs cpu: loss rel_err={loss_err:.3e} (tol 1e-4) grad rel_l2_err "
              f"max={err:.3e} at {err_at} (tol {tol}; noise floor, cpu vs cpu with origins "
              f"+1 ulp: {floor:.3e} at {floor_at}; planted in the {kind} kernel "
              + ", ".join(f"{f}: {v:.3e} at {at}" for f, (v, at) in faults.items())
              + f", each must exceed the tol) kernel launches gpu={n_gpu} cpu={n_cpu} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("GPU transient path disagrees with the CPU reference path")
        gpu_grads[dedup] = g_gpu
    # Dedup and direct table gradients on the card: the same updates summed
    # in another order, held per level to 1e-5 of the level's largest entry.
    dedup_g, direct_g = _per_level(gpu_grads[True]), _per_level(gpu_grads[False])
    errs = {k: float((dedup_g[k] - direct_g[k]).abs().max()) / float(direct_g[k].abs().max())
            for k in direct_g if ".grid." in k and float(direct_g[k].abs().max()) > 0}
    worst = max(errs, key=errs.get)
    ok = errs[worst] <= 1e-5
    print(f"transient reference (dedup vs direct on the card): table gradients per level, "
          f"max |dedup - direct| / max |direct| = {errs[worst]:.3e} at {worst} (tol 1e-5, "
          f"float32 association order) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("dedup and direct table gradients disagree on the card")


# The per-sample transients of a flagship transient step: rays, samples,
# bins, channels.
TRANSIENT_SHAPE = (2048, 32, 700, 3)


def _time_shift_forms(torch, device, seed):
    """One forward + backward of the transient rendering at the flagship
    shape TRANSIENT_SHAPE for each shift form; the spectral forms held to
    the gather form at 1e-4 of its largest entry."""
    from neural_radiance_caching_tpu_torch.ops import render

    r, s, b, c = TRANSIENT_SHAPE
    gen = torch.Generator(device=device).manual_seed(seed + 11)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    ti = (rand(r, s, b, c) * 0.01).requires_grad_()
    w = rand(r, s) / s
    tdist = torch.sort(2.0 + 4.0 * rand(r, s + 1), dim=-1).values
    extras = {"ray_dists": 2.0 + 4.0 * rand(r, s, 1), "light_dists": 1.0 + 3.0 * rand(r, s, 1)}
    direct = rand(r, s, c)

    def run(form):
        ti.grad = None
        out = render.volumetric_transient_rendering(
            direct, ti, w, w, tdist, 0.0, False, extras=dict(extras, transient_indirect=ti),
            n_bins=b, exposure_time=0.02, shift_form=form)
        out["rgb"].sum().backward()
        return out["rgb"].detach()

    ref = run("gather")
    scale = float(ref.abs().max())
    out = {}
    for form in render.SHIFT_FORMS:
        err = float((run(form) - ref).abs().max()) / scale
        torch.cuda.reset_peak_memory_stats()
        ms = _cuda_ms(lambda f=form: run(f), repeats=5, warmup=1)
        out[form] = dict(ms=ms, rel_err=err, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    ok = all(v["rel_err"] <= 1e-4 for v in out.values())
    return out, ok


def phase_transient_train(torch, device, seed, steps, smi, profile):
    """The full-width flagship transient cache model with the direct backward
    and with scatter_dedup: a checked step each, then 3 warmup and `steps`
    timed steps each, in alternating blocks (direct, dedup, dedup, direct)."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    config = flagship.transient_config()
    t0 = time.perf_counter()
    dataset = datasets.SyntheticSpheres("train", None, config, num_images=4, resolution=64,
                                        device=device)
    batches = [dataset.next_train() for _ in range(8)]
    rng = torch.Generator(device=device).manual_seed(seed + 44)
    runs = {}
    for name, dedup in (("direct", False), ("dedup", True)):
        torch.manual_seed(seed)
        model = flagship.build_flagship_transient_cache_model(
            config, flagship.flagship_transient_cache_params(scatter_dedup=dedup), device=device)
        state, _ = train.create_optimizer(config, model)
        runs[name] = dict(model=model, state=state, step=train.create_train_step(model, config),
                          before={k: v.detach().clone() for k, v in model.state_dict().items()},
                          kind="leveled_skip" if dedup else "leveled", losses=[], times=[],
                          peak=0.0, blocks=[])
    n_params = sum(p.numel() for p in runs["direct"]["model"].parameters())
    setup_s = time.perf_counter() - t0

    # One checked step each: every scatter call of the step against its
    # plain version on the same inputs; the direct step's update stream is
    # kept for the skip-kernel phase.
    capture, checked = {}, {}
    for name, run in runs.items():
        calls = []
        with _patched(scatter_cuda, scatter_add_weighted_leveled=_checking_scatter(
                "leveled", calls, capture if name == "direct" else None)):
            run["state"], stats = run["step"](rng, run["state"], batches[-1], 0.5)
        run["losses"].append(stats["loss"])
        checked[name] = calls
    torch.cuda.synchronize()
    ok = all([c["kind"] for c in checked[n]] == [runs[n]["kind"]] and checked[n][0]["ok"]
             for n in runs)
    print("transient train (checked steps): each scatter of one step against its plain version "
          f"on the same inputs, tol=|err|<={SUM_ORDER_TOL}*sum|w*ct|: "
          + "; ".join(f"{n}: {c['kind']} idx{list(c['shape'])} max_abs_err="
                      f"{c['max_abs_err']:.3e} {'ok' if c['ok'] else 'FAIL'}"
                      for n, calls in checked.items() for c in calls)
          + f" (expected one leveled call without dedup, one leveled_skip with it) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version on the transient path")

    warmup = 3
    for run in runs.values():
        for i in range(warmup):
            run["state"], stats = run["step"](rng, run["state"], batches[i % len(batches)], 0.5)
            run["losses"].append(stats["loss"])
    torch.cuda.synchronize()
    block = max(1, steps // 2)
    for bi, name in enumerate(("direct", "dedup", "dedup", "direct")):
        run = runs[name]
        torch.cuda.reset_peak_memory_stats()
        scatter_cuda.reset_launch_count()
        t0 = time.perf_counter()
        for i in range(block):
            run["state"], stats = run["step"](rng, run["state"],
                                              batches[(bi * block + i) % len(batches)], 0.5)
            run["losses"].append(stats["loss"])
        torch.cuda.synchronize()
        run["times"].append((time.perf_counter() - t0) / block)
        run["blocks"].append(dict(scatter_cuda.launches))
        run["peak"] = max(run["peak"], torch.cuda.max_memory_allocated() / 2**30)

    result = {}
    all_ok = True
    for name, run in runs.items():
        losses = [float(v) for v in run["losses"]]
        finite = all(v == v and abs(v) != float("inf") for v in losses)
        unchanged = {k for k, v in run["model"].state_dict().items()
                     if torch.equal(v, run["before"][k])}
        pinned = _launch_counts(**{run["kind"]: block})
        ok = finite and unchanged == _TRANSIENT_UNREACHED and all(
            b == pinned for b in run["blocks"])
        all_ok &= ok
        dt = statistics.mean(run["times"])
        result[name] = dict(launches=sum(b[run["kind"]] for b in run["blocks"]), step_ms=dt * 1e3,
                            rays_per_s=config.batch_size / dt, peak_gib=run["peak"],
                            max_abs_err=checked[name][0]["max_abs_err"])
        print(f"transient train ({name}{', scatter_dedup' if name == 'dedup' else ''}): flagship "
              f"transient cache model ({n_params} params) batch {config.batch_size} x "
              f"{config.n_bins} bins, SyntheticSpheres 4x64^2, setup {setup_s:.1f}s; {warmup} "
              f"warmup + {2 * block} timed steps in 2 blocks alternating with the other run: "
              f"step_ms={dt * 1e3:.2f} (blocks {', '.join(f'{t * 1e3:.2f}' for t in run['times'])})"
              f" rays_per_s={config.batch_size / dt:.1f} peak {run['peak']:.2f} GiB on [{smi}]; "
              f"losses finite={finite} first={losses[0]:.5f} last={losses[-1]:.5f}; "
              f"{len(run['before']) - len(unchanged)}/{len(run['before'])} param tensors changed, "
              f"unchanged={sorted(unchanged)} (expected the {len(_TRANSIENT_UNREACHED)} no loss "
              f"reaches); scatter launches per block={run['blocks']} (expected {pinned}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    if not all_ok:
        raise AssertionError("transient train phase failed")

    forms, ok = _time_shift_forms(torch, device, seed)
    print("transient shift forms: one forward + backward of volumetric_transient_rendering at "
          f"{list(TRANSIENT_SHAPE)}: " + "; ".join(
              f"{f} {v['ms']:.2f} ms (peak {v['peak_gib']:.2f} GiB, rel_err vs gather "
              f"{v['rel_err']:.2e})" for f, v in forms.items())
          + f" (median of 5, CUDA events; tol 1e-4) on [{smi}] {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("the transient shift forms disagree")
    result["shift_forms"] = forms
    if profile:
        path = str(profile)
        stem, dot, ext = path.rpartition(".")
        run = runs["direct"]
        _profile(torch, run["step"], run["state"], rng, batches,
                 f"{stem}.transient.{ext}" if dot else path + ".transient", steps=2)
    return result, capture


def phase_kernel_skip(torch, device, capture):
    """The skip-zero-weight instance on the dedup'd stream of the transient
    path's own updates (6 levels x 2048 rays x 32 samples x 4 taps), against
    its plain version, with NaN rows planted under the zero weights; both
    scatter routes (dedup prep + skip kernel, direct kernel) timed."""
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda

    idx, w, ct = capture["idx"], capture["w"], capture["ct"]
    num_rows, features, corners = capture["num_rows"], capture["features"], capture["corners"]
    levels, n = idx.shape
    keep, rows = hashgrid.dedup_runs(idx, w, ct, corners=corners)
    kept = int(keep.sum())
    share = 1.0 - kept / keep.numel()
    nan_rows = torch.where(keep[..., None] == 0, torch.full_like(rows, float("nan")), rows)
    kw = dict(num_rows=num_rows, features=features, corners=1, skip_zero_w=True)
    direct_kw = dict(num_rows=num_rows, features=features, corners=corners)
    got = scatter_cuda.scatter_add_weighted_leveled(idx, keep, nan_rows, **kw)
    want = scatter_cuda.scatter_add_weighted_leveled_plain(idx, keep, nan_rows, **kw)
    direct = scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, **direct_kw)
    limit = SUM_ORDER_TOL * _abs_sum_bound(idx, keep, rows, num_rows, 1, skip_zero_w=True) + 1e-30
    direct_limit = SUM_ORDER_TOL * _abs_sum_bound(idx, w, ct, num_rows, corners) + 1e-30
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got).all())
    max_abs = float((got - want).abs().max())
    ok = (finite and bool(((got - want).abs() <= limit).all())
          and bool(((got - direct).abs() <= direct_limit).all()))
    dedup_err = float((got - direct).abs().max())
    del got, want, direct, nan_rows, limit, direct_limit

    ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled(idx, keep, rows, **kw))
    plain_ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled_plain(
        idx, keep, rows, **kw))
    offsets = torch.arange(levels, device=idx.device, dtype=torch.int64)[:, None] * num_rows
    kept_mask = keep != 0
    kept_idx = (idx.to(torch.int64) + offsets)[kept_mask]
    kept_rows = rows[kept_mask].contiguous()
    library_ms = _cuda_ms(lambda: torch.zeros(levels * num_rows, features, device=device)
                          .index_add_(0, kept_idx, kept_rows))
    dedup_route_ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled(
        idx, *hashgrid.dedup_runs(idx, w, ct, corners=corners), **kw))
    direct_ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, **direct_kw))
    bound_ms, bound_by = _bound(4 * (levels * n + kept * (1 + features)
                                     + levels * num_rows * features), 2 * kept * features)
    print(f"kernel (skip): scatter_add_weighted_leveled(skip_zero_w=True) on the dedup'd stream "
          f"of the transient path's updates, idx{list(idx.shape)} F={features} rows={num_rows}: "
          f"{share:.1%} of updates have weight 0 ({kept} kept); NaN rows planted under them, "
          f"output finite={finite}; max_abs_err vs plain={max_abs:.3e} "
          f"(tol=|err|<={SUM_ORDER_TOL}*sum|w*row|), vs the direct kernel {dedup_err:.3e} "
          f"(tol {SUM_ORDER_TOL}*sum|w*ct|) {'ok' if ok else 'FAIL'}; kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms(index_add_ of the kept rows)={library_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}); routes: dedup prep + skip kernel "
          f"{dedup_route_ms:.4f} ms vs direct kernel {direct_ms:.4f} ms (median of 11, CUDA "
          f"events)", flush=True)
    if not ok:
        raise AssertionError("the skip kernel disagrees with its plain version")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, zero_weight_share=share,
                dedup_route_ms=dedup_route_ms, direct_route_ms=direct_ms,
                direct_max_abs_err=dedup_err)


# The eval reference: a held-out 16^2 view in chunks of 96 rays (96, 96, 64:
# a ragged last chunk), 2 repeats per chunk.
EVAL_REF_RES = 16
EVAL_REF_CHUNK = 96
EVAL_REF_REPEATS = 2
# Eval outputs are held per key (rgb, acc, the distance statistics, every
# extra, the rgb variance) in relative L2 norm over the view. Each limit sits
# between the two readings the phase takes in every run: the noise floor (the
# CPU path against itself with the ray origins moved by one float32 ulp) below
# it, and two encoder faults planted in the GPU forward above it. The
# material model's outputs average secondary rays, whose directions a
# rounding error in a normal turns, so its floor and limit are higher.
EVAL_REL_L2_TOL = {"cache": 2e-2, "material": 0.2, "transient": 2e-2}


def _eval_ref_model(torch, kind, seed, device):
    """(config, model) of the narrow `kind` model of phases 7-9, every
    parameter drawn from U(-0.5, 0.5) by a CPU generator, then moved: the
    builders' initial hash tables are near zero, so an encoder fault would
    not show in their renders."""
    from neural_radiance_caching_tpu_torch import flagship

    chunk = dict(render_chunk_size=EVAL_REF_CHUNK)
    if kind == "cache":
        cfg = flagship.cache_config(**chunk)
        model = flagship.build_flagship_cache_model(
            cfg, _narrow(flagship.flagship_cache_params()), device="cpu")
    elif kind == "material":
        cfg = flagship.material_config(**chunk)
        model = flagship.build_flagship_material_model(cfg, _narrow_material(), device="cpu")
    else:
        cfg = _transient_ref_config()
        cfg.render_chunk_size = EVAL_REF_CHUNK
        model = flagship.build_flagship_transient_cache_model(cfg, _narrow_transient(False),
                                                              device="cpu")
    gen = torch.Generator().manual_seed(seed + 12)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.rand(p.shape, generator=gen) - 0.5)
    return cfg, model.to(device)


def _planted_encoder_fault(fault):
    """The hash-grid encoder forward with a deliberate fault, for the eval
    reference's check that its limits would catch one."""
    from neural_radiance_caching_tpu_torch.ops import hashgrid

    real = hashgrid.multires_grid_encode

    def encode(x, hash_tables, dense_pool, **kw):
        f = real(x, hash_tables, dense_pool, **kw)
        width = f.shape[-1] // len(kw["grid_sizes"])
        if fault == "finest level dropped":
            keep = f.new_ones(f.shape[-1])
            keep[-width:] = 0.0
            return f * keep
        return f.unflatten(-1, (-1, width)).flip(-2).flatten(-2)  # "levels reversed"

    return encode


def _eval_render(torch, kind, seed, device, view, fault=None):
    """The held-out view rendered by the narrow `kind` model on `device`
    through create_render_fn + render_image, the draws from a CPU generator
    (the same numbers on both devices); returns (images, launches)."""
    from neural_radiance_caching_tpu_torch.engine import renderer
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    cfg, model = _eval_ref_model(torch, kind, seed, device)
    patch = dict(multires_grid_encode=_planted_encoder_fault(fault)) if fault else {}
    before = dict(scatter_cuda.launches)
    with _patched(hashgrid, **patch):
        images = renderer.render_image(
            train.create_render_fn(model), view.rays.to(device),
            torch.Generator().manual_seed(seed + 13), cfg, height=EVAL_REF_RES,
            width=EVAL_REF_RES, render_repeats=EVAL_REF_REPEATS, device=device)
    return images, {k: scatter_cuda.launches[k] - before[k] for k in before}


def _worst_output_err(images, ref):
    """(worst relative L2 error over the outputs, its key); an output that is
    zero in `ref` is held in absolute L2."""
    import numpy as np

    errs = {}
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        d = float(np.linalg.norm(np.asarray(images[k], np.float64) - r))
        scale = float(np.linalg.norm(r))
        errs[k] = d / scale if scale > 0 else d
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def phase_eval_reference(torch, device, seed):
    """The narrow cache, material and transient models of phases 7-9, the
    same weights and draws on the GPU and the CPU, each rendering a held-out
    view through create_render_fn + render_image with a ragged last chunk
    and 2 repeats; every output compared, no scatter launched."""
    from neural_radiance_caching_tpu_torch.data import datasets

    for kind in ("cache", "material", "transient"):
        cfg, _ = _eval_ref_model(torch, kind, seed, "cpu")
        view = datasets.SyntheticSpheres("test", None, cfg, num_images=2, resolution=EVAL_REF_RES,
                                         device="cpu").generate_ray_batch(0)
        origins = view.rays.origins
        nudged = view.replace(rays=view.rays.replace(
            origins=torch.nextafter(origins, torch.full_like(origins, float("inf")))))
        ref, n_cpu = _eval_render(torch, kind, seed, "cpu", view)
        floor, floor_at = _worst_output_err(_eval_render(torch, kind, seed, "cpu", nudged)[0], ref)
        images, n_gpu = _eval_render(torch, kind, seed, device, view)
        err, err_at = _worst_output_err(images, ref)
        faults = {f: _worst_output_err(_eval_render(torch, kind, seed, device, view, f)[0], ref)
                  for f in ("finest level dropped", "levels reversed")}
        tol = EVAL_REL_L2_TOL[kind]
        ok = (sorted(images) == sorted(ref) and "rgb_variance" in ref
              and n_cpu == n_gpu == _launch_counts() and floor <= tol and err <= tol
              and all(v > tol for v, _ in faults.values()))
        print(f"eval reference ({kind}): narrow {kind} model, held-out {EVAL_REF_RES}^2 view in "
              f"chunks of {EVAL_REF_CHUNK} (last one ragged), {EVAL_REF_REPEATS} repeats, same "
              f"weights and draws, gpu vs cpu over {len(ref)} outputs: rel_l2_err max={err:.3e} "
              f"at {err_at} (tol {tol}; noise floor, cpu vs cpu with origins +1 ulp: "
              f"{floor:.3e} at {floor_at}; planted in the gpu encoder forward "
              + ", ".join(f"{f}: {v:.3e} at {at}" for f, (v, at) in faults.items())
              + f", each must exceed the tol) scatter launches gpu={n_gpu} cpu={n_cpu} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"GPU {kind} eval render disagrees with the CPU reference")


GATE_STEPS = 200
# The JAX package's gate reading on a TPU v5e in round 5 (BENCH_r05.json).
JAX_GATE_DB = 23.69


def phase_gate(torch, device, seed, smi):
    """The 200-step trained-PSNR gate of the full-width flagship cache model:
    a fresh build, 200 steps at the gate's learning rate on the bench's
    training set (8 views at 128^2), then view 0 of the held-out 64^2 set."""
    import numpy as np

    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.engine import trainer
    from neural_radiance_caching_tpu_torch.ops import image, scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    config = flagship.cache_config()
    torch.manual_seed(seed)
    model = flagship.build_flagship_cache_model(config, device=device)
    dataset = datasets.SyntheticSpheres("train", None, config, num_images=8, resolution=128,
                                        device=device)
    scatter_cuda.reset_launch_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db = flagship.trained_psnr_gate(model, config, dataset, steps=GATE_STEPS)
    gate_s = time.perf_counter() - t0
    launches = dict(scatter_cuda.launches)
    # The same held-out view and draws through render_test_view and the
    # eval metrics: their PSNR is the gate's before rounding.
    test = datasets.SyntheticSpheres("test", None, config, num_images=2, resolution=64,
                                     device=device)
    rendering, batch = trainer.render_test_view(
        train.create_render_fn(model), test, 0, torch.Generator(device=device).manual_seed(7),
        config)
    metrics = trainer.compute_eval_metrics(
        rendering, batch, test.height, test.width, config, image.MetricHarness(disable_lpips=True),
        lambda x: np.clip(x, 0, 1))
    ok = (launches == _launch_counts(leveled=GATE_STEPS)
          and abs(metrics["psnr"] - db) <= 0.005 + 1e-6)
    print(f"gate: flagship cache model, {GATE_STEPS} steps from a fresh build (lr 0.01 -> 0.003, "
          f"50-step delay, 16 batches of 8192 drawn ahead, SyntheticSpheres 8x128^2), then view "
          f"0 of the held-out 2x64^2 set: trained_psnr={db:.2f} dB (floor "
          f"{flagship.TRAINED_PSNR_FLOOR}; the JAX package reached {JAX_GATE_DB} dB on a TPU v5e "
          f"in round 5, BENCH_r05.json: a quality reference, not a speed target) "
          f"psnr={metrics['psnr']:.4f} ssim={metrics['ssim']:.4f} (compute_eval_metrics of the "
          f"same view); gate wall time {gate_s:.1f}s on [{smi}]; scatter launches={launches} "
          f"(expected leveled {GATE_STEPS}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("gate phase failed")
    if db < flagship.TRAINED_PSNR_FLOOR:
        raise AssertionError(f"trained PSNR {db} dB is below the floor of "
                             f"{flagship.TRAINED_PSNR_FLOOR} dB")
    return dict(trained_psnr_db=db, floor_db=flagship.TRAINED_PSNR_FLOOR, psnr=metrics["psnr"],
                ssim=metrics["ssim"], gate_s=gate_s, launches=launches["leveled"])


def _first_chunk(torch, render_fn, rays, chunk, device):
    """The render function alone on the first `chunk` rays: (whether its
    outputs are finite before render_image's nan_to_num, its device time in
    ms, median of 3 by CUDA events)."""
    from neural_radiance_caching_tpu_torch.engine import renderer

    first = renderer._chunk_rays(rays, 0, chunk)

    def run():
        return render_fn(torch.Generator(device=device).manual_seed(11), 1.0, first)

    finite = all(bool(torch.isfinite(v).all()) for v in run().values()
                 if isinstance(v, torch.Tensor))
    return finite, _cuda_ms(run, repeats=3, warmup=1)


def _eval_render_stage(torch, model, config, test, device, n_images):
    """bench_eval_render of `model` on view 0 of `test` with its peak memory,
    after the render function alone on the first chunk; one line of text."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.parallel import train

    finite, chunk_ms = _first_chunk(torch, train.create_render_fn(model),
                                    test.generate_ray_batch(0).rays, config.render_chunk_size,
                                    device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, d = flagship.bench_eval_render(model, config, test, n_images=n_images)
    d.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30, render_fn_ms=chunk_ms,
             finite=finite)
    full, fast = d["image_secs"], d["rgb_only_image_secs"]
    text = (f"{test.height}^2 view = {d['rays_per_image']} rays in chunks of "
            f"{d['render_chunk_size']}, 1 warmup + {n_images} timed images: full extras s/image "
            f"median {statistics.median(full):.4f} (min {min(full):.4f}, max {max(full):.4f}) = "
            f"{d['rays_per_sec']:.0f} rays/s (mean), {d['ms_per_ray']:.3e} ms/ray; rgb-only "
            f"s/image median {statistics.median(fast):.4f} (min {min(fast):.4f}, max "
            f"{max(fast):.4f}) = {d['rgb_only_rays_per_sec']:.0f} rays/s; the render function "
            f"alone on one chunk (device, CUDA events, median of 3) {chunk_ms:.2f} ms; peak "
            f"{d['peak_gib']:.2f} GiB; untrained_psnr {d['untrained_psnr']:.2f} dB (a sanity "
            f"anchor); raw outputs finite={finite}")
    return d, text


def phase_eval_render(torch, device, seed, smi):
    """Eval renders of the four full-width flagship models (untrained, fresh
    builds) through bench_eval_render: the cache model on the 128^2 test
    view (the JAX bench's render stage), the material model on a held-out
    64^2 view in chunks of 1024 and then as one chunk of 4096 if it fits, the
    transient cache model on a held-out 64^2 view as one chunk of 4096 rays x
    700 bins, and the transient material model on that view in chunks of
    1024."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    stages = (
        ("cache", flagship.cache_config(), flagship.build_flagship_cache_model, 128, 3),
        ("material", flagship.material_config(render_chunk_size=1024),
         flagship.build_flagship_material_model, 64, 2),
        ("transient", flagship.transient_config(render_chunk_size=4096),
         flagship.build_flagship_transient_cache_model, 64, 2),
        ("transient_material", flagship.transient_material_config(render_chunk_size=1024),
         flagship.build_flagship_transient_material_model, 64, 2),
    )
    out = {}
    scatter_cuda.reset_launch_count()
    for name, config, build, res, n_images in stages:
        torch.manual_seed(seed)
        model = build(config, device=device)
        test = datasets.SyntheticSpheres("test", None, config, num_images=2, resolution=res,
                                         device=device)
        out[name], text = _eval_render_stage(torch, model, config, test, device, n_images)
        print(f"eval render ({name}): flagship {name} model (untrained), {text} on [{smi}]",
              flush=True)
        if name == "material":
            # The JAX notes cap material renders at chunk 1024 (a 34 GB buffer at
            # 8192); whether the whole view fits as one chunk on this card.
            config.render_chunk_size = 4096
            try:
                out["material_one_chunk"], text = _eval_render_stage(
                    torch, model, config, test, device, 1)
            except torch.cuda.OutOfMemoryError:
                text = "did not fit"
                torch.cuda.empty_cache()
            print(f"eval render (material, one chunk): {text} on [{smi}]", flush=True)
        del model

    launches = dict(scatter_cuda.launches)
    ok = launches == _launch_counts() and all(v["finite"] for v in out.values())
    print(f"eval render: scatter launches over every eval render={launches} (expected none) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("eval render phase failed")
    return out


# The transient material reference: the transient reference's 64 bins of
# 0.25, 128 rays x 32 secondary rays, each secondary ray resampled to one
# point (the flagship's resample_secondary).
TRANSIENT_MATERIAL_REF_BATCH = 128
# Transient-material gradients are held per leaf, each hash table split into
# its levels, in relative L2 norm, between the same two readings as the
# material model's: the noise floor (3.46e-2 on the CPU path) below the
# limit, the planted leveled-kernel faults (1.0 and more) above it.
TRANSIENT_MATERIAL_GRAD_REL_L2_TOL = 0.1
# No loss reaches these parameters of the transient material model: the
# learnable light replaces the material shader's own light power; the light
# sampler's outputs feed only the (unused on this path) light importance
# sampler, under a stop-gradient; the light source's position, shift and
# dark-level offsets are constants while their optimize_* flags are off; the
# cache shader's ambient heads are off. tests/test_torch_transient_material_
# slice.py pins the same set against the JAX package's zero gradients.
_TRANSIENT_MATERIAL_UNREACHED = {
    "shader.light_power",
    "shader.learnable_light.light_source_offset", "shader.learnable_light.transient_shift_offset",
    "shader.learnable_light.dark_level_offset",
    "light_sampler.layers.0.weight", "light_sampler.layers.0.bias",
    "light_sampler.layers.1.weight", "light_sampler.layers.1.bias",
    "light_sampler.output_layer.weight", "light_sampler.output_layer.bias",
    "light_sampler.grid.dense_levels", "light_sampler.grid.hash_levels",
    "cache.shader.ambient_irradiance_layer.weight", "cache.shader.ambient_irradiance_layer.bias",
    "cache.shader.surface_lf.output_ambient_rgb_layer.weight",
    "cache.shader.surface_lf.output_ambient_rgb_layer.bias",
}
# Scatter launches per transient material train step: one leveled backward
# per encoder a loss reaches, the cache's primary samples (512 x 32 points),
# its secondary samples (512 x 32 secondary rays x 32 samples = 524,288,
# below the planes layout's 2^20) and the material grid (512 points). The
# light sampler's grid gets no gradient, and the debias forward no graph.
_TRANSIENT_MATERIAL_LAUNCHES_PER_STEP = {"leveled": 3, "leveled_skip": 0, "planes": 0, "rows": 0}


def _narrow_transient_material():
    """The flagship transient material structure at reference-phase widths:
    the narrow transient cache of phase 9 with secondary-ray resampling, and
    the narrow light sampler and material shader of phase 8."""
    from neural_radiance_caching_tpu_torch import flagship

    strategy = ((0, 0, 16), (1, 1, 16), (2, 2, 16))
    cache = _narrow_transient(False)
    cache["sampler_params"]["sampling_strategy"] = strategy
    cache["train_sampling_strategy"] = cache["render_sampling_strategy"] = strategy
    return _narrow_material_shader(flagship.flagship_transient_material_params(cache), strategy)


def _transient_material_ref_config():
    from neural_radiance_caching_tpu_torch import flagship

    cfg = flagship.transient_material_config(
        batch_size=TRANSIENT_MATERIAL_REF_BATCH, n_bins=TRANSIENT_REF_BINS, exposure_time=0.25,
        lr_delay_steps=0)
    return dataclasses.replace(cfg, extra_losses=flagship.trainer_consistency_losses(cfg))


def _transient_material_step(torch, device, seed, batch, fault=None):
    """One train step of the narrow transient material model, under the
    trainer's consistency binding, on `device`; the random draws come from a
    CPU generator, so both devices see the same numbers."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    cfg = _transient_material_ref_config()
    torch.manual_seed(seed)
    model = flagship.build_flagship_transient_material_model(
        cfg, _narrow_transient_material(), device=device)
    state, _ = train.create_optimizer(cfg, model)
    before = dict(scatter_cuda.launches)
    patch = dict(scatter_add_weighted_leveled=_planted_fault(fault)) if fault else {}
    with _patched(scatter_cuda, **patch):
        rng = torch.Generator().manual_seed(seed + 7)
        _, stats = train.create_train_step(model, cfg)(rng, state, batch.to(device), 0.5)
    losses = {k: float(torch.as_tensor(v).detach()) for k, v in stats["losses"].items()}
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    return losses, grads, {k: scatter_cuda.launches[k] - before[k] for k in before}


def phase_transient_material_reference(torch, device, seed):
    """Same narrow transient material model, batch and draws on the GPU and
    the CPU, with the consistency loss under the trainer's binding."""
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.parallel import extra_losses

    cfg = _transient_material_ref_config()
    batch = datasets.SyntheticSpheres("train", None, cfg, num_images=4, resolution=32,
                                      device="cpu").next_train()
    origins = batch.rays.origins
    nudged = batch.replace(rays=batch.rays.replace(
        origins=torch.nextafter(origins, torch.full_like(origins, float("inf")))))
    l_cpu, g_cpu, n_cpu = _transient_material_step(torch, "cpu", seed, batch)
    reached = [k for k in g_cpu if k not in _TRANSIENT_MATERIAL_UNREACHED]
    floor, floor_at = _worst_grad_err(
        _transient_material_step(torch, "cpu", seed, nudged)[1], g_cpu, reached)
    l_gpu, g_gpu, n_gpu = _transient_material_step(torch, device, seed, batch)
    loss_errs = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu}
    loss_err = max(loss_errs.values())
    err, err_at = _worst_grad_err(g_gpu, g_cpu, reached)
    faults = {f: _worst_grad_err(_transient_material_step(torch, device, seed, batch, f)[1],
                                 g_cpu, reached)
              for f in ("taps rotated", "finest level dropped")}
    finite = all(torch.isfinite(g).all() for g in g_gpu.values())
    tol = TRANSIENT_MATERIAL_GRAD_REL_L2_TOL
    ok = (finite and extra_losses.CONSISTENCY in l_cpu and loss_err <= 1e-3
          and n_cpu == _launch_counts() and n_gpu == _TRANSIENT_MATERIAL_LAUNCHES_PER_STEP
          and floor <= tol and err <= tol and all(v > tol for v, _ in faults.values()))
    print(f"transient material reference: narrow transient material model, batch "
          f"{TRANSIENT_MATERIAL_REF_BATCH} x {TRANSIENT_REF_BINS} bins x 32 secondary rays, the "
          f"trainer's consistency binding, same draws, gpu vs cpu: loss rel_err max="
          f"{loss_err:.3e} (tol 1e-3; " + ", ".join(f"{k} {v:.2e}" for k, v in loss_errs.items())
          + f") grad rel_l2_err max={err:.3e} at {err_at} (tol {tol}; noise floor, cpu vs cpu "
          f"with origins +1 ulp: {floor:.3e} at {floor_at}; planted in the leveled kernel "
          + ", ".join(f"{f}: {v:.3e} at {at}" for f, (v, at) in faults.items())
          + f", each must exceed the tol) kernel launches gpu={n_gpu} cpu={n_cpu} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("GPU transient material path disagrees with the CPU reference path")
    return dict(loss_rel_err=loss_err, grad_rel_l2_err=err, noise_floor=floor,
                faults={f: v for f, (v, _) in faults.items()}, tol=tol)


def phase_transient_material_train(torch, device, seed, steps, smi, profile=None):
    """The full-width flagship transient material model in both forms (the
    bench's step, the trainer's consistency binding): a checked step each,
    then 3 warmup and `steps` timed steps each with gradient checkpointing in
    alternating blocks (bench, trainer, trainer, bench), then one step each
    without checkpointing for its peak memory."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import extra_losses, train

    per_step = _TRANSIENT_MATERIAL_LAUNCHES_PER_STEP
    t0 = time.perf_counter()
    runs = {}
    # The bench's step has no extra loss; the staged trainer binds the
    # consistency loss.
    bench_config = flagship.transient_material_config()
    for name, extra in (("bench", {}),
                        ("trainer", flagship.trainer_consistency_losses(bench_config))):
        config = dataclasses.replace(bench_config, extra_losses=extra)
        torch.manual_seed(seed)
        model = flagship.build_flagship_transient_material_model(config, device=device)
        state, _ = train.create_optimizer(config, model)
        runs[name] = dict(config=config, model=model, state=state,
                          step=train.create_train_step(model, config),
                          before={k: v.detach().clone() for k, v in model.state_dict().items()},
                          losses=[], consistency=[], times=[], peak=0.0, blocks=[])
    config = runs["bench"]["config"]
    dataset = datasets.SyntheticSpheres("train", None, config, num_images=4, resolution=64,
                                        device=device)
    batches = [dataset.next_train() for _ in range(8)]
    rng = torch.Generator(device=device).manual_seed(seed + 45)
    n_params = sum(p.numel() for p in runs["bench"]["model"].parameters())
    setup_s = time.perf_counter() - t0

    def step(run, batch):
        run["state"], stats = run["step"](rng, run["state"], batch, 0.5)
        run["losses"].append(stats["loss"])
        if extra_losses.CONSISTENCY in stats["losses"]:
            run["consistency"].append(stats["losses"][extra_losses.CONSISTENCY].detach())

    # One checked step each: every scatter call of the step against its
    # plain version on the same inputs.
    checked = {}
    for name, run in runs.items():
        calls = []
        with _patched(scatter_cuda,
                      scatter_add_weighted_leveled=_checking_scatter("leveled", calls),
                      scatter_add_weighted_planes=_checking_scatter("planes", calls)):
            step(run, batches[-1])
        checked[name] = calls
    torch.cuda.synchronize()
    kinds = {n: {k: sum(c["kind"] == k for c in calls) for k in per_step}
             for n, calls in checked.items()}
    ok = all(kinds[n] == per_step and all(c["ok"] for c in checked[n]) for n in runs)
    print("transient material train (checked steps): each scatter of one step against its plain "
          f"version on the same inputs, tol=|err|<={SUM_ORDER_TOL}*sum|w*ct|: "
          + "; ".join(f"{n}: {c['kind']} idx{list(c['shape'])} max_abs_err="
                      f"{c['max_abs_err']:.3e} {'ok' if c['ok'] else 'FAIL'}"
                      for n, calls in checked.items() for c in calls)
          + f" (calls {kinds}, expected {per_step} in each form) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version on the transient "
                             "material path")

    warmup = 3
    for run in runs.values():
        for i in range(warmup):
            step(run, batches[i % len(batches)])
    torch.cuda.synchronize()
    block = max(1, steps // 2)
    for bi, name in enumerate(("bench", "trainer", "trainer", "bench")):
        run = runs[name]
        torch.cuda.reset_peak_memory_stats()
        scatter_cuda.reset_launch_count()
        t0 = time.perf_counter()
        for i in range(block):
            step(run, batches[(bi * block + i) % len(batches)])
        torch.cuda.synchronize()
        run["times"].append((time.perf_counter() - t0) / block)
        run["blocks"].append(dict(scatter_cuda.launches))
        run["peak"] = max(run["peak"], torch.cuda.max_memory_allocated() / 2**30)

    # One more step each without checkpointing: its peak memory.
    for run in runs.values():
        run["config"].gradient_checkpointing = False
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        step(run, batches[0])
        torch.cuda.synchronize()
        run["nockpt_ms"] = (time.perf_counter() - t1) * 1e3
        run["nockpt_peak"] = torch.cuda.max_memory_allocated() / 2**30
        run["config"].gradient_checkpointing = True

    result, all_ok = {}, True
    pinned = {k: n * block for k, n in per_step.items()}
    for name, run in runs.items():
        losses = [float(v) for v in run["losses"]]
        consistency = [float(v) for v in run["consistency"]]
        finite = all(v == v and abs(v) != float("inf") for v in losses + consistency)
        unchanged = {k for k, v in run["model"].state_dict().items()
                     if torch.equal(v, run["before"][k])}
        ok = (finite and unchanged == _TRANSIENT_MATERIAL_UNREACHED
              and bool(consistency) == (name == "trainer")
              and all(b == pinned for b in run["blocks"]))
        all_ok &= ok
        dt = statistics.mean(run["times"])
        result[name] = dict(
            launches=sum(b["leveled"] for b in run["blocks"]), step_ms=dt * 1e3,
            block_ms=[t * 1e3 for t in run["times"]], rays_per_s=config.batch_size / dt,
            peak_gib=run["peak"], nockpt_ms=run["nockpt_ms"], nockpt_peak_gib=run["nockpt_peak"],
            max_abs_err=max(c["max_abs_err"] for c in checked[name]))
        cons_text = (f" consistency first={consistency[0]:.5f} last={consistency[-1]:.5f};"
                     if consistency else "")
        print(f"transient material train ({name}): flagship transient material model "
              f"({n_params} params) batch {config.batch_size} x {config.n_bins} bins x 32 "
              f"secondary rays, SyntheticSpheres 4x64^2, setup {setup_s:.1f}s; {warmup} warmup + "
              f"{2 * block} timed steps with gradient checkpointing in 2 blocks alternating with "
              f"the other form: step_ms={dt * 1e3:.2f} (blocks "
              f"{', '.join(f'{t * 1e3:.2f}' for t in run['times'])}) rays_per_s="
              f"{config.batch_size / dt:.1f} peak {run['peak']:.2f} GiB; one step without "
              f"checkpointing: {run['nockpt_ms']:.1f} ms, peak {run['nockpt_peak']:.2f} GiB; on "
              f"[{smi}]; losses finite={finite} first={losses[0]:.5f} last={losses[-1]:.5f};"
              f"{cons_text} {len(run['before']) - len(unchanged)}/{len(run['before'])} param "
              f"tensors changed, unchanged={sorted(unchanged)} (expected the "
              f"{len(_TRANSIENT_MATERIAL_UNREACHED)} no loss reaches); scatter launches per "
              f"block={run['blocks']} (expected {pinned}) {'ok' if ok else 'FAIL'}", flush=True)
    if not all_ok:
        raise AssertionError("transient material train phase failed")
    if profile:
        path = str(profile)
        stem, dot, ext = path.rpartition(".")
        run = runs["trainer"]
        _profile(torch, run["step"], run["state"], rng, batches,
                 f"{stem}.transient_material.{ext}" if dot else path + ".transient_material",
                 steps=2)
    return result


# The gin cache stage of the staged trainer (`engine/trainer.Trainer`, the
# `train_with_trainer` entry point): on configs/synthetic_spheres.gin its
# final proposal level runs the leveled kernel once per step; on the
# full-width configs/ngp_yobo.gin the density normals take the plain encoder
# (second order) and no kernel runs.
TRAINER_REF_CONFIG = "configs/synthetic_spheres.gin"
TRAINER_CONFIG = "configs/ngp_yobo.gin"
# The bindings that run a scene config without its data (the JAX trainer
# test's), and the stage.
TRAINER_BINDINGS = ("Config.dataset_loader = 'synthetic_spheres'", "Config.near = 0.2",
                    "Trainer.stage = 'cache'")


def _trainer_setup(torch, device, config_file, bindings=()):
    """The port's Trainer on `config_file`'s cache stage, set up without data
    loading's thread: bindings synthesized, datasets and model on `device`
    (the model initialised on the CPU from the Config's seed, then moved)."""
    from neural_radiance_caching_tpu_torch.engine import configs, gin_config
    from neural_radiance_caching_tpu_torch.engine.trainer import Trainer

    gin_config.clear_config()
    configs.load_config(config_files=[config_file],
                        bindings=list(TRAINER_BINDINGS) + list(bindings))
    trainer = Trainer(device=device)
    trainer._setup_names()
    trainer._setup_config_parameters()
    trainer._setup_binding_configs()
    trainer._setup_rng()
    trainer._load_datasets()
    trainer._setup_model()
    return trainer


def _trainer_step(torch, device, seed, nudge=False, fault=None):
    """One train step of the synthetic_spheres.gin cache stage through the
    Trainer's train step on `device`: the Trainer's first batch and weights,
    the draws from a CPU generator (the same numbers on both devices)."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    trainer = _trainer_setup(torch, device, TRAINER_REF_CONFIG)
    batch = trainer.dataset.next_train()
    if nudge:
        o = batch.rays.origins
        batch = batch.replace(rays=batch.rays.replace(
            origins=torch.nextafter(o, torch.full_like(o, float("inf")))))
    before = dict(scatter_cuda.launches)
    patch = dict(scatter_add_weighted_leveled=_planted_fault(fault)) if fault else {}
    with _patched(scatter_cuda, **patch):
        rng = torch.Generator().manual_seed(seed + 7)
        _, stats = trainer.train_step(rng, trainer.state, batch, 0.0)
    losses = {k: float(torch.as_tensor(v).detach()) for k, v in stats["losses"].items()}
    grads = {k: p.grad.detach().cpu() for k, p in trainer.model.named_parameters()}
    return losses, grads, {k: scatter_cuda.launches[k] - before[k] for k in before}


def phase_trainer_reference(torch, device, seed):
    """The Trainer's cache-stage step on synthetic_spheres.gin, GPU against
    CPU: every loss term and every gradient leaf."""
    l_cpu, g_cpu, n_cpu = _trainer_step(torch, "cpu", seed)
    floor, floor_at = _worst_grad_err(_trainer_step(torch, "cpu", seed, nudge=True)[1], g_cpu)
    l_gpu, g_gpu, n_gpu = _trainer_step(torch, device, seed)
    loss_errs = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu}
    loss_err = max(loss_errs.values())
    err, err_at = _worst_grad_err(g_gpu, g_cpu)
    faults = {f: _worst_grad_err(_trainer_step(torch, device, seed, fault=f)[1], g_cpu)
              for f in ("taps rotated", "finest level dropped")}
    finite = all(torch.isfinite(g).all() for g in g_gpu.values())
    duplicated = {k for k in l_cpu if k.startswith("cache_")} == {
        "cache_" + k for k in l_cpu if not k.startswith("cache_")}
    tol = GRAD_REL_L2_TOL
    ok = (finite and duplicated and "mask" in l_cpu and loss_err <= 1e-4
          and n_cpu == _launch_counts() and n_gpu == _launch_counts(leveled=1)
          and floor <= tol and err <= tol and all(v > tol for v, _ in faults.values()))
    print(f"trainer reference: Trainer, {TRAINER_REF_CONFIG} cache stage, one step, the same "
          f"weights, batch and draws, gpu vs cpu: loss terms {sorted(l_cpu)} rel_err max="
          f"{loss_err:.3e} (tol 1e-4) grad rel_l2_err max={err:.3e} at {err_at} (tol {tol}; "
          f"noise floor, cpu vs cpu with origins +1 ulp: {floor:.3e} at {floor_at}; planted in "
          "the leveled kernel " + ", ".join(f"{f}: {v:.3e} at {at}" for f, (v, at) in
                                             faults.items())
          + f", each must exceed the tol) kernel launches gpu={n_gpu} cpu={n_cpu} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the Trainer's GPU step disagrees with its CPU step")
    return dict(loss_rel_err=loss_err, grad_rel_l2_err=err, noise_floor=floor,
                faults={f: v for f, (v, _) in faults.items()}, tol=tol, launches=n_gpu["leveled"])


def phase_trainer_train(torch, device, seed, steps, smi):
    """The full-width ngp_yobo.gin cache stage through the train_with_trainer
    entry point, in-process, into a temporary checkpoint_dir: 3 warmup + N
    timed steps, a second run that resumes and takes no step, and one eval
    view."""
    import os
    import tempfile

    from neural_radiance_caching_tpu_torch import train_with_trainer
    from neural_radiance_caching_tpu_torch.engine import gin_config, trainer as trainer_lib
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.utils import checkpoints

    warmup = 3
    total = warmup + steps
    timing = {}

    class TimedTrainer(trainer_lib.Trainer):
        """The Trainer with a host clock (ending in a sync) around the timed
        steps: its train step is wrapped once the model is set up."""

        def _setup_model(self):
            super()._setup_model()
            step_fn, calls = self.train_step, [0]

            def timed(*args):
                if calls[0] == warmup:
                    torch.cuda.synchronize()
                    timing["t0"] = time.perf_counter()
                out = step_fn(*args)
                calls[0] += 1
                if calls[0] == total:
                    torch.cuda.synchronize()
                    timing["t1"] = time.perf_counter()
                return out

            self.train_step = timed

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ngp_yobo_cache")
        args = [f"--gin_configs={TRAINER_CONFIG}"] + [
            f"--gin_bindings={b}" for b in TRAINER_BINDINGS + (
                f"Config.checkpoint_dir = '{ckpt}'", f"Config.early_exit_steps = {total}",
                f"Config.print_every = {total}", f"Config.jax_rng_seed = {20200823 + seed}",
                "Config.metric_harness_train_config = {'disable_lpips': True}")]
        gin_config.clear_config()
        torch.cuda.reset_peak_memory_stats()
        scatter_cuda.reset_launch_count()
        t_setup = time.perf_counter()
        with _patched(trainer_lib, Trainer=TimedTrainer):
            trainer = train_with_trainer.main(args)
        wall = time.perf_counter() - t_setup
        launches = dict(scatter_cuda.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        dt = (timing["t1"] - timing["t0"]) / steps
        log = [json.loads(line) for line in open(os.path.join(ckpt, "train_log.jsonl"))]
        losses = {k: v for k, v in log[-1].items() if k.startswith("loss")}
        finite = all(v == v and abs(v) != float("inf") for v in losses.values())
        duplicated = {k for k in losses if k.startswith("loss/cache_")} == {
            "loss/cache_" + k[5:] for k in losses if k.startswith("loss/") and
            not k.startswith("loss/cache_")}
        saved = checkpoints.latest_checkpoint_step(ckpt)
        gin_config.clear_config()
        resumed = train_with_trainer.main(args)
        log_after = open(os.path.join(ckpt, "train_log.jsonl")).read().splitlines()
        resume_ok = resumed.state.step == total and len(log_after) == len(log)
        del resumed
        t0 = time.perf_counter()
        metrics = trainer.log_test_set_evaluation(total, 1.0)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        view = f"{trainer.test_dataset.height}x{trainer.test_dataset.width}"
    n_params = sum(p.numel() for p in trainer.model.parameters())
    ok = (finite and duplicated and "loss/mask" in losses and saved == total and resume_ok
          and launches == _launch_counts() and math.isfinite(metrics["psnr"]))
    print(f"trainer train: train_with_trainer {TRAINER_CONFIG} cache stage ({n_params} params) "
          f"batch {trainer.batch_size} on SyntheticSpheres, {warmup} warmup + {steps} timed steps: "
          f"step_ms={dt * 1e3:.2f} rays_per_s={trainer.batch_size / dt:.0f} (train_log "
          f"rays_per_sec={log[-1]['rays_per_sec']:.0f} over steps 2-{total}) on [{smi}]; "
          f"peak {peak_gib:.2f} GiB; losses finite={finite} {losses}; checkpoint step {saved}, "
          f"resumed with no step={resume_ok}; kernel launches={launches} (expected none: the "
          f"density normals take the plain encoder); eval view {view}: psnr="
          f"{metrics['psnr']:.2f} ssim={metrics['ssim']:.4f} in {eval_s:.2f}s; entry point "
          f"{wall:.1f}s {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("trainer train phase failed")
    return dict(step_ms=dt * 1e3, rays_per_s=trainer.batch_size / dt,
                train_log_rays_per_s=log[-1]["rays_per_sec"], peak_gib=peak_gib,
                batch=trainer.batch_size, steps=steps, warmup=warmup, params=n_params,
                launches=launches["leveled"], eval_view=view, eval_psnr=metrics["psnr"],
                eval_ssim=metrics["ssim"], eval_s=eval_s, entry_point_s=wall, losses=losses)


def _profile(torch, train_step, state, rng, batches, path, steps=3):
    """Device time by kernel over `steps` steps, as a table written to `path`."""
    import pathlib

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            state, _ = train_step(rng, state, batches[i], 0.5)
        torch.cuda.synchronize()
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    path.write_text(table)
    print(f"profile: top device ops over {steps} steps written to {path}", flush=True)
    print("\n".join(table.splitlines()[:16]), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=5, help="timed cache train steps")
    parser.add_argument("--material-steps", type=int, default=10,
                        help="timed material train steps")
    parser.add_argument("--transient-steps", type=int, default=10,
                        help="timed transient train steps of each run (direct, dedup)")
    parser.add_argument("--transient-material-steps", type=int, default=10,
                        help="timed transient material train steps of each form (bench, trainer)")
    parser.add_argument("--trainer-steps", type=int, default=10,
                        help="timed steps of the entry point's ngp_yobo.gin cache stage")
    parser.add_argument("--profile", metavar="FILE",
                        help="also profile train steps and write the op tables to FILE "
                             "(cache), and FILE with .material, .transient or "
                             ".transient_material before its suffix")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda"
    smi = _smi()
    print(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} nvidia-smi=[{smi}]", flush=True)

    t_start = time.perf_counter()
    lib_paths = scatter_cuda.build_library(verbose=True)
    scatter_cuda.load_library()
    print(f"build: {', '.join(p.name for p in lib_paths.values())} from csrc/ with nvcc (one per "
          f"source, in parallel) in {time.perf_counter() - t_start:.1f}s", flush=True)

    kernel = phase_kernel(torch, device, args.seed)
    planes = phase_kernel_planes(torch, device, args.seed)
    rows = phase_kernel_rows(torch, device, args.seed)
    phase_encoder(torch, device, args.seed)
    phase_encoder_planes(torch, device, args.seed)
    phase_reference(torch, device, args.seed)
    phase_material_reference(torch, device, args.seed)
    phase_transient_reference(torch, device, args.seed)
    cache_leveled, _ = phase_train(torch, device, args.seed, args.steps, smi, args.profile)
    material, _, material_err, planes_path = phase_material_train(
        torch, device, args.seed, args.material_steps, smi, args.profile)
    transient, capture = phase_transient_train(
        torch, device, args.seed, args.transient_steps, smi, args.profile)
    skip = phase_kernel_skip(torch, device, capture)
    leveled_path = phase_kernel_path(
        "leveled", capture, MATERIAL_LEVELS,
        "transient path's own updates (camera-ray samples of one checked step)")
    del capture
    phase_eval_reference(torch, device, args.seed)
    gate = phase_gate(torch, device, args.seed, smi)
    eval_render = phase_eval_render(torch, device, args.seed, smi)
    tmat_reference = phase_transient_material_reference(torch, device, args.seed)
    tmat = phase_transient_material_train(torch, device, args.seed, args.transient_material_steps,
                                          smi, args.profile)
    tmat_launches = sum(r["launches"] for r in tmat.values())
    trainer_reference = phase_trainer_reference(torch, device, args.seed)
    trainer_train = phase_trainer_train(torch, device, args.seed, args.trainer_steps, smi)
    print(f"phases done in {time.perf_counter() - t_start:.1f}s, build included", flush=True)

    csrc = "neural_radiance_caching_tpu_torch/csrc"
    replaces = "neural_radiance_caching_tpu/ops/scatter_tpu.py"
    timing = ("ms, plain_ms, library_ms: medians of 11 calls by CUDA events, wrapper included; "
              "library_ms is one index_add_ of the update rows (for a weighted scatter, the "
              "products formed beforehand); camera_ray_*, per_level_*, path_* (the inputs "
              "one train step gave the kernel: planes from the material path, leveled from "
              "the transient path) and the rows kernel's undedup_* (its camera-ray updates "
              "before the dedup scan) are kernel and index_add_ timed in 2 alternating turns; "
              "host_ms: host time of one call without a sync; "
              "bound_ms from the card's published HBM rate (3.35 TB/s) and float32 rate "
              "(67 TFLOP/s), each input read once and the output written once")
    leveled_launches = {"cache_train": cache_leveled, "material_train": material["leveled"],
                        "transient_train": transient["direct"]["launches"],
                        "transient_train_dedup": 0, "gate": gate["launches"], "eval_render": 0,
                        "transient_material": tmat_launches,
                        "trainer_train": trainer_train["launches"]}
    print(json.dumps({"kernels": [{
        "name": "scatter_add_weighted_leveled",
        "route": "cuda",
        "source": f"{csrc}/scatter_weighted.cu",
        "replaces": f"{replaces}:243",
        "launches": sum(leveled_launches.values()),
        "launches_by_path": leveled_launches,
        "max_abs_err": max(kernel["max_abs_err"], material_err["leveled"],
                           transient["direct"]["max_abs_err"],
                           *(r["max_abs_err"] for r in tmat.values())),
        "max_abs_err_by_shape": {"cache": kernel["max_abs_err"],
                                 "material_path": material_err["leveled"],
                                 "transient_path": transient["direct"]["max_abs_err"],
                                 "transient_material_path": max(
                                     r["max_abs_err"] for r in tmat.values()),
                                 "planes_shape": planes["leveled_max_abs_err"]},
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "library_ms": kernel["library_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"],
        "transient_shape_ms": skip["direct_route_ms"],
        "camera_ray_ms": kernel["camera_ray_ms"],
        "camera_ray_library_ms": kernel["camera_ray_library_ms"],
        **leveled_path,
    }, {
        "name": "scatter_add_weighted_leveled_skip_zero_w",
        "route": "cuda",
        "source": f"{csrc}/scatter_weighted.cu",
        "replaces": f"{replaces}:229",
        "launches": transient["dedup"]["launches"],
        "launches_by_path": {"cache_train": 0, "material_train": 0, "transient_train": 0,
                             "transient_train_dedup": transient["dedup"]["launches"], "gate": 0,
                             "eval_render": 0, "transient_material": 0, "trainer_train": 0},
        "max_abs_err": max(skip["max_abs_err"], transient["dedup"]["max_abs_err"]),
        "max_abs_err_by_shape": {"transient_dedup_stream": skip["max_abs_err"],
                                 "transient_path": transient["dedup"]["max_abs_err"]},
        "ms": skip["ms"],
        "plain_ms": skip["plain_ms"],
        "library_ms": skip["library_ms"],
        "bound_ms": skip["bound_ms"],
        "bound_by": skip["bound_by"],
        "zero_weight_share": skip["zero_weight_share"],
        "dedup_route_ms": skip["dedup_route_ms"],
        "direct_route_ms": skip["direct_route_ms"],
    }, {
        "name": "scatter_add_weighted_planes",
        "route": "cuda",
        "source": f"{csrc}/scatter_weighted.cu",
        "replaces": f"{replaces}:364",
        "launches": material["planes"],
        "launches_by_path": {"cache_train": 0, "material_train": material["planes"],
                             "transient_train": 0, "transient_train_dedup": 0, "gate": 0,
                             "eval_render": 0, "transient_material": 0, "trainer_train": 0},
        "max_abs_err": max(planes["max_abs_err"], material_err["planes"]),
        "max_abs_err_by_shape": {"planes_shape": planes["max_abs_err"],
                                 "material_path": material_err["planes"]},
        "ms": planes["ms"],
        "plain_ms": planes["plain_ms"],
        "library_ms": planes["library_ms"],
        "bound_ms": planes["bound_ms"],
        "bound_by": planes["bound_by"],
        "leveled_same_updates_ms": planes["leveled_ms"],
        "per_level_ms": planes["per_level_ms"],
        "per_level_library_ms": planes["per_level_library_ms"],
        **planes_path,
    }, {
        "name": "scatter_add_rows_leveled",
        "route": "cuda",
        "source": f"{csrc}/scatter_weighted.cu",
        "replaces": f"{replaces}:79",
        "launches": rows["launches"],
        "launches_by_path": {"rows_kernel_phase": rows["launches"], "cache_train": 0,
                             "material_train": 0, "transient_train": 0,
                             "transient_train_dedup": 0, "gate": 0, "eval_render": 0,
                             "transient_material": 0, "trainer_train": 0},
        **{k: v for k, v in rows.items() if k != "launches"},
    }], "timing": timing, "transient_train": {
        name: {k: v for k, v in r.items() if k != "max_abs_err"}
        for name, r in transient.items()}}), flush=True)
    print(json.dumps({"eval": {"gate": gate, "render": eval_render, "device": smi}}), flush=True)
    print(json.dumps({"transient_material": {
        "train": {name: {k: v for k, v in r.items() if k != "max_abs_err"}
                  for name, r in tmat.items()},
        "reference": tmat_reference, "eval_render": eval_render["transient_material"],
        "leveled_launches_per_step": _TRANSIENT_MATERIAL_LAUNCHES_PER_STEP["leveled"],
        "device": smi}}), flush=True)
    print(json.dumps({"trainer": {"train": trainer_train, "reference": trainer_reference,
                                  "device": smi}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # report the failed phase; exit nonzero with no result line
        traceback.print_exc()
        sys.exit(1)
