"""Bring-up check of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py [--seed N] [--steps N] [--profile FILE]

Phases, one line each (any failure exits nonzero):
  1. device: the card, and nvidia-smi's name and power limit;
  2. build: compile the CUDA scatter kernel from csrc/ with nvcc;
  3. kernel: the kernel against its plain PyTorch version at the flagship
     shape (6 levels x 262,144 points x 4 taps, F = 4, 524,288 rows);
  4. encoder: hash-grid table gradients at the flagship shape, kernel
     backward against the plain backward;
  5. reference: a narrow cache model with the flagship's structure, the same
     weights on the GPU and on the CPU (whose path the CPU tests hold
     against the JAX package), loss and gradients compared; the gradient
     limit is checked against a noise floor and two planted scatter faults;
  6. train: the full-width flagship cache model, batch 8192 on
     SyntheticSpheres (8 views, 128^2): 3 warmup + N timed steps; losses
     finite, every parameter the passive shader reads changed, one kernel
     launch per step.
Then the kernels JSON line, the nvidia-smi line, and the result line.
"""

from __future__ import annotations

import argparse
import copy
import json
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


def _abs_sum_bound(idx, w, ct, num_rows, corners):
    """Per-entry sum of |w * ct| over the updates it receives."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    return scatter_cuda.scatter_add_weighted_leveled_plain(
        idx, w.abs(), ct.abs(), num_rows=num_rows, features=ct.shape[-1], corners=corners)


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

    got = scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, **kw)
    want = scatter_cuda.scatter_add_weighted_leveled_plain(idx, w, ct, **kw)
    bound = _abs_sum_bound(idx, w, ct, num_rows, corners)
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp(min=1e-30))[want.abs() > 1e-3].max())
    ok = bool((err <= SUM_ORDER_TOL * bound + 1e-30).all())
    hot = int(torch.bincount(idx[0].long(), minlength=4096).max())
    ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, **kw))
    plain_ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled_plain(idx, w, ct, **kw))
    print(f"kernel: scatter_add_weighted_leveled L={levels} P={points} U={corners} F={features} "
          f"rows={num_rows} (16^3 level: max {hot} updates on one row) "
          f"max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"tol=|err|<={SUM_ORDER_TOL}*sum|w*ct| {'ok' if ok else 'FAIL'} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} (median of 11, CUDA events)", flush=True)
    if not ok:
        raise AssertionError("kernel disagrees with its plain version")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)


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

    before = scatter_cuda.launches
    h_k, d_k = grads(None)
    launched = scatter_cuda.launches - before
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


def _planted_fault(fault):
    """The GPU scatter with a deliberate fault, for the reference phase's
    check that its gradient limit would catch one."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    real = scatter_cuda.scatter_add_weighted_leveled

    def scatter(idx, w, ct, **kw):
        if fault == "taps rotated":  # each tap's weight goes to the next corner
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
    batch = datasets.SyntheticSpheres("train", None, cfg, num_images=4, resolution=32).next_train()
    origins = batch.rays.origins
    nudged = batch.replace(rays=batch.rays.replace(
        origins=torch.nextafter(origins, torch.full_like(origins, float("inf")))))

    def step(dev, b, fault=None):
        torch.manual_seed(seed)
        model = flagship.build_flagship_cache_model(cfg, params).to(dev)
        state, _ = train.create_optimizer(cfg, model)
        real, before = scatter_cuda.scatter_add_weighted_leveled, scatter_cuda.launches
        if fault:
            scatter_cuda.scatter_add_weighted_leveled = _planted_fault(fault)
        try:
            _, stats = train.create_train_step(model, cfg)(None, state, b.to(dev), 0.5)
        finally:
            scatter_cuda.scatter_add_weighted_leveled = real
        losses = {k: float(torch.as_tensor(v).detach()) for k, v in stats["losses"].items()}
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        return losses, grads, scatter_cuda.launches - before

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
    model = flagship.build_flagship_cache_model(config).to(device)
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
    launches = scatter_cuda.launches

    losses = [float(v) for v in losses]
    finite = all(map(lambda v: v == v and abs(v) != float("inf"), losses))
    unchanged = {k for k, v in model.state_dict().items() if torch.equal(v, before[k])}
    changed = len(before) - len(unchanged)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # The passive shader reads neither the light power nor the SLF's rgba
    # head: those three, and only those, keep their initial values.
    ok = finite and unchanged == _UNREAD_PARAMS and launches == warmup + steps
    print(f"train: flagship cache model ({n_params} params) batch {config.batch_size} "
          f"SyntheticSpheres 8x128^2 setup {setup_s:.1f}s; {warmup} warmup + {steps} timed "
          f"steps: step_ms={dt * 1e3:.2f} rays_per_s={config.batch_size / dt:.0f} on [{smi}]; "
          f"losses finite={finite} first={losses[0]:.5f} last={losses[-1]:.5f}; "
          f"{changed}/{len(before)} param tensors changed, unchanged={sorted(unchanged)}; "
          f"scatter launches={launches} "
          f"(expected {warmup + steps}); peak {peak_gib:.2f} GiB {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("train phase failed")
    if profile:
        _profile(torch, train_step, state, rng, batches, profile)
    return launches, dt


def _profile(torch, train_step, state, rng, batches, path):
    """Device time by kernel over 3 steps, as a table written to `path`."""
    import pathlib

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            state, _ = train_step(rng, state, batches[i], 0.5)
        torch.cuda.synchronize()
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    path.write_text(table)
    print(f"profile: top device ops over 3 steps written to {path}", flush=True)
    print("\n".join(table.splitlines()[:16]), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--profile", metavar="FILE",
                        help="also profile 3 train steps and write the op table to FILE")
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

    t0 = time.perf_counter()
    lib_path = scatter_cuda.build_library(verbose=True)
    scatter_cuda.load_library()
    print(f"build: {lib_path.name} from csrc/ with nvcc in {time.perf_counter() - t0:.1f}s",
          flush=True)

    kernel = phase_kernel(torch, device, args.seed)
    phase_encoder(torch, device, args.seed)
    phase_reference(torch, device, args.seed)
    launches, _ = phase_train(torch, device, args.seed, args.steps, smi, args.profile)

    print(json.dumps({"kernels": [{
        "name": "scatter_add_weighted_leveled",
        "route": "cuda",
        "source": "neural_radiance_caching_tpu_torch/csrc/scatter_weighted.cu",
        "replaces": "neural_radiance_caching_tpu/ops/scatter_tpu.py:243",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
    }]}), flush=True)
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
