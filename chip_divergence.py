"""What sets the gradient gap between a train step on the card and on the CPU.

Takes `chip_smoke.py`'s phase 23 step (the narrow cornell cache stage, one
step through the port's Trainer, the same weights, batch and draws on both
devices) and reports the worst gradient leaves' relative L2 gaps:

1. on the card against the CPU, for the phase's bindings and with each
   suspect taken away: the FFT shift form (`Config.transient_shift_form =
   'gather'`) and the shadow rays (no occlusion bindings); beside each, the
   CPU noise floor of the same bindings (the cameras one ulp up);
2. on the CPU against the CPU, with the result of one `exp` of the
   compositing weights (`ops/render.compute_alpha_weights`) moved by one
   ulp up or down at random per element: the `exp` of the opacity
   `alpha = 1 - exp(-sigma * delta)`, or that of the transmittance;
3. on the card against the CPU, with the opacity computed as
   `-expm1(-sigma * delta)` on both devices (no cancellation).

Run it from the root of the repository: on the card,

    python3 chip_divergence.py

or with `--cpu`, part 2 alone on the CPU. Without `--cpu` it exits nonzero
without a card.
"""

from __future__ import annotations

import argparse
import sys


def _alpha_weights(torch, opacity="exp", ulp_at=None, seed=0):
    """A `compute_alpha_weights` with the opacity as `1 - exp(-x)` ("exp",
    the reference's form) or `-expm1(-x)` ("expm1"), and with the result of
    the opacity's or the transmittance's `exp` (ulp_at "alpha" or "trans")
    moved by one ulp up or down, at random per element from `seed`."""
    gen = torch.Generator().manual_seed(seed)

    def ulp(x, site):
        if ulp_at != site:
            return x
        up = (torch.rand(x.shape, generator=gen) < 0.5).to(x.device)
        toward = torch.where(up, float("inf"), float("-inf")).to(x.dtype)
        return x + (torch.nextafter(x.detach(), toward) - x.detach())

    def compute_alpha_weights(density, tdist, dirs, opaque_background=False, delta=None):
        assert not opaque_background
        if delta is None:
            delta = (tdist[..., 1:] - tdist[..., :-1]) * torch.linalg.norm(dirs[..., None, :],
                                                                             dim=-1)
        density_delta = density * torch.abs(delta)
        if opacity == "expm1":
            alpha = -torch.expm1(-density_delta)
        else:
            alpha = 1 - ulp(torch.exp(-density_delta), "alpha")
        trans = ulp(torch.exp(-torch.cat(
            [torch.zeros_like(density_delta[..., :1]), torch.cumsum(density_delta[..., :-1], -1)],
            dim=-1)), "trans")
        return alpha * trans, alpha, trans

    return compute_alpha_weights


def _top(cs, grads, ref, n=3):
    errs = cs._grad_errs(grads, ref)
    return ", ".join(f"{k} {v:.3e}" for k, v in sorted(errs.items(), key=lambda kv: -kv[1])[:n])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true", help="part 2 alone, on the CPU")
    args = parser.parse_args()

    import torch

    import chip_smoke as cs
    from neural_radiance_caching_tpu_torch.ops import render, scatter_cuda

    if not args.cpu and not torch.cuda.is_available():
        print("chip_divergence: no CUDA device; nothing run", file=sys.stderr)
        return 2
    base = cs.TRAINER_CACHE_STAGE + cs.TRANSIENT_NARROW

    def step(device, stage, **kw):
        return cs._trainer_step(torch, device, args.seed, stage=stage,
                                config_file=cs.TRANSIENT_CONFIG, **kw)[1]

    if not args.cpu:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        scatter_cuda.build_library()
        scatter_cuda.load_library()
        print(f"device: {torch.cuda.get_device_name(0)} nvidia-smi=[{cs._smi()}]", flush=True)
        gather = ("Config.transient_shift_form = 'gather'",)
        variants = {"phase 23 (fft shift, shadow rays)": base + cs.TRANSIENT_OCCLUSIONS,
                    "gather shift, shadow rays": base + cs.TRANSIENT_OCCLUSIONS + gather,
                    "fft shift, no shadow rays": base,
                    "gather shift, no shadow rays": base + gather}
        for label, stage in variants.items():
            g_cpu = step("cpu", stage)
            floor, floor_at = cs._worst_grad_err(step("cpu", stage, nudge=1), g_cpu)
            print(f"1. {label}: card against cpu: {_top(cs, step('cuda', stage), g_cpu)}; "
                  f"cpu noise floor (cameras +1 ulp) {floor:.3e} at {floor_at}", flush=True)

    g_ref = step("cpu", base)
    for site in ("alpha", "trans"):
        for seed in (0, 1):
            with cs._patched(render, compute_alpha_weights=_alpha_weights(
                    torch, ulp_at=site, seed=seed)):
                grads = step("cpu", base)
            print(f"2. cpu, the {site} exp +-1 ulp at random (seed {seed}), against the cpu: "
                  f"{_top(cs, grads, g_ref)}", flush=True)

    if not args.cpu:
        with cs._patched(render, compute_alpha_weights=_alpha_weights(torch, "expm1")):
            g_cpu = step("cpu", base)
            print(f"3. fft shift, no shadow rays, alpha = -expm1(-x) on both: card against cpu: "
                  f"{_top(cs, step('cuda', base), g_cpu)}", flush=True)
        print(cs._smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
