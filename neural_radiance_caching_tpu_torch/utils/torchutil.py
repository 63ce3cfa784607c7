"""RNG threading, random draws and partial stop-gradients (counterpart of
``utils/jaxutil.py``), and the device check of the port's entry points.

Randomness is an explicit ``torch.Generator`` (or None for the deterministic
path). A generator is a stream, not a splittable key, so ``random_split``
hands the same generator to both consumers, which then draw from it in
program order.

Every random number of the models is drawn by ``uniform``, ``normal`` or
``categorical`` below: the draw happens on the generator's device and moves
to the device asked for, so a CPU generator gives a CUDA run the same
numbers as a CPU run, and a test can feed both packages the same numbers by
replacing these three functions.
"""

from __future__ import annotations

import torch


def check_device(device, what, cpu_use):
    """Raise if `device` is a CUDA device and there is none: the port's entry
    points run on the card unless the caller asks for the CPU, and never fall
    back to it."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {what} on {device!r}; "
                           f"pass device='cpu' to {cpu_use}")


def random_split(rng):
    """(key, rng) for a consumer and the rest of the program; None stays None."""
    return rng, rng


def _need(rng, what):
    if rng is None:
        raise ValueError(f"{what} needs a torch.Generator (got None)")


def uniform(rng, shape, device, dtype=torch.float32):
    """U[0, 1) of `shape` on `device`, drawn from generator `rng`."""
    _need(rng, "uniform")
    return torch.rand(tuple(shape), generator=rng, device=rng.device, dtype=dtype).to(device)


def normal(rng, shape, device, dtype=torch.float32):
    """N(0, 1) of `shape` on `device`, drawn from generator `rng`."""
    _need(rng, "normal")
    return torch.randn(tuple(shape), generator=rng, device=rng.device, dtype=dtype).to(device)


def categorical(rng, logits, num=None):
    """Categorical draws over the last axis of `logits` [..., K] (Gumbel-max
    over ``uniform`` noise). num=None: one draw, shape [...]; else `num`
    independent draws, shape [..., num]."""
    shape = logits.shape if num is None else logits.shape[:-1] + (num, logits.shape[-1])
    u = uniform(rng, shape, logits.device, torch.float32)
    gumbel = -torch.log(-torch.log(u))
    scores = (logits if num is None else logits[..., None, :]).float() + gumbel
    return torch.argmax(scores, dim=-1)


def partial_stopgrad_rays(rays, weight):
    """Every tensor field of a rays dataclass through
    ``stopgrad_with_weight(., weight[0])``; None or (1, 1) returns `rays`."""
    if weight is None or tuple(weight) == (1.0, 1.0):
        return rays
    return type(rays)(**{f: stopgrad_with_weight(getattr(rays, f), weight[0])
                         for f in rays.__dataclass_fields__})


def apply_stopgrad_fields(results, mapping):
    """Per-key stopgrad weights applied to a dict of outputs (new dict)."""
    return {k: stopgrad_with_weight(v, mapping[k]) if k in mapping else v
            for k, v in results.items()}


def stopgrad_with_weight(x, weight):
    """Lerp between x and x.detach(): weight=1 keeps grads, 0 blocks them.

    The value is x; the gradient is scaled by `weight`. Integer tensors and
    None weights pass through untouched.
    """
    if x is None or weight is None:
        return x
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        return x
    if not isinstance(weight, torch.Tensor):
        if weight == 1.0:
            return x
        if weight == 0.0:
            return x.detach()
    # x * w + x.detach() * (1 - w) in gradient; exactly x in value.
    return (x - x.detach()) * weight + x.detach()
