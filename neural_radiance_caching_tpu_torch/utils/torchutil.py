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

Under ``ray_shard`` (a data-parallel train step or eval chunk, one rank's
block of a global ray batch) a draw whose leading axis is the rank's rays,
or ray-major multiples of them, is drawn at the global batch's shape and the
rank keeps its block (``shard_draw``): every rank draws what one process
draws on the global batch, as JAX's one program over the mesh does. A draw
with no such axis is the same on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses

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


@dataclasses.dataclass(frozen=True)
class RayShard:
    """One rank's rays of a global batch of `global_rows`: `index` [rows]
    holds each local ray's row in the global batch."""

    global_rows: int
    index: torch.Tensor

    @property
    def rows(self):
        return self.index.shape[0]


_RAY_SHARD = None


@contextlib.contextmanager
def ray_shard(global_rows, index):
    """Draws in the block take this rank's rows (`index`, a 1-D integer
    tensor into the global batch of `global_rows` rays) of the global
    batch's draws. A scope, as ``torch.no_grad`` is, rather than state on
    the generator: the draws are made deep in the models, some from
    generators of their own (the light sampler's fixed jitter)."""
    global _RAY_SHARD
    saved, _RAY_SHARD = _RAY_SHARD, RayShard(int(global_rows), torch.as_tensor(index).long())
    try:
        yield
    finally:
        _RAY_SHARD = saved


def shard_draw(draw, shape):
    """draw(shape), or, under ``ray_shard``, this rank's block of
    draw(global shape) when the leading axis holds the rank's rays (k rays'
    worth per ray, ray-major: rows [r * k, (r + 1) * k) belong to ray r)."""
    shape, shard = tuple(shape), _RAY_SHARD
    if shard is None or not shape or shape[0] == 0 or shape[0] % shard.rows:
        return draw(shape)
    k = shape[0] // shard.rows
    x = draw((shard.global_rows * k,) + shape[1:])
    x = x.reshape((shard.global_rows, k) + shape[1:])
    return x.index_select(0, shard.index.to(x.device)).reshape(shape)


def uniform(rng, shape, device, dtype=torch.float32):
    """U[0, 1) of `shape` on `device`, drawn from generator `rng`."""
    _need(rng, "uniform")
    return shard_draw(lambda s: torch.rand(s, generator=rng, device=rng.device, dtype=dtype),
                      shape).to(device)


def normal(rng, shape, device, dtype=torch.float32):
    """N(0, 1) of `shape` on `device`, drawn from generator `rng`."""
    _need(rng, "normal")
    return shard_draw(lambda s: torch.randn(s, generator=rng, device=rng.device, dtype=dtype),
                      shape).to(device)


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
