"""RNG threading and partial stop-gradients (counterpart of
``utils/jaxutil.py``).

Randomness is an explicit ``torch.Generator`` (or None for the deterministic
path). A generator is a stream, not a splittable key, so ``random_split``
hands the same generator to both consumers, which then draw from it in
program order.
"""

from __future__ import annotations

import torch


def random_split(rng):
    """(key, rng) for a consumer and the rest of the program; None stays None."""
    return rng, rng


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
    return (x - x.detach()) * weight + x.detach()
