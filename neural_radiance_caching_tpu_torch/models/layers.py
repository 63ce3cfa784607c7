"""Layer and module plumbing shared by the models (the part the JAX
package takes from its neural-network library).

``Dense`` is the JAX package's ``nn.Dense``: parameters stay float32; with a compute
dtype (bfloat16 for ``use_bf16_compute``) the input, kernel and bias are cast
to it and the output has it. Without one, the operands are promoted to a
common dtype, as the JAX ``promote_dtype`` does.

``Configurable`` gives a module dataclass-style fields: class attributes are the
defaults, constructor keywords override them, and an unknown keyword raises.
"""

from __future__ import annotations

import math as pymath
import types

import torch
import torch.nn.functional as F
from torch import nn


class Configurable:
    """Field defaults as class attributes, overridden by keyword arguments.

    A subclass lists the fields of its JAX class whose code paths are not
    ported in the class keyword ``unported`` ({name: JAX default}): they
    become class attributes, so a gin file that binds one at its default
    parses, and a keyword that changes one raises NotImplementedError
    naming it.
    """

    _unported = ()

    def __init_subclass__(cls, unported=None, **kwargs):
        super().__init_subclass__(**kwargs)
        if unported:
            for k, v in unported.items():
                setattr(cls, k, staticmethod(v) if isinstance(v, types.FunctionType) else v)
            cls._unported = tuple(cls._unported) + tuple(unported)

    def _set_fields(self, kwargs):
        cls = type(self)
        for k, v in kwargs.items():
            if k.startswith("_") or not hasattr(cls, k):
                raise TypeError(f"{cls.__name__} has no field {k!r}")
            if k in cls._unported and not _same(v, getattr(cls, k)):
                raise NotImplementedError(f"{cls.__name__}.{k}={v!r} is not ported yet")
            object.__setattr__(self, k, v)

    def _require(self, **expected):
        """Raise for fields set to a value whose code path is not ported yet."""
        for k, v in expected.items():
            if getattr(self, k) != v:
                raise NotImplementedError(
                    f"{type(self).__name__}.{k}={getattr(self, k)!r} is not ported yet")


def _same(a, b):
    try:
        return bool(a == b)
    except Exception:  # values without a boolean equality (arrays)
        return a is b


class Dense(nn.Linear):
    """The JAX ``nn.Dense`` with he_uniform (or zeros) kernel init and zero bias."""

    def __init__(self, in_features, out_features, compute_dtype=None, kernel_init="he_uniform"):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype
        with torch.no_grad():
            if kernel_init == "he_uniform":
                bound = pymath.sqrt(6.0 / in_features)
                self.weight.uniform_(-bound, bound)
            elif kernel_init == "zeros":
                self.weight.zero_()
            else:
                raise ValueError(f"Unknown kernel_init {kernel_init!r}")
            self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class SkipMLP(nn.Module):
    """Dense layers with activation; after layer i (i > 0, i % skip == 0)
    the MLP input is concatenated back on.

    Layers are registered as children named "0", "1", ... or by `names`, so
    their state_dict keys read `<mlp>.<name>.weight`.
    """

    def __init__(self, in_dim, widths, skip, activation=F.relu, compute_dtype=None,
                 names=None):
        super().__init__()
        self.skip = skip
        self.activation = activation
        d = in_dim
        names = names or [str(i) for i in range(len(widths))]
        for i, (name, w) in enumerate(zip(names, widths)):
            self.add_module(name, Dense(d, w, compute_dtype))
            d = w + (in_dim if (i % skip == 0 and i > 0) else 0)
        self.out_dim = d

    def forward(self, x):
        inputs = x
        for i, layer in enumerate(self.children()):
            x = self.activation(layer(x))
            if i % self.skip == 0 and i > 0:
                x = torch.cat([x, inputs], dim=-1)
        return x


def softplus(x):
    """jax.nn.softplus: log(1 + exp(x)) without torch's linear threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))
