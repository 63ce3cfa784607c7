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


# The kernel initializers JAX resolves by name without arguments
# (``getattr(jax.nn.initializers, name)()``): (scale, fan, distribution) of
# its variance scaling, the variance scale / fan.
_VARIANCE_SCALING = {
    "he_uniform": (2.0, "fan_in", "uniform"),
    "kaiming_uniform": (2.0, "fan_in", "uniform"),
    "he_normal": (2.0, "fan_in", "truncated_normal"),
    "kaiming_normal": (2.0, "fan_in", "truncated_normal"),
    "glorot_uniform": (1.0, "fan_avg", "uniform"),
    "xavier_uniform": (1.0, "fan_avg", "uniform"),
    "glorot_normal": (1.0, "fan_avg", "truncated_normal"),
    "xavier_normal": (1.0, "fan_avg", "truncated_normal"),
    "lecun_uniform": (1.0, "fan_in", "uniform"),
    "lecun_normal": (1.0, "fan_in", "truncated_normal"),
}


def init_kernel_(weight, name):
    """Fill a torch weight [out, in] as JAX's initializer `name` fills the
    kernel [in, out]: a variance scaling of ``_VARIANCE_SCALING`` (uniform,
    or a normal truncated at two deviations), zeros or ones."""
    fan_out, fan_in = weight.shape
    with torch.no_grad():
        if name in ("zeros", "ones"):
            return weight.fill_(0.0 if name == "zeros" else 1.0)
        if name not in _VARIANCE_SCALING:
            raise ValueError(f"Unknown kernel_init {name!r}")
        scale, mode, dist = _VARIANCE_SCALING[name]
        fan = {"fan_in": fan_in, "fan_avg": (fan_in + fan_out) / 2}[mode]
        variance = scale / fan
        if dist == "uniform":
            bound = pymath.sqrt(3.0 * variance)
            return weight.uniform_(-bound, bound)
        std = pymath.sqrt(variance) / 0.87962566103423978
        return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


class Dense(nn.Linear):
    """The JAX ``nn.Dense``: a kernel filled by one of JAX's named
    initializers (``init_kernel_``; he_uniform by default) and a zero bias."""

    def __init__(self, in_features, out_features, compute_dtype=None, kernel_init="he_uniform"):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype
        self.kernel_init = kernel_init
        init_kernel_(self.weight, kernel_init)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Embed(nn.Module):
    """The JAX ``nn.Embed``: a table ``embedding`` [num_embeddings, features]
    (flax's default init, a normal of variance 1 / features truncated at two
    deviations), rows taken by index."""

    def __init__(self, num_embeddings, features):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))
        std = pymath.sqrt(1.0 / features) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.embedding, std=std, a=-2 * std, b=2 * std)

    def forward(self, idx):
        return self.embedding[idx.long()]


class SkipMLP(nn.Module):
    """Dense layers with activation; after layer i (i > 0, i % skip == 0)
    the MLP input is concatenated back on.

    Layers are registered as children named "0", "1", ... or by `names`, so
    their state_dict keys read `<mlp>.<name>.weight`.
    """

    def __init__(self, in_dim, widths, skip, activation=F.relu, compute_dtype=None,
                 names=None, kernel_init="he_uniform"):
        super().__init__()
        self.skip = skip
        self.activation = activation
        d = in_dim
        names = names or [str(i) for i in range(len(widths))]
        for i, (name, w) in enumerate(zip(names, widths)):
            self.add_module(name, Dense(d, w, compute_dtype, kernel_init))
            d = w + (in_dim if (i % skip == 0 and i > 0) else 0)
        self.out_dim = d

    def forward(self, x):
        inputs = x
        for i, layer in enumerate(self.children()):
            x = self.activation(layer(x))
            if i % self.skip == 0 and i > 0:
                x = torch.cat([x, inputs], dim=-1)
        return x


class _Softplus(torch.autograd.Function):
    """logaddexp(x, 0) and its gradient grad / (1 + exp(0 - x)), torch's own
    formulas for logaddexp, keeping x alone for the backward (logaddexp
    keeps its zero operand too, a second tensor of x's size). The backward
    is made of differentiable ops, so a second-order graph goes through it."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.logaddexp(x, torch.zeros_like(x))

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad / (1 + torch.exp(0 - x))


def softplus(x):
    """jax.nn.softplus: log(1 + exp(x)) without torch's linear threshold."""
    return _Softplus.apply(x)


class _Clamp(torch.autograd.Function):
    """torch.clamp's value and gradient (the gradient passes where
    lo <= x <= hi), keeping a boolean mask for the backward where torch
    keeps x itself: a quarter of the bytes, and x can be freed."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward((x >= lo) & (x <= hi))
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, grad):
        (mask,) = ctx.saved_tensors
        return grad * mask, None, None


def clamp(x, lo, hi):
    """torch.clamp(x, lo, hi) for the large time-binned tensors (``_Clamp``)."""
    return _Clamp.apply(x, lo, hi)
