"""Carry weights across from the JAX package.

``state_dict_from_jax`` turns the JAX package's parameter tree (nested dicts
of numpy arrays, as ``jax.device_get(variables)`` gives them) into this package's
``state_dict`` for a given module. Every leaf maps to exactly one key and
every key must be filled; a leaf left over raises. JAX ``Dense`` kernels
``[in, out]`` become torch weights ``[out, in]``; the hash and dense tables
are copied as they are.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_FIXED = {
    "Sampler": "sampler",
    "Shader": "shader",
    "Integrator": "integrator",
    "SurfaceLightField": "surface_lf",
    "density_grid": "grid",
    "kernel": "weight",
}


def _torch_component(name):
    if name in _FIXED:
        return _FIXED[name]
    m = re.fullmatch(r"MLP_(\d+)", name)
    if m:
        return f"mlps.{m[1]}"
    m = re.fullmatch(r"(ambient_)?layer_(\d+|bottleneck)", name)
    if m:
        return f"{m[1] or ''}view_dependent_layers.{name}"
    m = re.fullmatch(r"(\w+?)_(\d+)", name)
    if m:
        return f"{m[1]}.{m[2]}"
    return name


def torch_key(path):
    """JAX parameter-tree path components (without the leading 'params') -> state_dict key."""
    return ".".join(_torch_component(p) for p in path)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def state_dict_from_jax(variables, module):
    """Map a JAX variables tree onto `module`'s state_dict (new tensors)."""
    tree = variables["params"] if "params" in variables else variables
    target = module.state_dict()
    out = {}
    for path, leaf in _flatten(tree):
        key = torch_key(path)
        if key not in target:
            raise KeyError(f"JAX leaf {'/'.join(path)} maps to {key!r}, which {type(module).__name__} "
                           "does not have")
        if key in out:
            raise KeyError(f"two JAX leaves map to {key!r}")
        value = np.asarray(leaf)
        if path[-1] == "kernel":
            value = value.T
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(f"{key}: JAX shape {value.shape} vs torch {tuple(target[key].shape)}")
        out[key] = torch.as_tensor(np.ascontiguousarray(value), dtype=target[key].dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"state_dict keys not filled from the JAX tree: {missing}")
    return out
