"""Carry weights across from the JAX package.

``state_dict_from_jax`` turns the JAX package's parameter tree (nested dicts
of numpy arrays, as ``jax.device_get(variables)`` gives them) into this package's
``state_dict`` for a given module: the cache model's tree, the transient
cache model's (the same names, plus the active shader's ``albedo_layer``,
``direct_tint_layer``, ``brdf_layers_*``, ``irradiance_layers_*``,
``transient_indirect_layer`` and the transient SLF's wider rgba head), or a
material model's (``Cache/...``, ``LightSampler/...``, ``MaterialShader/...``;
the transient one's ``MaterialShader/LightSource/...`` is the learnable
light, with its ``layer_mult_{i}`` and ``output_layer_mult`` Dense layers).
Every leaf maps to exactly one key and every key must be filled; a leaf left
over raises. JAX ``Dense`` kernels
``[in, out]`` become torch weights ``[out, in]``; the hash and dense tables
are copied as they are.

``jax_path`` is ``torch_key`` in reverse: the JAX parameter path of a
state_dict key, rebuilt from the key's components and their context (the
``shader`` of a material model is ``MaterialShader``, the one inside its
``Cache`` is ``Shader``; a ``grid`` is named by the module that owns it).
The optimizer's per-module schedules and the checkpoint prefixes match on
these paths. ``jax_tree_from_state_dict`` builds the JAX parameter tree of a
state_dict (the bridge's other direction).
"""

from __future__ import annotations

import re

import numpy as np
import torch

_FIXED = {
    "Cache": "cache",
    "LightSampler": "light_sampler",
    "LightSource": "learnable_light",
    "MaterialShader": "shader",
    "Sampler": "sampler",
    "Shader": "shader",
    "Integrator": "integrator",
    "SurfaceLightField": "surface_lf",
    "density_grid": "grid",
    "light_grid": "grid",
    "material_grid": "grid",
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


_REVERSE = {
    "cache": "Cache",
    "light_sampler": "LightSampler",
    "learnable_light": "LightSource",
    "sampler": "Sampler",
    "integrator": "Integrator",
    "surface_lf": "SurfaceLightField",
}
# The JAX name of a `grid` by the JAX name of its owner.
_GRID_BY_OWNER = {"LightSampler": "light_grid", "MaterialShader": "material_grid",
                  "Shader": "appearance_grid"}


def jax_path(key, material=True):
    """state_dict key -> JAX parameter path components (without 'params');
    `material` tells whether the key's module is a material model (whose
    top-level ``shader`` is the ``MaterialShader``) or a cache model."""
    parts = key.split(".")
    out = []
    i = 0
    while i < len(parts):
        c = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if c == "mlps" and nxt is not None and nxt.isdigit():
            out.append(f"MLP_{nxt}")
            i += 2
            continue
        if c in ("view_dependent_layers", "ambient_view_dependent_layers"):
            i += 1  # the SLF's layers are named by themselves
            continue
        if nxt is not None and nxt.isdigit():
            out.append(f"{c}_{nxt}")
            i += 2
            continue
        if c == "shader":
            top = not out and material
            out.append("MaterialShader" if top else "Shader")
        elif c == "grid":
            owner = out[-1] if out else ""
            out.append("density_grid" if owner.startswith("MLP_") else _GRID_BY_OWNER[owner])
        elif c == "weight" and i == len(parts) - 1:
            out.append("kernel")
        else:
            out.append(_REVERSE.get(c, c))
        i += 1
    return tuple(out)


def jax_tree_from_state_dict(state_dict, material=True):
    """A state_dict as the JAX package's variables tree {'params': ...} of
    numpy arrays (Dense weights [out, in] become kernels [in, out])."""
    tree = {}
    for key, value in state_dict.items():
        path = jax_path(key, material)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        arr = value.detach().cpu().numpy()
        node[path[-1]] = arr.T if path[-1] == "kernel" else arr
    return {"params": tree}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def state_dict_from_jax(variables, module):
    """Map a JAX variables tree onto `module`'s state_dict (new tensors, on
    the device and of the type of the module's own, the card included)."""
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
        out[key] = torch.as_tensor(np.ascontiguousarray(value), dtype=target[key].dtype,
                                   device=target[key].device)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"state_dict keys not filled from the JAX tree: {missing}")
    return out
