"""Carry weights across from the JAX package.

``state_dict_from_jax`` turns the JAX package's parameter tree (nested dicts
of numpy arrays, as ``jax.device_get(variables)`` gives them) into this package's
``state_dict`` for a given module: the cache model's tree, the transient
cache model's (the same names, plus the active shader's ``albedo_layer``,
``direct_tint_layer``, ``brdf_layers_*``, ``irradiance_layers_*``,
``transient_indirect_layer`` and the transient SLF's wider rgba head; an
SLF's own grid ``SurfaceLightField/distance_grid`` with its trunk
``layers_{i}``, its distance head ``distance_layer_{i}`` and
``distance_output_layer``, its ``reflectance_grid``, its per-point
density head ``density_layer_{i}`` and ``output_density_layer``; the
environment maps ``EnvMap`` of the cache model and of its shader, SLF
modules too), or a
material model's (``Cache/...``, with the SLF memory ``Cache/SurfaceLightFieldMem``,
``LightSampler/...``, ``MaterialShader/...``;
the transient one's ``MaterialShader/LightSource/...`` is the learnable
light, with its ``layer_mult_{i}`` and ``output_layer_mult`` Dense layers;
``VignetteMap/layer_{i}`` and ``VignetteMap/output_layer`` the vignette;
the sampler's ``SampleNetwork/layer_{i}`` and ``output_layer``; an
integrator's colour network ``Integrator/layer_{i}`` and ``output_layer``;
a density MLP's ``normals_offset_layer``; the triplane's
``triplane_grid_features_2d`` and the factored grid's
``grid_features_1d/_2d/_appearance``; the material shader's BRDF
correction ``brdf_correction_layers_{i}`` and ``output_brdf_correction_layer``
(over the MLP's width, or over the point's feature under
``per_point_brdf_correction``, where the MLP has no parameters), its
``rgb_diffuse_emission_layer`` and ``rgb_residual_albedo_layer``: each
present only under its option, as flax creates it at its first call).
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
state_dict (the bridge's other direction). ``lpips_params_to_torch`` moves
the LPIPS network's HWIO numpy parameters to a device as OIHW tensors.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_FIXED = {
    "Cache": "cache",
    "EnvMap": "env_map",
    "LightSampler": "light_sampler",
    "LightSource": "learnable_light",
    "MaterialShader": "shader",
    "Sampler": "sampler",
    "Shader": "shader",
    "Integrator": "integrator",
    "SurfaceLightField": "surface_lf",
    "SurfaceLightFieldMem": "surface_lf_mem",
    "SampleNetwork": "sample_net",
    "VignetteMap": "vignette_map",
    "appearance_grid": "grid",
    "density_grid": "grid",
    "distance_grid": "grid",
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


# Modules whose `layer_{i}` are a plain list `layer` (not the surface light
# field's named layers).
_LAYER_LIST_OWNERS = ("VignetteMap", "SampleNetwork", "Integrator")


def torch_key(path):
    """JAX parameter-tree path components (without the leading 'params') -> state_dict key."""
    out = []
    for i, p in enumerate(path):
        m = re.fullmatch(r"layer_(\d+)", p)
        if m and i > 0 and path[i - 1] in _LAYER_LIST_OWNERS:
            out.append(f"layer.{m[1]}")
        else:
            out.append(_torch_component(p))
    return ".".join(out)


_REVERSE = {
    "cache": "Cache",
    "env_map": "EnvMap",
    "light_sampler": "LightSampler",
    "learnable_light": "LightSource",
    "sampler": "Sampler",
    "integrator": "Integrator",
    "surface_lf": "SurfaceLightField",
    "surface_lf_mem": "SurfaceLightFieldMem",
    "vignette_map": "VignetteMap",
    "sample_net": "SampleNetwork",
}
# The JAX name of a `grid` by the JAX name of its owner.
_GRID_BY_OWNER = {"EnvMap": "distance_grid", "LightSampler": "light_grid",
                  "MaterialShader": "material_grid", "Shader": "appearance_grid",
                  "SurfaceLightField": "distance_grid", "SurfaceLightFieldMem": "distance_grid"}


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
            owner = out[-1] if out else ""
            out.append(f"layer_{nxt}" if c == "layer" and owner in _LAYER_LIST_OWNERS
                       else f"{c}_{nxt}")
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


def lpips_params_to_torch(params, device="cpu"):
    """LPIPS params as ``ops/lpips`` holds them on the host (HWIO kernels
    [3, 3, cin, cout], biases and linear heads as numpy arrays, the JAX
    package's layout) as float32 tensors on `device`: OIHW kernels
    [cout, cin, 3, 3], ``calibrated`` kept."""
    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(a, np.float32)), device=device)

    convs = [(tensor(np.transpose(np.asarray(w), (3, 2, 0, 1))), tensor(b))
             for w, b in params["convs"]]
    return {"convs": convs, "lins": [tensor(lin) for lin in params["lins"]],
            "calibrated": bool(params.get("calibrated", False))}
