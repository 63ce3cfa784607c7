"""Ray and batch containers (counterpart of ``utils/pytrees.py``).

Plain dataclasses of tensors: every field is a tensor with a leading batch
shape, or None. ``replace`` mirrors the JAX dataclasses' method of the same name and
``to`` moves every tensor field to a device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


def _map_fields(obj, fn):
    kwargs = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _map_fields(v, fn)
        elif v is not None:
            v = fn(v)
        kwargs[f.name] = v
    return type(obj)(**kwargs)


class _Struct:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, device):
        """Every array field as a tensor on `device`; float64 host arrays
        become float32, as a JAX device_put does."""

        def convert(v):
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
            return (t.float() if t.dtype == torch.float64 else t).to(device)

        return _map_fields(self, convert)


@dataclasses.dataclass
class Pixels(_Struct):
    """Integer pixel coordinates plus per-ray metadata (pre ray-casting)."""

    pix_x_int: Array
    pix_y_int: Array
    lossmult: Array
    near: Array
    far: Array
    cam_idx: Array
    light_idx: Array
    exposure_idx: Optional[Array] = None
    exposure_values: Optional[Array] = None
    device_idx: Optional[Array] = None


@dataclasses.dataclass
class Rays(_Struct):
    """A batch of rays; all arrays share leading batch dims (see the JAX
    counterpart for the meaning of each field)."""

    origins: Array
    directions: Array
    viewdirs: Array
    radii: Array
    lights: Array
    imageplane: Array
    look: Array
    up: Array
    cam_origins: Array
    vcam_look: Array
    vcam_up: Array
    vcam_origins: Array
    lossmult: Array
    near: Array
    far: Array
    cam_idx: Array
    light_idx: Array
    normals: Optional[Array] = None
    pix_x_int: Optional[Array] = None
    pix_y_int: Optional[Array] = None
    exposure_idx: Optional[Array] = None
    exposure_values: Optional[Array] = None
    device_idx: Optional[Array] = None
    impulse_response: Optional[Array] = None


@dataclasses.dataclass
class Batch(_Struct):
    """One training/eval batch: rays plus supervision targets."""

    rays: Union[Pixels, Rays]
    rgb: Optional[Array] = None
    semantic: Optional[Array] = None
    disps: Optional[Array] = None
    normals: Optional[Array] = None
    albedos: Optional[Array] = None
    depth: Optional[Array] = None
    alphas: Optional[Array] = None
    masks: Optional[Array] = None
    impulse_response: Optional[Array] = None
