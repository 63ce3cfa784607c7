"""Chunked whole-image eval rendering (counterpart of ``engine/renderer.py``).

Rays are rendered in ``config.render_chunk_size`` chunks, each averaged over
``render_repeats`` independent draws (a Welford running mean, with the rgb
variance when there are several), fetched to host float32 numpy and
stitched back to [H, W, ...] images.

Against the JAX function: no chunk is padded (nothing is compiled per
shape), so an output is per-ray when its leading dim is the chunk's own row
count, and a ragged last chunk keeps every key. ``nan_to_num`` and the
running mean, which JAX computes on the host, run on the outputs' device
(the same float32 operations): a transient render's per-sample outputs hold
a gigabyte per chunk, which the host would take seconds to clean. Chunks run
one after the other; each output of a chunk is copied to the host once,
synchronously.

In a data-parallel group (``parallel/mesh.py``) every rank calls this with
the whole view: each chunk is padded to a multiple of the ranks as
``mesh.pad_rays_to_devices`` pads it (its last row repeated) and split in
equal blocks, each rank renders its block with the global chunk's random
draws (``utils/torchutil.ray_shard``), writes its repeats' mean into a
zeroed buffer of the padded chunk, and one SUM all-reduce of that buffer
gives every rank, rank 0 among them, the whole chunk. The route is an
all-reduce rather than a gather because gloo, which may run ranks that
share a card, takes all-reduce and broadcast on CUDA tensors but no
all-gather; each row has one writer, so the sum is exact. A world of one
renders as before.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from neural_radiance_caching_tpu_torch.parallel import mesh as mesh_lib
from neural_radiance_caching_tpu_torch.utils import torchutil


def _derived_generator(rng, data):
    """A generator of its own for one chunk and repeat: seeded from `rng`'s
    seed and `data`, as ``jax.random.fold_in`` derives a key (a function of
    the seed, not of how far `rng` has been drawn). None stays None."""
    if rng is None:
        return None
    seed = np.random.SeedSequence([rng.initial_seed(), data]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=rng.device).manual_seed(int(seed) & (2**63 - 1))


def _chunk_rays(rays, rows):
    """Rows `rows` (a slice or an index tensor) of every per-ray field.
    ``impulse_response`` is one global 1-D sensor kernel, not a per-ray
    field: it goes to every chunk whole."""
    fields = {}
    for f in dataclasses.fields(rays):
        v = getattr(rays, f.name)
        fields[f.name] = v if v is None or f.name == "impulse_response" else v[rows]
    return type(rays)(**fields)


def _render_chunk(render_fn, rng, count, train_frac, chunk_rays, rows, render_repeats, keys,
                  exclude):
    """The repeats' Welford mean of every per-ray output of one chunk of
    `rows` rays (and the rgb variance over several repeats), on the
    outputs' device."""
    mean_out: Dict[str, torch.Tensor] = {}
    m2 = None
    for rep in range(render_repeats):
        out = render_fn(_derived_generator(rng, count * 131 + rep), train_frac, chunk_rays)
        for k, v in out.items():
            if (keys is not None and k not in keys) or k in exclude:
                continue
            if not isinstance(v, torch.Tensor) or v.dim() == 0 or v.shape[0] != rows:
                continue
            v = torch.nan_to_num(v.detach().to(torch.float32))
            if k in mean_out:
                # Welford running mean and M2 over the repeats.
                delta = v - mean_out[k]
                mean_out[k] += delta / (rep + 1)
                if k == "rgb":
                    m2 += delta * (v - mean_out[k])
            else:
                mean_out[k] = v
                if k == "rgb":
                    m2 = torch.zeros_like(v)
    if render_repeats > 1 and m2 is not None:
        mean_out["rgb_variance"] = m2 / max(render_repeats - 1, 1)
    return mean_out


def _sharded_chunk(render_fn, rng, count, train_frac, chunk_rays, rows, render_repeats, keys,
                   exclude):
    """`_render_chunk` split across the ranks: this rank's block of the
    padded chunk rendered under the global chunk's draws, then every rank's
    block summed into the whole chunk."""
    world, rank = mesh_lib.process_count(), mesh_lib.process_index()
    index = mesh_lib.shard_index(rows, rank, world, device=chunk_rays.origins.device)
    per_rank = index.shape[0]
    with torchutil.ray_shard(rows, index.cpu()):
        local = _render_chunk(render_fn, rng, count, train_frac, _chunk_rays(chunk_rays, index),
                              per_rank, render_repeats, keys, exclude)
    flat = {k: v.reshape(per_rank, -1) for k, v in local.items()}
    widths = [v.shape[1] for v in flat.values()]
    buf = torch.zeros((world * per_rank, sum(widths)), dtype=torch.float32,
                      device=chunk_rays.origins.device)
    if flat:
        buf[rank * per_rank:(rank + 1) * per_rank] = torch.cat(list(flat.values()), dim=1)
    torch.distributed.all_reduce(buf)
    out, offset = {}, 0
    for (k, v), width in zip(local.items(), widths):
        out[k] = buf[:rows, offset:offset + width].reshape((rows,) + tuple(v.shape[1:]))
        offset += width
    return out


def render_image(
    render_fn: Callable,
    rays,
    rng: Optional[torch.Generator],
    config,
    height: Optional[int] = None,
    width: Optional[int] = None,
    train_frac: float = 1.0,
    render_repeats: int = 1,
    keys=None,
    exclude=(),
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Render all `rays` (flat [N, ...], on `device`) and return host numpy
    buffers.

    Args:
      render_fn: (rng, train_frac, rays) -> render dict
        (``parallel.train.create_render_fn``).
      rng: base generator; chunk `count`, repeat `rep` draws from a generator
        derived from it and count * 131 + rep. None for the deterministic
        sampler.
      keys: optional output keys to keep (default: every per-ray tensor).
      exclude: output keys never copied to the host.
      device: where the rays must lie: the card unless the caller asks for
        the CPU.
    Returns a dict of [H, W, ...] arrays if height and width are given, else
    [N, ...].
    """
    torchutil.check_device(device, "rendering", "render on the CPU")
    if rays.origins.device.type != torch.device(device).type:
        raise ValueError(f"rays lie on {rays.origins.device}, not on {device!r}")
    num_rays = rays.origins.shape[0]
    chunk = config.render_chunk_size
    render = _sharded_chunk if mesh_lib.process_count() > 1 else _render_chunk
    images: Dict[str, np.ndarray] = {}
    filled: Dict[str, int] = {}
    for count, start in enumerate(range(0, num_rays, chunk)):
        stop = min(start + chunk, num_rays)
        rows = stop - start
        mean_out = render(render_fn, rng, count, train_frac, _chunk_rays(rays, slice(start, stop)),
                          rows, render_repeats, keys, exclude)
        for k, v in mean_out.items():
            if k not in images:  # filled chunk by chunk: no second copy of the image
                images[k] = np.empty((num_rays,) + tuple(v.shape[1:]), np.float32)
                filled[k] = 0
            images[k][start:stop] = v.cpu().numpy()
            filled[k] += rows
    missing = sorted(k for k, n in filled.items() if n != num_rays)
    if missing:
        raise ValueError(f"render outputs {missing} are missing from some chunks")
    if height is not None and width is not None:
        images = {k: v.reshape((height, width) + v.shape[1:]) for k, v in images.items()}
    return images
