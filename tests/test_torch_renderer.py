"""The port's chunked whole-image renderer (``engine/renderer.render_image``)
against the JAX package's, with a synthetic render function that computes
its outputs in numpy from the rays it is given and a per-call counter, so
both packages see the same values (the cases of ``tests/test_renderer.py``).

The JAX renderer pads a ragged last chunk to the chunk size and drops the
padding rows; the port does not pad. So the render function sees 5 rows in
the port where JAX gives it 8, and the outputs must still agree: images are
compared for exact equality (the same float32 numpy math on the same
values), and the port's per-call row counts are checked.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_radiance_caching_tpu.engine import renderer as jrenderer
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch.engine import renderer as trenderer
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees

CHUNK = 8


@dataclasses.dataclass
class _Cfg:
    render_chunk_size: int = CHUNK
    debug_mode: bool = False


def _rays(n, impulse=None):
    """JAX dummy rays with identifying origins (origin x = ray index), and
    the same rays for the port."""
    rays = jpytrees.dummy_rays(max(n, 1))
    origins = np.zeros((n, 3), np.float32)
    origins[:, 0] = np.arange(n)
    fields = {f.name: getattr(rays, f.name) for f in dataclasses.fields(rays)}
    fields = {k: (None if v is None else np.array(v)[:n]) for k, v in fields.items()}
    fields.update(origins=origins, impulse_response=impulse)
    jrays = jpytrees.Rays(**{k: (None if v is None else jnp.asarray(v))
                             for k, v in fields.items()})
    trays = tpytrees.Rays(**{k: (None if v is None else torch.as_tensor(v))
                             for k, v in fields.items()})
    return jrays, trays


def _outputs(origins, impulse, call):
    """Numpy outputs of one render call: per-ray values that identify the ray
    and vary with the call (so repeats differ), a [N] field, and fields that
    are not per-ray (a [3] vector, a scalar, a None)."""
    x = origins[:, :1]
    rgb = np.concatenate([x, np.sin(x * (call + 1.3)), np.cos(x + 0.7 * call)], -1)
    out = {"rgb": rgb.astype(np.float32), "depth": (2.0 + 0.1 * x[:, 0]).astype(np.float32),
           "skipme": np.zeros((3,), np.float32), "scalar": np.float32(call), "none": None}
    if impulse is not None:
        # The kernel must reach every chunk whole: its length and sum per ray.
        out["impulse"] = np.tile([[len(impulse), impulse.sum()]], (x.shape[0], 1)).astype(
            np.float32)
    return out


def _jax_render_fn(calls):
    def render_fn(variables, rng, train_frac, rays):
        calls.append(int(rays.origins.shape[0]))
        ir = None if rays.impulse_response is None else np.asarray(rays.impulse_response)
        out = _outputs(np.asarray(rays.origins), ir, len(calls) - 1)
        return {k: (None if v is None else jnp.asarray(v)) for k, v in out.items()}

    return render_fn


def _port_render_fn(calls):
    def render_fn(rng, train_frac, rays):
        calls.append(int(rays.origins.shape[0]))
        ir = None if rays.impulse_response is None else rays.impulse_response.numpy()
        out = _outputs(rays.origins.numpy(), ir, len(calls) - 1)
        return {k: (None if v is None else torch.as_tensor(v)) for k, v in out.items()}

    return render_fn


def _nan_fns():
    """Render functions whose rgb holds NaN and +-inf entries."""
    def bad(rgb):
        rgb = rgb.copy()
        rgb[::3, 0] = np.nan
        rgb[1::3, 1] = np.inf
        rgb[2::3, 2] = -np.inf
        return rgb

    def jfn(variables, rng, train_frac, rays):
        return {"rgb": jnp.asarray(bad(_outputs(np.asarray(rays.origins), None, 0)["rgb"]))}

    def tfn(rng, train_frac, rays):
        return {"rgb": torch.as_tensor(bad(_outputs(rays.origins.numpy(), None, 0)["rgb"]))}

    return jfn, tfn


CASES = {
    # name: (num_rays, render_image keywords, impulse kernel)
    "chunk_order_and_ragged_last_chunk": (21, {}, None),
    "height_width_reshape": (24, dict(height=4, width=6), None),
    "keys_filter": (21, dict(keys=("rgb",)), None),
    "welford_mean_and_rgb_variance_over_3_repeats": (21, dict(render_repeats=3), None),
    "nan_to_num": (21, {}, None),
    "empty": (0, {}, None),
    "single_chunk": (4, {}, None),
    "impulse_response_reaches_every_chunk_whole": (
        21, dict(render_repeats=2), np.array([0.1, 0.2, 0.4, 0.2, 0.1, 0.0, 0.0], np.float32)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_image_matches_jax(case):
    n, kw, impulse = CASES[case]
    jrays, trays = _rays(n, impulse)
    jcalls, tcalls = [], []
    if case == "nan_to_num":
        jfn, tfn = _nan_fns()
    else:
        jfn, tfn = _jax_render_fn(jcalls), _port_render_fn(tcalls)
    want = jrenderer.render_image(jfn, {}, jrays, jax.random.PRNGKey(0), _Cfg(), **kw)
    got = trenderer.render_image(tfn, trays, torch.Generator().manual_seed(0), _Cfg(),
                                 device="cpu", **kw)

    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    reps = kw.get("render_repeats", 1)
    if case != "nan_to_num":
        # The same calls in the same order, the port's without padding rows.
        chunks = [min(CHUNK, n - s) for s in range(0, n, CHUNK)]
        assert tcalls == [c for c in chunks for _ in range(reps)]
        assert jcalls == [CHUNK for _ in chunks for _ in range(reps)]
    if n:
        assert "skipme" not in got and "scalar" not in got and "none" not in got
        assert ("rgb_variance" in got) == (reps > 1)
    if "keys" in kw:
        assert sorted(got) == ["rgb"]
    if "height" in kw:
        assert got["rgb"].shape == (4, 6, 3) and got["depth"].shape == (4, 6)
    if case.startswith("chunk_order"):
        np.testing.assert_array_equal(got["rgb"][:, 0], np.arange(n, dtype=np.float32))
    if impulse is not None:
        np.testing.assert_allclose(got["impulse"], [[7, 1.0]] * n, rtol=1e-6)
    if case == "nan_to_num":
        assert np.isfinite(got["rgb"]).all()
        assert got["rgb"][1, 1] == np.finfo(np.float32).max
    if case == "empty":
        assert got == {}


def test_each_chunk_and_repeat_draws_from_its_own_derived_generator():
    # The port's counterpart of fold_in(rng, count * 131 + rep): a generator
    # seeded from the base generator's seed and that number; the Welford
    # mean and variance are those of the derived draws.
    def render_fn(rng, train_frac, rays):
        return {"rgb": torch.randn((rays.origins.shape[0], 3), generator=rng)}

    _, trays = _rays(21)
    base = torch.Generator().manual_seed(3)
    reps = 4
    out = trenderer.render_image(render_fn, trays, base, _Cfg(), render_repeats=reps,
                                 device="cpu")
    for count, start in enumerate(range(0, 21, CHUNK)):
        rows = min(CHUNK, 21 - start)
        draws = np.stack([
            torch.randn((rows, 3), generator=trenderer._derived_generator(base, count * 131 + r))
            .numpy() for r in range(reps)])
        np.testing.assert_allclose(out["rgb"][start:start + rows], draws.mean(0), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out["rgb_variance"][start:start + rows], draws.var(0, ddof=1),
                                   rtol=1e-4, atol=1e-6)
    # A function of the seed, not of how far the base generator was drawn.
    torch.rand(5, generator=base)
    again = trenderer.render_image(render_fn, trays, base, _Cfg(), render_repeats=reps,
                                   device="cpu")
    np.testing.assert_array_equal(again["rgb"], out["rgb"])
    assert trenderer._derived_generator(None, 7) is None
