"""The relighting inputs of the port against the JAX package's (and
OpenCV's): the Radiance HDR reader (``data/hdr.py``), the env-map tables
(``data/env_maps.py``), the samplers over a known environment map and the
env map's radiance along rays (``ops/render_utils``), the relight branches
of the ``glossy_synthetic`` and ``open_illum`` loaders; and the reference
gap of a relit render through the trainer.

Everything is made by the test from a seed with numpy: HDR files in flat,
run-length and mixed scanlines (an RGBE encoder and a run-length writer
below), EXR env maps (the JAX package's writer), fixture scenes in the
loaders' layouts. Tolerances: the HDR reader equals OpenCV bit for bit, in
this process and in one where OpenCV, PIL and JAX cannot be imported; the
tables, cameras and light indices equal JAX's (the same numpy float64
ops), the loaded images and masks to 2 float32 ulps of white (their colour
conversion and compositing, as ``test_torch_loaders.py`` holds them);
the samplers' draws come from one numpy stream in both packages
(``test_torch_material_slice.injected``), so they pick the same texels and
return JAX's directions, pdfs and radiance exactly; the quadrature of a
constant is 4 pi within 2% (the equirect grid's error, as JAX's own test);
the bilinear env-map lookup to rtol 1e-5 (float32 atan2 and sqrt).
"""

import os
import shutil
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_loaders as loaders
import test_torch_material_slice as material_slice
import test_torch_open_loaders as open_loaders
import test_torch_trainer as trainer_test
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.data import env_maps as jenv
from neural_radiance_caching_tpu.data import exr as jexr
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.engine.configs import Config as JConfig
from neural_radiance_caching_tpu.models import construct as jconstruct
from neural_radiance_caching_tpu.ops import render_utils as jru
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.data import env_maps as tenv
from neural_radiance_caching_tpu_torch.data import hdr
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.engine.configs import Config as TConfig
from neural_radiance_caching_tpu_torch.models import construct as tconstruct
from neural_radiance_caching_tpu_torch.ops import render_utils as tru
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLOR = dict(rtol=1e-5, atol=1e-6)
ENV = "sunset"


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


# --- Radiance HDR files ---------------------------------------------------------------------


def rgbe_encode(rgb):
    """[..., 3] float radiance -> [..., 4] uint8 RGBE (Ward's encoding)."""
    m = rgb.max(-1)
    nz = m > 1e-32
    mant, e = np.frexp(np.where(nz, m, 1.0))
    scale = np.where(nz, mant * 256.0 / np.where(nz, m, 1.0), 0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = (rgb * scale[..., None]).astype(np.uint8)
    out[..., 3] = np.where(nz, e + 128, 0)
    return out


def rle_channel(b):
    """One channel of a scanline in new-style runs: runs of 3 or more
    equal bytes (up to 127) as (128 + n, value), the rest as literal
    stretches (up to 128) of (n, bytes)."""
    out, i, n = bytearray(), 0, len(b)
    while i < n:
        j = i
        while j < n and j - i < 127 and b[j] == b[i]:
            j += 1
        if j - i >= 3:
            out += bytes([128 + j - i, b[i]])
            i = j
            continue
        k = i
        while k < n and k - i < 128 and not (k + 2 < n and b[k] == b[k + 1] == b[k + 2]):
            k += 1
        k = max(k, i + 1)
        out += bytes([k - i]) + bytes(b[i:k])
        i = k
    return bytes(out)


def write_hdr(path, rgb, mode, header=b"#?RADIANCE\n# made by the test\n"):
    """`rgb` [H, W, 3] as a Radiance file, every scanline flat, run-length
    encoded, or (mixed) the first half encoded and the rest flat."""
    h, w, _ = rgb.shape
    px = rgbe_encode(rgb)
    body = bytearray()
    for y in range(h):
        if mode == "flat" or (mode == "mixed" and y >= h // 2):
            body += px[y].tobytes()
        else:
            body += bytes([2, 2, w >> 8, w & 255])
            for c in range(4):
                body += rle_channel(px[y, :, c])
    with open(path, "wb") as f:
        f.write(header + b"FORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (h, w) + bytes(body))


def hdr_image(seed, h, w):
    """Radiance over six decades, with flat stretches (runs), black rows and
    pixels too dark to encode (exponent 0)."""
    rng = np.random.RandomState(seed)
    rgb = rng.uniform(0, 5, (h, w, 3)) ** 3
    rgb[1:3, 2:w - 1] = 1.5
    rgb[h // 2] = 0.0
    rgb[-1, :3] = 1e-30
    return rgb


def cv2_hdr(path):
    """What the JAX package reads (`data/io.read_hdr`)."""
    with open(path, "rb") as f:
        buf = np.frombuffer(f.read(), np.uint8)
    return cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_UNCHANGED), cv2.COLOR_BGR2RGB)


HDR_CASES = [("flat", 13, 37), ("rle", 13, 37), ("mixed", 12, 300), ("rle", 5, 7)]


@pytest.mark.parametrize("mode,h,w", HDR_CASES)
def test_hdr_reader_equals_cv2(mode, h, w, tmp_path):
    # Width 7 is under the run-length minimum: every reader takes it flat.
    path = str(tmp_path / "x.hdr")
    write_hdr(path, hdr_image(h + w, h, w), "flat" if w < 8 else mode)
    want = cv2_hdr(path)
    got = hdr.read_hdr(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (h, w, 3)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.count_nonzero(got) and not np.isnan(got).any()


def test_hdr_reader_refusals(tmp_path):
    path = str(tmp_path / "x.hdr")
    rgb = hdr_image(0, 4, 9)
    write_hdr(path, rgb, "rle", header=b"#?NOTRADIANCE\n")
    with pytest.raises(ValueError, match="not a Radiance HDR"):
        hdr.read_hdr(path)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 4 +X 9\n" + bytes(144))
    with pytest.raises(ValueError, match="-Y"):
        hdr.read_hdr(path)
    write_hdr(path, rgb, "rle")
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:-5])
    with pytest.raises(ValueError, match="end"):
        hdr.read_hdr(path)
    # The loaders' image reader leaves an HDR file to the env-map reader,
    # as PIL does in the JAX package.
    write_hdr(path, rgb, "flat")
    with pytest.raises(ValueError, match="read_hdr"):
        tdatasets.io_lib.load_img(path)


def test_hdr_reader_runs_without_cv2(tmp_path):
    """With OpenCV, PIL and JAX unimportable (the card's machine has
    neither of the first two), the reader returns OpenCV's arrays."""
    paths = []
    for i, (mode, h, w) in enumerate(HDR_CASES):
        path = str(tmp_path / f"{i}.hdr")
        write_hdr(path, hdr_image(i, h, w), "flat" if w < 8 else mode)
        np.save(str(tmp_path / f"{i}.npy"), cv2_hdr(path))
        paths.append(path)
    code = (
        "import sys\n"
        "for m in ('cv2', 'PIL', 'imageio', 'jax', 'neural_radiance_caching_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from neural_radiance_caching_tpu_torch.data import env_maps, io\n"
        f"for p in {paths!r}:\n"
        "    got, want = io.read_hdr(p), np.load(p[:-4] + '.npy')\n"
        "    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), p\n"
        f"env_maps.load_env_map({paths[0]!r}, scale=2.5)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


# --- env-map tables -------------------------------------------------------------------------


def _assert_tables_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, int):
            assert got[k] == w, k
            continue
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("y_up,rotation", [(False, 0.0), (True, 0.0), (False, 0.7)])
def test_env_map_tables_equal_jax(y_up, rotation):
    rgb = hdr_image(3, 8, 16).astype(np.float32)
    _assert_tables_equal(tenv.build_env_map_tables(rgb, y_up=y_up, rotation=rotation),
                         jenv.build_env_map_tables(rgb, y_up=y_up, rotation=rotation))


@pytest.mark.parametrize("ext,kw", [
    (".hdr", dict(scale=2.5)), (".hdr", dict(downsample=2, flip=True)),
    (".exr", dict(downsample=4, y_up=True, flip=True))])
def test_load_env_map_equals_jax(ext, kw, tmp_path):
    path = str(tmp_path / ("env" + ext))
    rgb = hdr_image(4, 16, 32)
    if ext == ".hdr":
        write_hdr(path, rgb, "rle")
    else:
        jexr.write_exr(path, rgb.astype(np.float32))
    _assert_tables_equal(tenv.load_env_map(path, **kw), jenv.load_env_map(path, **kw))


# --- samplers over a known env map ------------------------------------------------------------


def _tables(lights=1, h=8, w=16):
    maps = [jenv.build_env_map_tables(hdr_image(10 + i, h, w).astype(np.float32))
            for i in range(lights)]
    return {k: np.concatenate([m[k] for m in maps], axis=-1 if k in ("env_map_pmf",
                                                                       "env_map_pdf") else -2)
            for k in ("env_map", "env_map_pmf", "env_map_pdf", "env_map_dirs")}


@pytest.mark.parametrize("bs,n,take,lights", [(4, 8, 16, 1), (3, 5, 16, 1), (4, 8, 8, 2)])
def test_environment_sampler_matches_jax(bs, n, take, lights):
    """`take` texels drawn from the pmf and shared in blocks (16 divides
    4 x 8), or one draw per sample (3 x 5); each ray's own light's."""
    tables = _tables(lights)
    rng = np.random.RandomState(bs * n)
    wo = rng.normal(size=(bs, n, 3)).astype(np.float32)
    u = rng.uniform(size=(bs, n)).astype(np.float32)
    light_idx = rng.randint(0, lights, (bs, 1)).astype(np.int32)
    with material_slice.injected(9):
        want = jru.EnvironmentSampler(samples_to_take=take).sample_directions(
            jax.random.PRNGKey(0), jnp.asarray(u), jnp.asarray(u), jnp.asarray(wo), None,
            jnp.asarray(light_idx), {k: jnp.asarray(v) for k, v in tables.items()})
        got = tru.EnvironmentSampler(samples_to_take=take).sample_directions(
            torch.Generator().manual_seed(0), torch.as_tensor(u), torch.as_tensor(u),
            torch.as_tensor(wo), None, torch.as_tensor(light_idx),
            {k: torch.as_tensor(v) for k, v in tables.items()})
    for g, w, shape in zip(got, want, ((bs, n, 3), (bs, n), (bs, n, 3))):
        assert tuple(g.shape) == np.asarray(w).shape == shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # The samples come from the bright texels.
    assert float(got[1].mean()) > float(np.asarray(tables["env_map_pdf"]).mean())
    # The pdf of the nearest texel, per point (JAX's pdf takes one direction
    # per row of per-point tables, and raises at the dataset's [1, ...]
    # tables with more than one direction per row; so does the port's).
    wi = rng.normal(size=(bs, 3)).astype(np.float32)
    per_point = {k: np.repeat(v, bs, axis=0) for k, v in tables.items()}
    np.testing.assert_array_equal(
        tru.EnvironmentSampler().pdf(None, torch.as_tensor(wi), None,
                                     {k: torch.as_tensor(v) for k, v in per_point.items()}).numpy(),
        np.asarray(jru.EnvironmentSampler().pdf(None, jnp.asarray(wi), None,
                                                 {k: jnp.asarray(v) for k, v in per_point.items()})))
    for pdf in (lambda: jru.EnvironmentSampler().pdf(None, jnp.asarray(wo), None, tables),
                lambda: tru.EnvironmentSampler().pdf(None, torch.as_tensor(wo), None, {
                    k: torch.as_tensor(v) for k, v in tables.items()})):
        with pytest.raises(ValueError, match="same number of dimensions"):
            pdf()


def test_quadrature_sampler_matches_jax_and_integrates_a_constant():
    h, w = 16, 32
    tables = jenv.build_env_map_tables(np.ones((h, w, 3), np.float32))
    n = h * w
    u1 = np.zeros((1, n), np.float32)
    kwargs = {k: tables[k] for k in ("env_map", "env_map_dirs")}
    want = jru.QuadratureEnvmapSampler().sample_directions(
        None, jnp.asarray(u1), None, None, None, None, {k: jnp.asarray(v) for k, v in
                                                          kwargs.items()})
    sampler = tru.QuadratureEnvmapSampler()
    got = sampler.sample_directions(None, torch.as_tensor(u1), None, None, None, None,
                                    {k: torch.as_tensor(v) for k, v in kwargs.items()})
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-6)
    assert sampler.deterministic and sampler.global_dirs and sampler.return_rgb
    integral = float((1.0 / got[1]).sum(dim=-1)[0] / n)
    assert abs(integral - 4.0 * np.pi) / (4.0 * np.pi) < 0.02
    np.testing.assert_allclose(sampler.pdf(None, got[0], None, kwargs).numpy(), got[1].numpy(),
                               rtol=1e-5)
    # Fewer samples than texels: an even stride over the map.
    got = sampler.sample_directions(None, torch.zeros(2, 7), None, None, None, None,
                                    {k: torch.as_tensor(v) for k, v in kwargs.items()})
    want = jru.QuadratureEnvmapSampler().sample_directions(
        None, jnp.zeros((2, 7)), None, None, None, None,
        {k: jnp.asarray(v) for k, v in kwargs.items()})
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert set(tru.IMPORTANCE_SAMPLER_BY_NAME) >= {"environment", "quadrature"}


def test_environment_color_matches_jax():
    rng = np.random.RandomState(2)
    h, w, lights, n = 8, 16, 2, 40
    env = rng.uniform(0, 4, (h * w, lights, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    light_idx = rng.randint(0, lights, (n, 1)).astype(np.int32)
    jr = jpytrees.dummy_rays(n).replace(viewdirs=jnp.asarray(d), light_idx=jnp.asarray(light_idx))
    tr = tpytrees.Rays(**{f: None for f in tpytrees.Rays.__dataclass_fields__}).replace(
        viewdirs=torch.as_tensor(d), origins=torch.zeros(n, 3),
        light_idx=torch.as_tensor(light_idx))
    want = jru.get_environment_color(jr, jnp.asarray(env), w, h)
    got = tru.get_environment_color(tr, torch.as_tensor(env), w, h)
    assert tuple(got.shape) == (n, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **COLOR)


# --- the loaders' relight branches ------------------------------------------------------------


@pytest.fixture(scope="module")
def relight_scenes(tmp_path_factory):
    """A NeRO glossy-synthetic scene with its relit views
    (`relight_gt/bell_sunset/`) and env map (`relight_gt/sunset.exr`), and
    an OpenIllumination object with illumination `sunset`'s views and its
    HDR (`env_maps/hdrs/sunset.hdr` three levels above `output`)."""
    root = tmp_path_factory.mktemp("relight")
    glossy = str(root / "glossy")
    bell = loaders.write_glossy(glossy)
    relit = loaders.write_glossy(str(root / "relit"), n=3)
    os.makedirs(os.path.join(glossy, "relight_gt"))
    shutil.move(relit, os.path.join(glossy, "relight_gt", f"bell_{ENV}"))
    jexr.write_exr(os.path.join(glossy, "relight_gt", f"{ENV}.exr"),
                   hdr_image(5, 16, 32).astype(np.float32))
    open_root = root / "scenes" / "open"
    output = open_loaders.write_open_illum(str(open_root))
    egg = os.path.dirname(output)
    rng = np.random.RandomState(8)
    for name in os.listdir(os.path.join(egg, "Lights", "013", "raw_undistorted")):
        h, w = open_loaders.OPEN_SIZE
        open_loaders._jpeg(os.path.join(egg, "Lights", ENV, "raw_undistorted", name),
                           rng.rand(h, w, 3))
    hdrs = root / "scenes" / "env_maps" / "hdrs"
    os.makedirs(hdrs)
    write_hdr(str(hdrs / f"{ENV}.hdr"), hdr_image(6, 8, 16), "rle")
    return {"glossy_synthetic": bell, "open_illum": output}


TABLES = ("env_map", "env_map_pmf", "env_map_pdf", "env_map_dirs", "env_map_h", "env_map_w")
RELIGHT_CONFIG = {"glossy_synthetic": loaders.LOADER_CONFIG["glossy_synthetic"],
                  "open_illum": open_loaders.LOADER_CONFIG["open_illum"]}


@pytest.mark.parametrize("loader,split", [(loader, split) for loader in sorted(RELIGHT_CONFIG)
                                          for split in ("train", "test")])
def test_relight_branches_equal_jax(relight_scenes, loader, split):
    kw = dict(dataset_loader=loader, batch_size=16, compute_relight_metrics=True,
              env_map_name=ENV, **RELIGHT_CONFIG[loader])
    want = jdatasets.load_dataset(split, relight_scenes[loader], JConfig(**kw))
    got = tdatasets.load_dataset(split, relight_scenes[loader], TConfig(**kw), device="cpu")
    for name in open_loaders.ARRAYS + TABLES + ("camtoworlds", "pixtocams"):
        w = getattr(want, name, None)
        if w is None:
            assert getattr(got, name, None) is None, name
        elif name in open_loaders.ARRAYS and name != "light_idx":
            # The loaders' colour conversion and compositing, 2 float32 ulps
            # of white apart (as test_torch_loaders.py holds them).
            loaders._close_images(getattr(got, name), w, name)
        else:
            g = getattr(got, name)
            assert np.asarray(g).dtype == np.asarray(w).dtype, name
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)
    # The relit views, not the scene's own: glossy's 3, open's illumination.
    plain = tdatasets.load_dataset(split, relight_scenes[loader],
                                   TConfig(**dict(kw, compute_relight_metrics=False)),
                                   device="cpu")
    assert not hasattr(plain, "env_map_pmf")
    if loader == "glossy_synthetic":
        assert got.num_images == 3
    else:
        assert got.images.shape == plain.images.shape
        assert not np.array_equal(got.images, plain.images)
    loaders._assert_batch(got.next_train(), want.next_train(), loaders._exact)


# --- the reference gap -------------------------------------------------------------------------


def test_relit_render_is_a_reference_gap():
    """A relit material render: the JAX trainer hands its model no env map
    tables, so the material shader's EnvironmentSampler reads
    env_map_pmf = None and raises; the port raises by name."""
    bindings = trainer_test.TINY + ["Config.compute_relight_metrics = True"]
    stage = "material_light_from_scratch"
    jt = trainer_test.synthesize("jax", [trainer_test.SPHERES], bindings, stage)
    jmodel = jconstruct.make_model(jt.config)
    with pytest.raises(ValueError, match="No input was provided to the clip function"):
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1),
                                           jpytrees.dummy_rays(4), train_frac=1.0, train=False))
    tt = trainer_test.synthesize("torch", [trainer_test.SPHERES], bindings, stage)
    with pytest.raises(NotImplementedError, match="reference gap.*env_map_pmf = None"):
        tconstruct.make_model(tt.config, device="cpu")
    # The cache stage reads no env map: it builds in both.
    tgin.clear_config()
    tt = trainer_test.synthesize("torch", [trainer_test.SPHERES], bindings, "cache")
    assert tconstruct.make_model(tt.config, device="cpu") is not None
