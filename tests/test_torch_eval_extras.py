"""The port's evaluation extras against the JAX package's: the
shift-invariant metrics and their bilateral-grid colour correction
(``ops/image``), the probe's sphere of directions and panoramic rays, the
trainer's secondary-ray probe (``Trainer.render_secondary_rays``) and vMF
image (``render_vmf``) on a tiny ``synthetic_spheres.gin`` model with
carried-over weights, one run of the entry point on the CPU with an
evaluation (LPIPS on, no harness binding), the probe and a profiler
trace, and `--vis_only` on hotdog's material stage with albedo metrics
through both packages' trainers (an open parity check; its tolerances in
its section).

Inputs are made from a seed with numpy; the probe's random draws come from
one numpy stream in both packages (``test_torch_eval_slice.injected``).
Tolerances (float32): the metrics to rtol 1e-5 with an atol of 1e-6 (sums
in another order), the colour correction to 1e-4 absolute (a 4x4
least-squares solve per grid cell by SVD, conditioned by its 1e-5
regulariser); the sphere directions to 4 float32 ulps of 1 (linspace
rounds apart), the panoramic rays exactly (the same numpy ops); the probe's
outputs to rtol 1e-4 with an atol of 1e-4 x the output's largest entry (as
the eval slice's cache renders: the proposal resampling and the density
MLP round apart); the vMF image to rtol 1e-5 with an atol of 1e-6.
"""

import ast
import contextlib
import dataclasses
import glob
import io
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_eval_slice as eval_slice
import test_torch_loader_steps as loader_steps
import test_torch_loaders as loaders
import test_torch_material_trainer as material_trainer
import test_torch_trainer as trainer_test
from neural_radiance_caching_tpu.data import camera_utils as jcamera
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.engine.trainer import Trainer as JTrainer
from neural_radiance_caching_tpu.models import construct as jconstruct
from neural_radiance_caching_tpu.ops import image as jimage
from neural_radiance_caching_tpu.ops import render_utils as jru
from neural_radiance_caching_tpu.parallel import mesh as jmesh
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu_torch import train_with_trainer
from neural_radiance_caching_tpu_torch.data import camera_utils as tcamera
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.ops import image as timage
from neural_radiance_caching_tpu_torch.ops import render_utils as tru
from neural_radiance_caching_tpu_torch.utils import weights
from test_torch_material_slice import jax_encoder_switch_restored  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("jax_encoder_switch_restored")

TOL = dict(rtol=1e-5, atol=1e-6)
COLOR_ATOL = 1e-4
DIR_ATOL = 4 * float(np.spacing(np.float32(1)))
PROBE = 1e-4
SPHERES = trainer_test.SPHERES
TINY = trainer_test.TINY


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


def _pair(seed, shape):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(np.roll(a, 1, axis=0) + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    return a, b


# --- shift-invariant metrics ---------------------------------------------------------------


@pytest.mark.parametrize("metric,radii,halfwidth", [
    ("mse", (2, 2), 2), ("mse", (1, 3), 1), ("ssim", (2, 2), 2), ("ssim", (1, 2), 0)])
def test_shift_invariant_metrics_match_jax(metric, radii, halfwidth):
    a, b = _pair(len(metric) + radii[1], (22, 18, 3))
    jfn, tfn = {"mse": (jimage.shift_invariant_mse, timage.shift_invariant_mse),
                "ssim": (jimage.shift_invariant_ssim, timage.shift_invariant_ssim)}[metric]
    want, wdi, wdj = jfn(jnp.asarray(a), jnp.asarray(b), radii, halfwidth)
    got, gdi, gdj = tfn(a, b, radii, halfwidth)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_array_equal(gdi.numpy(), np.asarray(wdi))
    np.testing.assert_array_equal(gdj.numpy(), np.asarray(wdj))
    # The roll the images differ by is found at most pixels.
    assert np.mean(gdi.numpy() == -1) > 0.5


def test_correct_local_color_and_helpers_match_jax():
    rng = np.random.RandomState(5)
    im = rng.uniform(0, 1, (20, 16, 3)).astype(np.float32)
    im_true = np.clip(im * np.array([0.8, 1.1, 0.9], np.float32) + 0.05
                      + rng.normal(0, 0.02, im.shape), 0, 1).astype(np.float32)
    kw = dict(num_spatial_bins=[3, 4], num_luma_bins=5, num_chroma_bins=4)
    want = np.asarray(jimage.correct_local_color(jnp.asarray(im), jnp.asarray(im_true), **kw))
    got = timage.correct_local_color(im, im_true, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=COLOR_ATOL)
    assert np.abs(got - im_true).mean() < np.abs(im - im_true).mean()
    np.testing.assert_allclose(timage.rgb_to_yuv(im).numpy(), np.asarray(jimage.rgb_to_yuv(im)),
                               **TOL)
    np.testing.assert_allclose(timage.downsample(im, 4).numpy(),
                               np.asarray(jimage.downsample(jnp.asarray(im), 4)), **TOL)
    with pytest.raises(ValueError, match="does not divide"):
        timage.downsample(im, 3)
    # n-linear corners (some points past the grid's end) and their splat
    # and slice.
    coords = rng.uniform(-0.5, 4.5, (50, 3)).astype(np.float32)
    grid = [4, 3, 5]
    jidx, jw = jimage.precompute_nlinear_weights(jnp.asarray(coords), grid)
    tidx, tw = timage.precompute_nlinear_weights(torch.as_tensor(coords), grid)
    for a, b in zip(tidx, jidx):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    values = rng.normal(size=50).astype(np.float32)
    want_hist = jimage.splat_to_grid(jidx, jw, jnp.zeros(grid), jnp.asarray(values))
    got_hist = timage.splat_to_grid(tidx, tw, torch.zeros(grid), torch.as_tensor(values))
    np.testing.assert_allclose(got_hist.numpy(), np.asarray(want_hist), **TOL)
    np.testing.assert_allclose(timage.slice_from_grid(tidx, tw, got_hist).numpy(),
                               np.asarray(jimage.slice_from_grid(jidx, jw, want_hist)), **TOL)


# --- the probe's directions and rays ---------------------------------------------------------


@pytest.mark.parametrize("flip", [False, True])
def test_sphere_directions_and_spherical_rays_match_jax(flip):
    want = jru.get_sphere_directions(8, 20, flip=flip)
    got = tru.get_sphere_directions(8, 20, flip=flip)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=DIR_ATOL)
    np.testing.assert_allclose(got[3], float(want[3]), rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got[2].numpy(), axis=-1), 1.0, atol=1e-6)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(np.random.RandomState(int(flip)).normal(size=(3, 3)))[0]
    c2w[:3, -1] = [0.1, -0.2, 0.3]
    want = jcamera.cast_spherical_rays(c2w, 8, 20, 0.05, 2.0, light_idx=3)
    got = tcamera.cast_spherical_rays(c2w, 8, 20, 0.05, 2.0, light_idx=3)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name, None)
        if w is None:
            assert g is None, f.name
            continue
        assert np.asarray(g).dtype == np.asarray(w).dtype, f.name
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f.name)


# --- the secondary-ray probe ---------------------------------------------------------------


def _probe_inputs(height, width, seed=2):
    rng = np.random.RandomState(seed)
    distance = rng.uniform(2.0, 3.0, (height, width)).astype(np.float32)
    normals = rng.normal(size=(height, width, 3)).astype(np.float32)
    return distance, normals / np.linalg.norm(normals, axis=-1, keepdims=True)


@pytest.mark.parametrize("stage", ["cache", "material_light_from_scratch"])
def test_probe_render_matches_jax(stage):
    """Trainer.render_secondary_rays from the same view, pixel, depth and
    normal: the panorama ("cache", "light", "is_secondary") of the cache
    seen from the surface point, every output JAX's."""
    bindings = TINY + trainer_test.MATERIAL if stage != "cache" else TINY
    jt = trainer_test.synthesize("jax", [SPHERES], bindings, stage)
    jmodel = jconstruct.make_model(jt.config)
    variables = trainer_test._jax_variables(jmodel, 4)
    jtest = jdatasets.load_dataset("test", None, jt.config)
    # Chunks the probe's 288 rays divide: JAX pads no chunk, so both
    # packages draw the same numbers for each ray.
    stub = types.SimpleNamespace(
        test_dataset=jtest, config=dataclasses.replace(jt.config, render_chunk_size=144),
        model=jmodel,
        mesh=jmesh.create_mesh(jax.devices()[:1]), state=types.SimpleNamespace(params=variables),
        render_rng=jax.random.PRNGKey(0), vis_surface_light_field=False)
    stub._probe_resolution = lambda: JTrainer._probe_resolution(stub)

    tt = trainer_test.synthesize("torch", [SPHERES], bindings, stage)
    tt._setup_rng()
    tt._load_datasets()
    tt._setup_model()
    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    tt.config = dataclasses.replace(tt.config, render_chunk_size=144)
    h, w = jtest.height, jtest.width
    assert tt._probe_resolution() == stub._probe_resolution() == (h, 2 * w)
    distance, normals = _probe_inputs(h, w)
    sx, sy = int(round(w * 0.3)), int(round(h * 0.6))
    with eval_slice.injected(6):
        want = JTrainer.render_secondary_rays(stub, jtest.generate_ray_batch(0).rays, distance,
                                              normals, sx, sy, 0.75)
        got = tt.render_secondary_rays(tt.test_dataset.generate_ray_batch(0).rays, distance,
                                       normals, sx, sy, 0.75)
    want = {k: v for k, v in want.items() if v is not None}
    assert sorted(got) == sorted(want)
    for key in ("rgb", "acc", "distance_median", "rgb_no_stopgrad", "cache_rgb"):
        assert key in got, key
    for key, v in want.items():
        v = np.asarray(v)
        assert got[key].shape == v.shape == (h, 2 * w) + v.shape[2:], key
        np.testing.assert_allclose(got[key], v, rtol=PROBE,
                                   atol=PROBE * max(float(np.abs(v).max()), 1e-30), err_msg=key)
    assert np.isfinite(got["rgb"]).all() and float(got["acc"].max()) > 0


def test_light_sampler_vis_pass_adds_the_vmf_mixture():
    """The material model's "light_sampler_vis" pass adds the light
    sampler's outputs at the surface points to the render (what render_vmf
    reads), and changes nothing else; a pass the model does not know is
    read by nothing, as in JAX (it once raised)."""
    tt = trainer_test.synthesize("torch", [SPHERES], TINY + trainer_test.MATERIAL,
                                 "material_light_from_scratch")
    tt._setup_rng()
    tt._load_datasets()
    tt._setup_model()
    rays = tt.test_dataset.generate_ray_batch(0).rays
    rays = type(rays)(**{k: None if v is None else v[:16] for k, v in vars(rays).items()})

    def render(passes):
        with torch.no_grad():
            return tt.model(torch.Generator().manual_seed(3), rays, train=False,
                            compute_extras=True, passes=passes)

    plain = render(("cache", "light", "material"))
    shown = render(("cache", "light", "material", "light_sampler_vis"))
    vmf = shown["main"]["light_sampler"]
    assert {"vmf_means", "vmf_kappas", "vmf_logits"} <= set(vmf)
    assert set(shown["render"]) == set(plain["render"]) | set(vmf)
    for k, v in plain["render"].items():
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(shown["render"][k], v, rtol=0, atol=0, msg=k)
    for k, v in vmf.items():
        assert shown["render"][k] is v
    unknown = render(("cache", "light", "material", "unknown_pass"))
    assert set(unknown["render"]) == set(plain["render"])
    for k, v in plain["render"].items():
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(unknown["render"][k], v, rtol=0, atol=0, msg=k)


def test_render_vmf_matches_jax():
    h, w, k = 4, 6, 3
    rng = np.random.RandomState(0)
    rendering = {"vmf_means": rng.normal(size=(h, w, k, 3)).astype(np.float32),
                 "vmf_kappas": rng.uniform(1, 10, (h, w, k, 1)).astype(np.float32),
                 "vmf_logits": rng.normal(size=(h, w, k, 1)).astype(np.float32)}
    for flip in (False, True):
        config = types.SimpleNamespace(flip_secondary=flip)
        jstub = types.SimpleNamespace(test_dataset=types.SimpleNamespace(height=h, width=w),
                                      config=config, _probe_resolution=lambda: (4, 8))
        tstub = types.SimpleNamespace(**vars(jstub))
        want = JTrainer.render_vmf(jstub, rendering, 1, 2)
        got = trainer_test.ttrainer.Trainer.render_vmf(tstub, rendering, 1, 2)
        assert got.shape == want.shape == (4, 8, 3)
        np.testing.assert_allclose(got, want, **TOL)
        assert trainer_test.ttrainer.Trainer.render_vmf(tstub, {}, 0, 0) is None


# --- the entry point: evaluation with LPIPS, the probe, a profile -----------------------------


@pytest.fixture(scope="module")
def entry_run(tmp_path_factory):
    """Three cache steps of synthetic_spheres.gin through train_with_trainer
    on the CPU (24^2 views), with no metric-harness binding: a trace of steps
    1-2 and an evaluation with the secondary-ray probe at step 3."""
    root = tmp_path_factory.mktemp("entry")
    ckpt, prof = str(root / "ckpt"), str(root / "profile")
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        # No calibrated LPIPS weights where the search looks.
        mp.setenv("HOME", str(root))
        mp.setenv("NRC_LPIPS_WEIGHTS", "")
        train_with_trainer.main([
            "--gin_configs=" + SPHERES, "--device", "cpu",
            "--gin_bindings=Config.num_dataset_images=2", "--gin_bindings=Config.factor=2",
            "--gin_bindings=Config.render_chunk_size=144",
            "--gin_bindings=Trainer.stage='cache'", "--gin_bindings=Trainer.vis_secondary=True",
            f"--gin_bindings=Config.checkpoint_dir='{ckpt}'",
            "--gin_bindings=Config.early_exit_steps=3",
            "--gin_bindings=Config.train_render_every=3",
            f"--gin_bindings=Config.profile_dir='{prof}'",
            "--gin_bindings=Config.profile_start_step=1",
            "--gin_bindings=Config.profile_num_steps=2"])
    tgin.clear_config()
    return {"stdout": out.getvalue(), "ckpt": ckpt, "profile": prof}


def test_entry_point_evaluation_prints_lpips(entry_run):
    lines = [ln for ln in entry_run["stdout"].splitlines() if ln.startswith("eval step=3")]
    assert len(lines) == 1, entry_run["stdout"]
    fields = dict(f.split("=") for f in lines[0].split(" (")[0].split()[2:])
    for key in ("psnr", "ssim", "lpips", "lpips_calibrated", "avg_err"):
        assert key in fields and np.isfinite(float(fields[key])), (key, lines[0])
    assert float(fields["lpips_calibrated"]) == 0.0 and float(fields["lpips"]) > 0


def test_entry_point_vis_secondary_saves_the_probe(entry_run):
    secondary = os.path.join(entry_run["ckpt"], "save", "secondary")
    assert os.path.isdir(secondary), os.listdir(os.path.join(entry_run["ckpt"], "save"))
    saved = [f for d in os.listdir(secondary) for f in os.listdir(os.path.join(secondary, d))]
    assert saved and all(f.startswith("000003") for f in saved)


def test_profile_dir_writes_a_trace(entry_run):
    traces = glob.glob(os.path.join(entry_run["profile"], "*.json"))
    assert [os.path.basename(p) for p in traces] == ["train_steps_1-2.json"]
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"train step_num=1", "train step_num=2"} <= names
    assert "train step_num=3" not in names
    assert "profile: steps 1-2 traced to" in entry_run["stdout"]


# --- --vis_only on hotdog's material stage (an open parity check) --------------------------
#
# The README's evaluation command on a steady family: hotdog's material
# stage on a TensoIR blender scene with normal and albedo PNGs (the
# `blender_active` loader, which reads the albedos), under
# `Config.compute_albedo_metrics`, through both packages'
# `Trainer._run_visualization_only`. The eval render held as
# `test_torch_eval_slice.py` holds a material model's outputs: 1e-3
# relative with an absolute 1e-3 x the output's largest entry; so the
# metrics to 1e-2 dB (PSNR, albedo PSNR) and 1e-3 (SSIM), and the albedo
# ratio to 1e-3 relative.

VIS_ONLY_RESULTS = {"psnr": dict(rtol=0, atol=1e-2), "ssim": dict(rtol=0, atol=1e-3),
           "albedo_psnr": dict(rtol=0, atol=1e-2)}
VIS_ONLY_RENDER = 1e-3


def _vis_only_results(path):
    out = {}
    for line in open(path):
        key, values = line.split(": ", 1)
        out[key] = ast.literal_eval(values)
    return out


@pytest.fixture(scope="module")
def hotdog_dir(tmp_path_factory):
    return loaders.write_blender(str(tmp_path_factory.mktemp("hotdog")), "_rgba", aux=True)


@pytest.mark.usefixtures("jax_encoder_switch_restored")
def test_vis_only_on_hotdog_material_with_albedo_metrics(hotdog_dir, tmp_path):
    """hotdog's material stage, its test split at full size (16^2, two eval
    chunks), under `Trainer.vis_only` with `Config.compute_albedo_metrics`
    in both packages, from the same bridged weights and draws: the albedo
    ratio's pre-pass over view 0, then views 0 and 1 (Trainer.vis_end = 2);
    results.txt, albedo_ratio.npy and each view's color/*.npy."""
    bindings = trainer_test.NGP_TINY + material_trainer.OPEN_CHECK_MATERIAL + [
        "Config.dataset_loader = 'blender_active'", f"Config.data_dir = '{hotdog_dir}'",
        "Config.near = 2.0", "Config.factor = 1", "Config.compute_albedo_metrics = True", "Trainer.vis_only = True",
        "Config.vis_only = True", "Trainer.vis_end = 2"]
    files = loader_steps.HOTDOG
    jt, jmodel, tt = material_trainer._trainers(files, bindings,
                                                 material_trainer.OPEN_CHECK_STAGE)
    # Two eval chunks of 128 rays (the stage's 4096 would make JAX pad the
    # view's 256 rays and draw for the padding too, the port's renderer
    # pads nothing).
    jt.config = dataclasses.replace(jt.config, render_chunk_size=128)
    tt.config = dataclasses.replace(tt.config, render_chunk_size=128)
    jt._setup_rng()
    jt._load_datasets()
    assert jt.test_dataset.albedo_images is not None and jt.test_dataset.height == loaders.RES
    variables = material_trainer._variables(jmodel, 5)
    jt.state = types.SimpleNamespace(params=variables)
    jt.render_eval_fn = jtrain.create_render_fn(jmodel, mesh=jmesh.create_mesh(
        jax.devices()[:1]))
    jt.metric_harness = jimage.MetricHarness(disable_lpips=True)
    jt.save_dir = str(tmp_path / "jax")
    jt._initialize_metrics()

    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    tt.save_dir = str(tmp_path / "torch")
    tt._initialize_metrics()
    assert tt.config.compute_albedo_metrics and tt.test_dataset.albedo_images is not None
    render, rendered = tt.render_test_view, []
    tt.render_test_view = lambda cam_idx, train_frac: rendered.append(cam_idx) or render(
        cam_idx, train_frac)
    with eval_slice.injected(3):
        jt._run_visualization_only()
    with eval_slice.injected(3):
        tt._run_visualization_only()
    assert rendered == [0, 0, 1]

    want, got = (_vis_only_results(os.path.join(d, "results.txt")) for d in (jt.save_dir, tt.save_dir))
    assert sorted(got) == sorted(want)
    for key, tol in VIS_ONLY_RESULTS.items():
        assert len(got[key]) == len(want[key]) == 3, key
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)
    assert all(np.isfinite(got["albedo_psnr"]))
    ratio = [np.load(os.path.join(d, "albedo_ratio.npy")) for d in (tt.save_dir, jt.save_dir)]
    np.testing.assert_allclose(*ratio, rtol=1e-3)
    for view in range(2):
        g, w = (np.load(os.path.join(d, "color", f"{view:06d}.npy"))
                for d in (tt.save_dir, jt.save_dir))
        assert g.shape == w.shape == (loaders.RES, loaders.RES, 3)
        np.testing.assert_allclose(g, w, rtol=VIS_ONLY_RENDER, atol=VIS_ONLY_RENDER * np.abs(w).max())
