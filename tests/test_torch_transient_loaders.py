"""The transient loaders (`transient_simulation`, `fwp_transient_captured`)
against the JAX package's, on scenes that h5py writes here in the layout of
InvProp's captures: `transforms_{split}.json` (and `transforms_all.json`,
`transforms_path2.json`), per-frame `data` volumes [H, W, bins(, C)], and
the pre-shuffled sample streams `train_efficient/{x,y,samples,
file_indices}.h5` (datasets `dataset`); the simulated scene's streams
contiguous with an int64 `x` that wraps in the int32 cast, the captured
scene's chunked under gzip and shuffle, its frames single-channel.

Held against JAX: the loaded cameras, lights and virtual cameras; the
first three train batches (rays, rgb, masks, alphas, lossmult, the impulse
response), cast on the host and, with `cast_rays_in_train_step`, by the
train step's caster; an eval view (64^2 frames decimated to 16^2, whole
under `vis_only`, zeros on the eval path); the failure of a stream exactly
one batch long; `io.read_h5`; then one cornell-layout cache step at test
widths through both trainers, each package's batch from its own loader,
and the README's evaluation (`Trainer._run_visualization_only`) through
both trainers on the same bridged weights and draws: results.txt and the
saved `transients/*.h5`. The port alone: every module imported and both
scenes loaded with h5py, PIL, OpenCV, imageio and JAX hidden, and
`train_one_stage --vis_only` on a checkpoint it trained from the scene.

Tolerances: cameras, lights, batches and host-cast rays bit for bit (the
same numpy operations on the same arrays); in-step cast rays to rtol 1e-6
with an absolute 1e-7 (jnp against torch); the step's loss terms to 1e-4
relative with an absolute 1e-7, every gradient leaf to rtol 2e-3 with an
absolute 2e-4 x the leaf's largest entry, the Adam step within 2 x the
group's learning rate (`test_torch_transient_trainer.py`'s); results.txt's
PSNR within 1e-3 dB and SSIM within 1e-4, its transient IoU to rtol 1e-4;
the saved transients to 5e-4 in relative L2, each entry within 2e-2 x the
largest: the eval render's 1e-4 (`test_torch_eval_slice.py`) holds but for
a few rays whose shadow rays (vis_only's occlusions) cross a grid cell
under the other framework's rounding (6 of the second view's 294,912
entries move by up to 0.84% of its largest; its relative L2 is 7.3e-5, the
first view's 5.9e-7). A wrong term is off by O(1).
"""

import ast
import json
import os
import subprocess
import sys
import types

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_eval_slice as eval_slice
import test_torch_loaders as loaders
import test_torch_material_slice as material_slice
import test_torch_material_trainer as material_trainer
import test_torch_trainer as trainer_test
import test_torch_transient_trainer as transient_trainer
from neural_radiance_caching_tpu.data import camera_utils as jcam
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.data import io as jio
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.engine.configs import Config as JConfig
from neural_radiance_caching_tpu.engine.trainer import Trainer as JTrainer
from neural_radiance_caching_tpu.models import construct as jconstruct
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.ops import image as jimage
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.parallel import mesh as jmesh
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu.utils import vis as jvis
from neural_radiance_caching_tpu_torch import train_one_stage, train_with_trainer
from neural_radiance_caching_tpu_torch.data import camera_utils as tcam
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.data import hdf5
from neural_radiance_caching_tpu_torch.data import io as tio
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.engine.configs import Config as TConfig
from neural_radiance_caching_tpu_torch.utils import checkpoints as tckpt
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees
from neural_radiance_caching_tpu_torch.utils import vis as tvis
from neural_radiance_caching_tpu_torch.utils import weights

# Stored frames; the test split's 16^2 takes every 4th row and column. A
# whole frame is one eval chunk of the trainer's (4096 rays): JAX pads a
# ragged chunk and draws for the padding, the port does not.
RES = 64
TEST_RES = 16
STORED_BINS = 30
N_BINS = 24
N_RAYS = 160
BATCH = 32
VIEWS = {"train": 3, "test": 3, "path2": 4}
FWP_K = [[600.0, 0.0, 256.0], [0.0, 600.0, 256.0], [0.0, 0.0, 1.0]]
FWP_NAMES = {"train": ["1_01", "1_02", "2_01"], "test": ["1_03", "2_02", "2_03"],
             "path2": ["p_0", "p_1", "p_2", "p_3"]}
LIGHT_TRANSFORMS = [np.eye(4).tolist(),
                    [[0.0, -1.0, 0.0, 0.5], [1.0, 0.0, 0.0, -1.5], [0.0, 0.0, 1.0, 2.0],
                     [0.0, 0.0, 0.0, 1.0]]]
CORNELL = transient_trainer.CORNELL
RESULTS = {"psnr": dict(rtol=0, atol=1e-3), "ssim": dict(rtol=0, atol=1e-4),
           "transient_iou": dict(rtol=1e-4, atol=0)}
SAVED_REL_L2 = 5e-4
SAVED_MAX_FRAC = 2e-2


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


# --- the scenes ------------------------------------------------------------------------


def _samples(rng, shape, scale):
    """Non-negative transients, a fifth of the rays empty."""
    empty = rng.uniform(size=shape[:1] + (1,) * (len(shape) - 1)) < 0.2
    return (rng.exponential(size=shape) * scale * ~empty).astype(np.float32)


def write_transient_scene(root, kind, channels=3, n_rays=N_RAYS, seed=0):
    """A `kind` ("sim" or "fwp") scene in `root`: poses, frames, streams;
    returns `root`."""
    rng = np.random.RandomState(seed)
    scale = 200.0 if kind == "sim" else 600.0
    for s, (split, n) in enumerate(VIEWS.items()):
        poses = tcam.generate_spherical_poses(n, radius=4.0, seed=71 + s)
        frames = []
        for i, pose in enumerate(poses):
            m = np.eye(4)
            m[:3] = pose
            name = f"r_{i}" if kind == "sim" else FWP_NAMES[split][i]
            frame = {"file_path": f"{split}/{name}.h5", "transform_matrix": m.tolist()}
            if kind == "fwp":
                frame["camera"] = FWP_K
            frames.append(frame)
            if split == "path2":
                continue
            shape = (RES, RES, STORED_BINS) + ((channels,) if kind == "sim" else ())
            os.makedirs(os.path.join(root, split), exist_ok=True)
            with h5py.File(os.path.join(root, split, f"{name}.h5"), "w") as f:
                opts = dict(chunks=(8, 8, STORED_BINS) + shape[3:], compression="gzip") if (
                    i == 1) else {}
                f.create_dataset("data", data=_samples(rng, shape, scale), **opts)
        meta = {"frames": frames}
        if kind == "sim":
            meta["camera_angle_x"] = 0.6911112070083618
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
        if split == "train":
            train_frames = frames
        if split == "test" and kind == "fwp":
            with open(os.path.join(root, "transforms_all.json"), "w") as f:
                json.dump({"frames": train_frames + frames}, f)
    eff = os.path.join(root, "train_efficient")
    os.makedirs(eff, exist_ok=True)
    x = rng.randint(0, RES, n_rays)
    streams = {
        "file_indices": rng.randint(0, VIEWS["train"], n_rays).astype(np.int64),
        "x": x + (1 << 32) if kind == "sim" else x.astype(np.int16),
        "y": rng.randint(0, RES, n_rays).astype(np.int32),
        "samples": _samples(rng, (n_rays, STORED_BINS, channels if kind == "sim" else 1), scale),
    }
    for name, data in streams.items():
        with h5py.File(os.path.join(eff, f"{name}.h5"), "w") as f:
            opts = {}
            if kind == "fwp":
                opts = dict(chunks=(48,) + data.shape[1:], compression="gzip", shuffle=True)
            f.create_dataset("dataset", data=data, **opts)
    return root


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("transient_scenes")
    pulse = str(root / "pulse.npy")
    np.save(pulse, np.exp(-0.5 * ((np.arange(20) - 8.0) / 2.0) ** 2))
    return {"sim": write_transient_scene(str(root / "cornell"), "sim"),
            "fwp": write_transient_scene(str(root / "statue"), "fwp"), "pulse": pulse}


def _base(kind, scenes):
    common = dict(batch_size=BATCH, width=RES, height=RES, test_width=TEST_RES,
                  test_height=TEST_RES, n_bins=N_BINS, start_bin=3, test_start_bin=2, far=4.0)
    if kind == "sim":
        return dict(common, dataset_loader="transient_simulation", dataset_scale=200.0, near=0.7)
    return dict(common, dataset_loader="fwp_transient_captured", dataset_scale=600.0, near=0.9,
                dark_level=2e-4, mask_threshold=0.0, num_rgb_channels=1,
                light_source_position=[0.9688, -3.6915, 0.1594], train_exclude_prefixes=["1_02"],
                impulse_response=scenes["pulse"], impulse_response_start_bin=2,
                n_impulse_response_bins=9)


OPTIONS = {
    "sim": {"plain": {}, "impulse_response": {"impulse": True},
            "fixed_light": dict(fixed_light=True, light_transforms=LIGHT_TRANSFORMS,
                                light_transform_idx=1),
            "fixed_camera": dict(fixed_camera=True, viz_index=2), "eval_train": dict(
                eval_train=True), "vis_only": dict(vis_only=True), "eval_path": dict(
                eval_path=True)},
    "fwp": {"plain": {}, "light_static_wrt_camera": dict(light_static_wrt_camera=True),
            "dark_level_mask_threshold": dict(dark_level=0.05, mask_threshold=2.0),
            "no_exclusions": dict(train_exclude_prefixes=[]), "eval_train": dict(eval_train=True),
            "vis_only": dict(vis_only=True), "eval_path": dict(eval_path=True)},
}
CASES = [(k, o) for k in OPTIONS for o in OPTIONS[k]]


def loader_pair(scenes, kind, option, split="train", **extra):
    kw = dict(_base(kind, scenes), **OPTIONS[kind][option], **extra)
    if kw.pop("impulse", False):
        kw.update(impulse_response=scenes["pulse"], impulse_response_start_bin=2,
                  n_impulse_response_bins=9)
    want = jdatasets.load_dataset(split, scenes[kind], JConfig(**kw))
    got = tdatasets.load_dataset(split, scenes[kind], TConfig(**kw), device="cpu")
    return want, got


# --- the loaders ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("kind,option", CASES)
def test_loader_arrays_equal_jax(scenes, kind, option, split):
    """Cameras (per-frame intrinsics of the FWP rig, every other frame of
    its eval path), lights (the fixed light's, the FWP light in each
    camera's frame or not), virtual cameras, the impulse response reversed,
    the excluded frames, the split's size."""
    want, got = loader_pair(scenes, kind, option, split)
    assert type(got).__name__ == type(want).__name__
    for name in ("pixtocams", "camtoworlds", "lights", "impulse_response"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    virtual = got.camtoworlds if got.virtual_camtoworlds is None else got.virtual_camtoworlds
    np.testing.assert_array_equal(virtual, want.virtual_camtoworlds)
    assert (got.virtual_camtoworlds is None) == (want.virtual_camtoworlds is want.camtoworlds)
    assert (got.num_images, got.height, got.width) == (want.num_images, want.height, want.width)
    assert got.images.shape == want.images.shape
    if kind == "fwp":
        np.testing.assert_array_equal(got.train_exclude_indices, want.train_exclude_indices)
    if option == "eval_path" and split == "test":
        assert got.num_images == ((VIEWS["path2"] + 1) // 2 if kind == "fwp" else VIEWS["path2"])


TRAIN_CASES = [(k, o) for k, o in CASES if o not in ("vis_only", "eval_path")]


@pytest.mark.parametrize("kind,option", TRAIN_CASES)
def test_first_batches_equal_jax(scenes, kind, option):
    """Three train batches from the same seed, the same windows of the
    streams: rays cast on the host bit for bit, then Pixels cast by the
    train step's caster against jnp's cast (the virtual cameras of the
    fixed light)."""
    want, got = loader_pair(scenes, kind, option)
    for _ in range(3):
        jbatch, tbatch = want.next_train(), got.next_train()
        loaders._assert_batch(tbatch, jbatch, loaders._exact)
    if kind == "fwp" and option == "plain":
        assert 0 < tbatch.rays.lossmult.sum() < BATCH

    want, got = loader_pair(scenes, kind, option, cast_rays_in_train_step=True)
    cast = loaders._in_step(got.config, got)
    cams = tuple(jnp.asarray(c) if c is not None else None for c in want.cameras)
    virtual = (None if want.virtual_camtoworlds is want.camtoworlds
               else (want.pixtocams, jnp.asarray(want.virtual_camtoworlds)))
    for _ in range(3):
        jbatch, tbatch = want.next_train(), got.next_train()
        assert isinstance(tbatch.rays, tpytrees.Pixels)
        jbatch = jbatch.replace(rays=jcam.cast_ray_batch(
            cams, jnp.asarray(want.lights), jbatch.rays, xnp=jnp,
            impulse_response=None if want.impulse_response is None
            else jnp.asarray(want.impulse_response), virtual_cameras=virtual))
        tbatch = tbatch.replace(rays=cast(None, tbatch.rays))

        def close(g, w, name):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=name)

        loaders._assert_batch(tbatch, jbatch, close)


EVAL_CASES = [(k, o) for k in OPTIONS for o in ("plain", "vis_only", "eval_path")] + [
    ("sim", "fixed_light"), ("fwp", "dark_level_mask_threshold")]


@pytest.mark.parametrize("kind,option", EVAL_CASES)
def test_eval_view_equals_jax(scenes, kind, option):
    """One test view: the frame's bins from test_start_bin, decimated from
    64^2 to 16^2 (whole at 64^2 under vis_only), zeros on the eval path; the
    chunked frame (view 1) and a contiguous one (view 0)."""
    want, got = loader_pair(scenes, kind, option, split="test")
    for view in (0, 1):
        jbatch, tbatch = want.generate_ray_batch(view), got.generate_ray_batch(view)
        loaders._assert_batch(tbatch, jbatch, loaders._exact)
        size = RES if option == "vis_only" else TEST_RES
        channels = 3 if kind == "sim" and option != "eval_path" else 1
        assert tbatch.rgb.shape == (size * size, N_BINS, channels)
        assert (tbatch.rgb.abs().sum() == 0) == (option == "eval_path")


@pytest.mark.parametrize("kind", ["sim", "fwp"])
def test_masks_equal_jax_on_edge_values(scenes, kind):
    """The batch's mask and clipped rgb from rays with NaN, inf, values
    whose squares underflow, negatives and zeros, against JAX's."""
    option = "dark_level_mask_threshold" if kind == "fwp" else "plain"
    want, got = loader_pair(scenes, kind, option)
    channels = 3 if kind == "sim" else 1
    rgb = np.zeros((8, 5, channels), np.float32)
    rgb[1, 2, 0] = np.nan
    rgb[2, 4, -1] = np.inf
    rgb[3] = 1e-30
    rgb[4, 0, 0] = -1.0
    rgb[5, 3] = 700.0
    rgb[6] = np.float32(np.finfo(np.float32).max)
    rgb[7, 1, 0] = 3e-17
    cam = np.zeros(8, np.int64)
    xy = np.arange(8)
    for scale in (1.0, 200.0):
        want.config.dataset_scale = got.config.dataset_scale = scale
        jbatch = want._make_transient_batch(xy, xy, cam, rgb)
        tbatch = got._make_transient_batch(xy, xy, cam, rgb)
        for name in ("rgb", "masks", "alphas"):
            np.testing.assert_array_equal(getattr(tbatch, name).numpy(), getattr(jbatch, name),
                                          err_msg=name)


def test_one_batch_stream_fails_as_jax(scenes, tmp_path):
    """A stream exactly one batch long leaves the window no start to draw
    (randint(0, 0)): both packages raise the same ValueError."""
    root = write_transient_scene(str(tmp_path / "short"), "sim", n_rays=BATCH)
    kw = _base("sim", scenes)
    errors = []
    for make in (lambda: jdatasets.load_dataset("train", root, JConfig(**kw)),
                 lambda: tdatasets.load_dataset("train", root, TConfig(**kw), device="cpu")):
        with pytest.raises(ValueError) as info:
            make().next_train()
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_read_h5_equals_jax(scenes):
    for view in (0, 1):
        prefix = os.path.join(scenes["sim"], "test", f"r_{view}")
        got, want = tio.read_h5(prefix), jio.read_h5(prefix + ".h5")
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_transient_loaders_run_without_h5py_or_jax(scenes):
    """The port's package imports, and both scenes load and serve a batch
    and an eval view, with h5py, PIL, OpenCV, imageio and JAX hidden."""
    hidden = ("PIL", "cv2", "imageio", "h5py", "jax", "neural_radiance_caching_tpu")
    configs = {kind: {k: v for k, v in _base(kind, scenes).items()} for kind in ("sim", "fwp")}
    code = (
        "import importlib, pkgutil, sys\n"
        f"for m in {hidden!r}:\n"
        "    sys.modules[m] = None\n"
        "import neural_radiance_caching_tpu_torch as port\n"
        "for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from neural_radiance_caching_tpu_torch.data import datasets\n"
        "from neural_radiance_caching_tpu_torch.engine.configs import Config\n"
        f"for kind, kw in {configs!r}.items():\n"
        f"    root = {scenes!r}[kind]\n"
        "    d = datasets.load_dataset('train', root, Config(**kw), device='cpu')\n"
        f"    assert d.next_train().rgb.shape[:2] == ({BATCH}, {N_BINS})\n"
        "    t = datasets.load_dataset('test', root, Config(**kw), device='cpu')\n"
        f"    assert t.generate_ray_batch(1).rgb.shape[:2] == ({TEST_RES ** 2}, {N_BINS})\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


# --- through the trainers --------------------------------------------------------------------


def cornell_bindings(data_dir):
    """The narrow cornell cache stage (`test_torch_transient_trainer`) on
    the scene at `data_dir`, every frame of it."""
    return transient_trainer.TRANSIENT_TINY + [
        "Config.dataset_loader = 'transient_simulation'", f"Config.data_dir = '{data_dir}'",
        "Config.num_dataset_images = -1", "Config.near = 0.7", f"Config.width = {RES}",
        f"Config.height = {RES}", f"Config.test_width = {TEST_RES}",
        f"Config.test_height = {TEST_RES}", "Config.start_bin = 3", "Config.test_start_bin = 2",
        "Config.metric_harness_train_config = {'disable_lpips': True}"]


def test_cornell_cache_step_from_disk_through_both_trainers(scenes, monkeypatch):
    """One cache step from the same weights and draws, each package's
    batch from its own loader of the scene (Pixels, cast in the step):
    every loss term, every gradient leaf, the Adam step, one leveled
    launch."""
    jt, jmodel, tt = material_trainer._trainers(CORNELL, cornell_bindings(scenes["sim"]),
                                                "cache")
    jcfg = jt.config
    jdata = jdatasets.load_dataset("train", jcfg.data_dir, jcfg)
    assert type(tt.dataset).__name__ == type(jdata).__name__ == "TransientSimulation"
    variables = material_trainer._variables(jmodel, 5)
    jbatch = jdata.next_train()
    with material_slice.injected(7), jhash.xla_encoder_scope():
        (_, jlosses_), jgrad = transient_trainer.jax_step_loss(jmodel, jcfg, jdata,
                                                               transient_trainer.TRAIN_FRAC)(
            variables, jbatch)
    jgrad = jlosses.clip_gradients(jax.tree_util.tree_map(jnp.nan_to_num, jgrad), jcfg)
    jstate, _ = jtrain.create_optimizer(jcfg, variables)
    updates, _ = jstate.tx.update(jgrad, jstate.opt_state, variables)
    jnew = material_slice._leaves(optax.apply_updates(variables, updates)["params"])

    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    tbatch = tt.dataset.next_train()
    assert isinstance(tbatch.rays, tpytrees.Pixels)
    np.testing.assert_array_equal(tbatch.rgb.numpy(), jbatch.rgb)
    calls = []
    material_slice._counting_scatters(monkeypatch, calls)
    with material_slice.injected(7):
        state, stats = tt.train_step(tt.rng, tt.state, tbatch, transient_trainer.TRAIN_FRAC)
    assert calls == ["leveled"]

    got = {k: float(v) for k, v in stats["losses"].items()}
    assert sorted(got) == sorted(jlosses_)
    assert {"data", "cache_data", "mask", "geometry_smoothness"} <= set(got) and got["data"] > 0
    for k, v in jlosses_.items():
        np.testing.assert_allclose(got[k], float(v), err_msg=k, **transient_trainer.LOSS)
    want = material_slice._leaves(jgrad["params"])
    params = dict(tt.model.named_parameters())
    assert sorted(params) == sorted(want)
    for k, p in params.items():
        material_slice._close(p.grad.numpy(), material_slice._tr(k, want[k]),
                              *transient_trainer.GRAD, k)
    for k, p in params.items():
        lr = max(g["lr"] for g in state.optimizer.param_groups
                 if any(q is p for q in g["params"]))
        np.testing.assert_allclose(p.detach().numpy(), material_slice._tr(k, jnew[k]),
                                   rtol=0, atol=2 * lr + 1e-7, err_msg=k)


def _results(path):
    out = {}
    for line in open(path):
        key, values = line.split(": ", 1)
        out[key] = ast.literal_eval(values)
    return out


def test_transient_vis_suite_integrates_the_bins_only():
    """The port's transient vis suite sums the bins of an [H, W, bins, C]
    radiance buffer, leaves a steady [H, W, 3] one as it is and shows the
    per-bin lossmult at its first bin: JAX's steady suite of those buffers.
    JAX's own transient suite also sums the width of the steady one, or
    keeps the lossmult's bins, and raises at a broadcast."""
    rng = np.random.RandomState(4)
    rendering = {"rgb": rng.uniform(size=(6, 5, 7, 3)).astype(np.float32),
                 "cache_rgb": rng.uniform(size=(6, 5, 7, 3)).astype(np.float32),
                 "cache_direct_rgb": rng.uniform(size=(6, 5, 3)).astype(np.float32),
                 "lossmult": np.ones((6, 5, 7, 3), np.float32),
                 "acc": rng.uniform(size=(6, 5)).astype(np.float32)}
    config = types.SimpleNamespace(img_scale=4.0)
    for drop in ("lossmult", "cache_direct_rgb"):
        with pytest.raises(ValueError, match="broadcast"):
            jvis.visualize_transient_suite(
                {k: v for k, v in rendering.items() if k != drop}, config)
    integrated = {"rgb": np.clip(rendering["rgb"].sum(-2) / 4.0, 0, 1),
                  "cache_rgb": np.clip(rendering["cache_rgb"].sum(-2) / 4.0, 0, 1),
                  "cache_direct_rgb": np.clip(rendering["cache_direct_rgb"] / 4.0, 0, 1),
                  "lossmult": rendering["lossmult"][..., 0, :], "acc": rendering["acc"]}
    want = jvis.visualize_suite(integrated, config)
    got = tvis.visualize_transient_suite(rendering, config)
    assert sorted(got) == sorted(want) and {"cache_direct_color", "lossmult"} <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7, err_msg=k)


def test_vis_only_results_and_transients_match_jax(scenes, tmp_path, monkeypatch):
    """`Trainer._run_visualization_only` (the README's evaluation command)
    on the cornell-layout scene in both packages, with the same bridged
    weights and draws and 2 render repeats: the test split at Config.height
    (64^2, no decimation, one eval chunk) under vis_only's shadow rays, the
    first two views (Trainer.vis_end = 2);
    results.txt (per view and the mean) and the saved transients/*.h5,
    each read by h5py, and the time slices written. JAX's transient vis
    suite raises on the cache's steady direct light (above), so JAX's run
    writes no vis PNG here."""
    monkeypatch.setattr(jvis, "visualize_transient_suite", lambda *args, **kwargs: {})
    # cornell binds compute_albedo_metrics; its test set has no albedo, so
    # the ratio stays None, and the port finds that out without JAX's render
    # of the first view, whose draws would shift the shared stream's.
    albedo_ratio = JTrainer._compute_albedo_ratio
    monkeypatch.setattr(JTrainer, "_compute_albedo_ratio", lambda self, n_views: None if (
        self.test_dataset.albedo_images is None) else albedo_ratio(self, n_views))
    bindings = cornell_bindings(scenes["sim"]) + [
        "Trainer.vis_only = True", "Config.vis_only = True", "Trainer.render_repeats = 2",
        "Trainer.vis_end = 2"]
    jt = trainer_test.synthesize("jax", CORNELL, bindings, "cache")
    jmodel = jconstruct.make_model(jt.config)
    jt._setup_rng()
    jt._load_datasets()
    assert jt.config.use_occlusions and jt.test_dataset.height == RES
    variables = material_trainer._variables(jmodel, 5)
    jt.state = types.SimpleNamespace(params=variables)
    jt.render_eval_fn = jtrain.create_render_fn(jmodel, mesh=jmesh.create_mesh(
        jax.devices()[:1]))
    jt.metric_harness = jimage.MetricHarness(disable_lpips=True)
    jt.save_dir = str(tmp_path / "jax")
    jt._initialize_metrics()

    tt = trainer_test.synthesize("torch", CORNELL, bindings, "cache")
    tt._setup_rng()
    tt._load_datasets()
    tt._setup_model()
    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    tt.save_dir = str(tmp_path / "torch")
    tt._initialize_metrics()
    assert (tt.test_dataset.height, tt.render_repeats) == (RES, 2)

    assert jt.config.compute_albedo_metrics and tt.config.compute_albedo_metrics
    render, rendered = tt.render_test_view, []
    tt.render_test_view = lambda cam_idx, train_frac: rendered.append(cam_idx) or render(
        cam_idx, train_frac)
    with eval_slice.injected(3):
        jt._run_visualization_only()
    with eval_slice.injected(3):
        tt._run_visualization_only()
    assert rendered == [0, 1] and jt.albedo_ratio is tt.albedo_ratio is None
    want, got = (_results(os.path.join(d, "results.txt")) for d in (jt.save_dir, tt.save_dir))
    assert sorted(got) == sorted(want)
    for key, tol in RESULTS.items():
        assert len(got[key]) == len(want[key]) == 3, key
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)
    assert all(np.isfinite(got["psnr"])) and 0 < got["transient_iou"][-1] <= 1

    for view in range(2):
        name = os.path.join("transients", f"{view:06d}.h5")
        with h5py.File(os.path.join(jt.save_dir, name), "r") as fw, \
                h5py.File(os.path.join(tt.save_dir, name), "r") as fg:
            w, g = fw["data"][()], fg["data"][()]
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape == (RES, RES, N_BINS, 3)
        assert np.linalg.norm(g - w) <= SAVED_REL_L2 * np.linalg.norm(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=SAVED_MAX_FRAC * np.abs(w).max())
        assert os.path.exists(os.path.join(tt.save_dir, "cache_time_slice", f"{view:06d}.png"))


def test_train_one_stage_vis_only_on_a_checkpoint_from_disk(scenes, tmp_path):
    """The port alone: train_with_trainer trains the cornell-layout scene
    for two steps, then train_one_stage's --vis_only command restores the
    checkpoint and renders the first view (Trainer.vis_end = 1): results.txt
    written, its transient saved and read back by the port's reader."""
    ckpt = str(tmp_path / "cornell_cache")
    data = [f"--gin_bindings={b}" for b in cornell_bindings(scenes["sim"])]
    trainer = train_with_trainer.main(["--device", "cpu", f"--gin_configs={CORNELL[0]}"] + data
                                      + [f"--gin_bindings=Config.checkpoint_dir = '{ckpt}'",
                                         "--gin_bindings=Config.early_exit_steps = 2"])
    assert type(trainer.dataset).__name__ == "TransientSimulation"
    assert tckpt.latest_checkpoint_step(ckpt) == 2
    tgin.clear_config()
    command = train_one_stage.stage_command(
        ["--scene", "cornell", "-t", "cache", "--vis_only", "--device", "cpu",
         "--batch_size", "16", "--render_chunk_size", "256",
         "--gin_bindings=Trainer.vis_end = 1"], checkpoint_dir=ckpt)
    assert "--gin_bindings=Config.vis_only=True" in command
    # The scene's files and test widths, after the command's own bindings.
    shown = train_with_trainer.main([c for c in command[3:] if c != "--logtostderr"] + data)
    assert shown.state.step == 2 and shown.test_dataset.height == RES
    results = _results(os.path.join(ckpt, "save", "results.txt"))
    assert len(results["psnr"]) == 2 and np.isfinite(results["psnr"][0])
    with hdf5.File(os.path.join(ckpt, "save", "transients", "000000.h5")) as f:
        saved = f["data"][()]
    assert saved.shape == (RES, RES, N_BINS, 3) and saved.dtype == np.float32
    assert np.isfinite(saved).all() and saved.any()
