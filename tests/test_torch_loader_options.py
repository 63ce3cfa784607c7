"""Loader options the port once refused, against the JAX package on the CPU:
ORB's `vis_render_path`, patch batches and the patch loss, SyntheticSpheres'
physical shadings and its own multi-illumination, and panoramic rays cast
in the train step.

Tolerances:
- ORB's render path: the arrays equal, the poses to 1e-6 (both run the
  same numpy ellipse in float64).
- Patch batches: indices, rgb and host-cast rays bit for bit (the same
  numpy draws in JAX's order), for p = 2 and 4; the Pixels batches of
  `cast_rays_in_train_step` equal too.
- The patch loss: one `synthetic_spheres.gin` cache step (physical glossy,
  multi-illumination, patch_size 4) through both trainers, every loss term
  to 1e-4 relative and each gradient leaf as the trainer tests hold them
  (rtol 2e-3, atol 2e-4 of the leaf's largest entry).
- SyntheticSpheres: images, alphas, lights and the albedo, normal and
  roughness maps to 1e-6 (both trace the same numpy).
- Panoramic rays cast in the step: float32 tensors against jnp's cast, run
  op by op, to 1e-6 relative and 1e-6 absolute, and against the host's
  float64 cast to 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_loaders as loaders
import test_torch_material_slice as material_slice
import test_torch_trainer as trainer_test
import test_torch_transient_loaders as transient_loaders
from neural_radiance_caching_tpu.data import camera_utils as jcam
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine.configs import Config as JConfig
from neural_radiance_caching_tpu.models import construct as jconstruct
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu_torch.data import camera_utils as tcam
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.engine.configs import Config as TConfig
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees
from neural_radiance_caching_tpu_torch.utils import weights


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    trainer_test.jgin.clear_config()
    trainer_test.tgin.clear_config()


@pytest.fixture(scope="module")
def orb_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("orb")
    return {"orb": loaders.write_orb(str(root))}


# --- ORB's render path ---------------------------------------------------------------------


def test_orb_render_path_equals_jax(orb_scene):
    """With `vis_render_path` the test split is a 120-frame ellipse around
    the first test pose (relative to it, y flipped), each frame test image
    0 and its mask; the train split is as without it."""
    want, got = loaders.loader_pair(orb_scene, "orb", "test", vis_render_path=True)
    assert got.num_images == want.num_images == 120
    for name in loaders.ARRAYS:
        w = getattr(want, name)
        assert (getattr(got, name) is None) == (w is None), name
        if w is not None:
            np.testing.assert_array_equal(getattr(got, name), w, err_msg=name)
    for name in ("camtoworlds", "lights", "pixtocams"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0, atol=1e-6,
                                   err_msg=name)
    _, plain = loaders.loader_pair(orb_scene, "orb", "test")
    np.testing.assert_array_equal(got.images, np.repeat(plain.images[:1], 120, 0))
    loaders._assert_batch(got.generate_ray_batch(5), want.generate_ray_batch(5), loaders._exact)
    _, train = loaders.loader_pair(orb_scene, "orb", "train", vis_render_path=True)
    _, train_plain = loaders.loader_pair(orb_scene, "orb", "train")
    np.testing.assert_array_equal(train.camtoworlds, train_plain.camtoworlds)
    np.testing.assert_array_equal(train.images, train_plain.images)


def test_orb_render_path_with_per_frame_intrinsics_fails_as_jax(tmp_path):
    """JAX's quirk, kept: with one set of intrinsics per test frame, the
    path's frames past the test split's count have none, and both packages'
    host casts raise IndexError there; frame 0 casts alike."""
    root = loaders.write_orb(str(tmp_path))
    for split in ("train", "test"):
        path = os.path.join(root, f"transforms_{split}.json")
        with open(path) as f:
            meta = json.load(f)
        for frame in meta["frames"]:
            frame.update({k: meta[k] for k in ("fl_x", "fl_y", "cx", "cy")})
        for k in ("fl_x", "fl_y", "cx", "cy"):
            del meta[k]
        with open(path, "w") as f:
            json.dump(meta, f)
    want, got = loaders.loader_pair({"orb": root}, "orb", "test", vis_render_path=True)
    assert got.pixtocams.shape[0] == want.pixtocams.shape[0] == loaders.VIEWS
    loaders._assert_batch(got.generate_ray_batch(0), want.generate_ray_batch(0), loaders._exact)
    for dataset in (want, got):
        with pytest.raises(IndexError):
            dataset.generate_ray_batch(loaders.VIEWS)


# --- patch batches -------------------------------------------------------------------------


def _spheres_pair(**kw):
    kw = dict(dict(batch_size=64, num_dataset_images=3), **kw)
    want = jdatasets.SyntheticSpheres("train", None, JConfig(**kw), resolution=16)
    got = tdatasets.SyntheticSpheres("train", None, TConfig(**kw), resolution=16, device="cpu")
    return want, got


@pytest.mark.parametrize("in_step", [False, True], ids=["host", "pixels"])
@pytest.mark.parametrize("p,border", [(2, 0), (4, 0), (4, 3)])
def test_patch_batches_equal_jax(p, border, in_step):
    """Three patch batches: n // p^2 corners inside the masked border, each
    patch's p^2 pixels contiguous; the same draws as JAX (x corners, y
    corners, then the camera), cast on the host or shipped as Pixels."""
    want, got = _spheres_pair(patch_size=p, num_border_pixels_to_mask=border,
                              cast_rays_in_train_step=in_step)
    for _ in range(3):
        jbatch, tbatch = want.next_train(), got.next_train()
        assert isinstance(tbatch.rays, tpytrees.Pixels) == in_step
        loaders._assert_batch(tbatch, jbatch, loaders._exact)
        x = tbatch.rays.pix_x_int.numpy().reshape(-1, p * p)
        y = tbatch.rays.pix_y_int.numpy().reshape(-1, p * p)
        cam = tbatch.rays.cam_idx.numpy().reshape(-1, p * p)
        assert len(x) == 64 // (p * p)
        np.testing.assert_array_equal(x - x[:, :1], np.tile(np.arange(p), p)[None].repeat(
            len(x), 0))
        np.testing.assert_array_equal(y - y[:, :1], np.repeat(np.arange(p), p)[None].repeat(
            len(y), 0))
        assert (cam == cam[:, :1]).all()
        assert x.min() >= border and x.max() < 16 - border


def test_flattened_and_transient_streams_ignore_patches(tmp_path):
    """Loaders that draw from a pixel table (NeRO's glossy synthetic) or a
    transient sample stream ignore `patch_size`, as in JAX: their batches
    equal JAX's and their own without patches."""
    scene = {"glossy_synthetic": loaders.write_glossy(str(tmp_path / "glossy"))}
    want, got = loaders.loader_pair(scene, "glossy_synthetic", patch_size=4)
    _, plain = loaders.loader_pair(scene, "glossy_synthetic")
    for _ in range(2):
        tbatch = got.next_train()
        loaders._assert_batch(tbatch, want.next_train(), loaders._exact)
        loaders._assert_batch(tbatch, plain.next_train(), loaders._exact)
    scenes = {"sim": transient_loaders.write_transient_scene(str(tmp_path / "sim"), "sim")}
    want, got = transient_loaders.loader_pair(scenes, "sim", "plain", patch_size=4)
    _, plain = transient_loaders.loader_pair(scenes, "sim", "plain")
    tbatch = got.next_train()
    loaders._assert_batch(tbatch, want.next_train(), loaders._exact)
    loaders._assert_batch(tbatch, plain.next_train(), loaders._exact)


# --- the patch loss --------------------------------------------------------------------------


PATCH = ["Config.patch_size = 4", "Config.patch_loss_mult = 0.3",
         "Config.bilateral_strength = 2.0", "Config.patch_variance_weighting = 1.5",
         "Config.synthetic_spheres_shading = 'physical_glossy'",
         "Config.synthetic_spheres_multi_illum = True", "Config.batch_size = 64"]


def test_patch_loss_cache_step_through_both_trainers(monkeypatch):
    """One synthetic_spheres.gin cache step on patch batches of 4 x 4 from
    the glossy multi-illumination scene, through both trainers: every loss
    term (the patch loss of both outputs among them), every gradient leaf,
    one leveled launch."""
    bindings = trainer_test.TINY + PATCH
    jt = trainer_test.synthesize("jax", [trainer_test.SPHERES], bindings, "cache")
    jcfg = jt.config
    jmodel = jconstruct.make_model(jcfg)
    variables = trainer_test._jax_variables(jmodel, 5)
    jbatch = jdatasets.load_dataset("train", None, jcfg).next_train()
    with material_slice.injected(7), jhash.xla_encoder_scope():
        (_, jlosses), jgrad = trainer_test.jax_loss(jmodel, jcfg, 0.0)(variables, jbatch)

    tt = trainer_test.synthesize("torch", [trainer_test.SPHERES], bindings, "cache")
    tt._setup_rng()
    tt._load_datasets()
    tt._setup_model()
    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    calls = []
    material_slice._counting_scatters(monkeypatch, calls)
    tbatch = tt.dataset.next_train()
    np.testing.assert_array_equal(tbatch.rgb.numpy(), jbatch.rgb)
    with material_slice.injected(7):
        _, stats = tt.train_step(tt.rng, tt.state, tbatch, 0.0)
    assert calls == ["leveled"]
    got = {k: float(v) for k, v in stats["losses"].items()}
    assert sorted(got) == sorted(jlosses)
    assert {"patch", "cache_patch"} <= set(got) and got["patch"] > 0
    for k, v in jlosses.items():
        np.testing.assert_allclose(got[k], float(v), err_msg=k, **trainer_test.LOSS)
    want = material_slice._leaves(jgrad["params"])
    for k, p in tt.model.named_parameters():
        material_slice._close(p.grad.numpy(), material_slice._tr(k, want[k]), 2e-3, 2e-4, k)


# --- SyntheticSpheres -----------------------------------------------------------------------


SPHERE_CASES = [(s, m, t) for s in ("legacy", "physical", "physical_glossy")
                for m in (False, True) for t in (False, True)]


@pytest.mark.parametrize("shading,multi_illum,transient", SPHERE_CASES)
def test_sphere_scenes_equal_jax(shading, multi_illum, transient):
    """Both splits of each shading, with and without per-view lights, steady
    and transient: the images, alphas, lights and maps."""
    kw = dict(num_dataset_images=4, compute_albedo_metrics=True, compute_normal_metrics=True,
              synthetic_spheres_shading=shading, synthetic_spheres_multi_illum=multi_illum)
    if transient:
        kw.update(use_transient=True, n_bins=48, exposure_time=0.2,
                  synthetic_spheres_impulse_sigma=1.5)
    for split in ("train", "test"):
        want = jdatasets.SyntheticSpheres(split, None, JConfig(**kw), resolution=12)
        got = tdatasets.SyntheticSpheres(split, None, TConfig(**kw), resolution=12,
                                         device="cpu")
        for name in ("images", "alphas", "masks", "lights", "albedo_images", "normal_images",
                     "camtoworlds", "pixtocams", "impulse_response"):
            w = getattr(want, name)
            assert (getattr(got, name) is None) == (w is None), name
            if w is not None:
                np.testing.assert_allclose(getattr(got, name), w, rtol=0, atol=1e-6,
                                           err_msg=f"{split} {name}")
        assert hasattr(got, "roughness_images") == hasattr(want, "roughness_images")
        if shading == "physical_glossy":
            np.testing.assert_array_equal(got.roughness_images, want.roughness_images)
        if multi_illum:
            assert len(np.unique(got.lights, axis=0)) == 4


def test_unknown_sphere_shading_raises_as_jax():
    """An unknown `Config.synthetic_spheres_shading` raises by name in both
    packages."""
    cfg = dict(num_dataset_images=2, synthetic_spheres_shading="pbr")
    for make in (lambda: jdatasets.SyntheticSpheres("train", None, JConfig(**cfg), resolution=8),
                 lambda: tdatasets.SyntheticSpheres("train", None, TConfig(**cfg), resolution=8,
                                                    device="cpu")):
        with pytest.raises(ValueError, match="synthetic_spheres_shading"):
            make()


# --- panoramic rays in the step ------------------------------------------------------------


def test_panoramic_in_step_cast_equals_jax():
    """Equirectangular rays cast on tensors (float32, JAX's op order)
    against jnp's cast of the same pixels, op by op, and against the host's
    float64 cast, with two cameras and per-pixel jitter off."""
    h, w = 16, 32
    pixtocams = np.diag(np.array([2.0 * np.pi / w, np.pi / h, 1.0], np.float32))[None]
    camtoworlds = tcam.generate_spherical_poses(2, radius=2.0, seed=5)
    lights = camtoworlds[:, :3, -1]
    rng = np.random.RandomState(0)
    n = 200
    pixels = tpytrees.Pixels(
        pix_x_int=rng.randint(0, w, n), pix_y_int=rng.randint(0, h, n),
        lossmult=np.ones((n, 1), np.float32), near=np.full((n, 1), 0.1, np.float32),
        far=np.full((n, 1), 5.0, np.float32), cam_idx=rng.randint(0, 2, (n, 1)).astype(np.int32),
        light_idx=rng.randint(0, 2, (n, 1)).astype(np.int32))
    cameras = (pixtocams, camtoworlds, None, None)
    pano = tcam.ProjectionType.PANORAMIC
    tensors = tpytrees.Pixels(**{f: torch.as_tensor(getattr(pixels, f))
                                 for f in pixels.__dataclass_fields__
                                 if getattr(pixels, f) is not None})
    got = tcam.cast_ray_batch(tcam.cameras_to(cameras, "cpu"), torch.as_tensor(lights), tensors,
                              camtype=pano)
    host = tcam.cast_ray_batch(cameras, lights, pixels, camtype=pano)
    jcams = (jnp.asarray(pixtocams), jnp.asarray(camtoworlds), None, None)
    jpixels = jax.tree_util.tree_map(jnp.asarray, jdatasets.pytrees.Pixels(
        **{f: getattr(pixels, f) for f in pixels.__dataclass_fields__
           if getattr(pixels, f) is not None}))
    with jax.disable_jit():
        want = jcam.cast_ray_batch(jcams, jnp.asarray(lights), jpixels,
                                   camtype=jcam.ProjectionType.PANORAMIC, xnp=jnp)
    for name in ("origins", "directions", "viewdirs", "radii", "imageplane", "look", "up"):
        g = getattr(got, name)
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(host, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # A panorama sees every direction: the rays' y components span [-1, 1].
    assert got.viewdirs[:, 1].min() < -0.8 and got.viewdirs[:, 1].max() > 0.8
