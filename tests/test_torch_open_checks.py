"""Three user paths that run in the port, held against the JAX package on
the CPU, each from a scene on disk written from numpy seeds:

1. The README's second stage on a capture posed by COLMAP: one
   `material_light_from_scratch` step (with resampling) of the narrow
   `ngp_yobo.gin` from the `llff` scene of `test_torch_colmap.py` (OPENCV
   and SIMPLE_RADIAL cameras, their distortion inverted per pixel), the
   rays cast on the host and in the train step.
2. nero_bell's material stage (`material_light_from_scratch`) through both
   trainers, from the NeRO glossy-synthetic scene of
   `test_torch_loaders.py`.
3. The README's evaluation command (`--vis_only`) on a steady family:
   hotdog's material stage on a TensoIR blender scene with normal and
   albedo PNGs (the `blender_active` loader, which reads the albedos),
   `Config.compute_albedo_metrics` on, through both packages'
   `Trainer._run_visualization_only`: results.txt (per view and the mean,
   albedo PSNR from the run's albedo ratio among them), the albedo ratio
   and the saved renders.

Tolerances as in `test_torch_material_trainer.py`: loss terms to 1e-4
relative with an absolute 1e-7 (the smoothness terms to 1e-3), every
gradient leaf to rtol 2e-3 with an absolute 2e-4 x the leaf's largest
entry, after the trainer's Adam step a parameter within 2 x its group's
learning rate of optax's. The eval render as `test_torch_eval_slice.py`
holds a material model's outputs: 1e-3 relative with an absolute 1e-3 x the
output's largest entry (secondary rays turned near grazing angles by 1e-5
moves of a predicted normal); so the metrics to 1e-2 dB (PSNR, albedo
PSNR) and 1e-3 (SSIM), and the albedo ratio to 1e-3 relative.
"""

import ast
import dataclasses
import os
import types

import jax
import numpy as np
import pytest

import test_torch_colmap as colmap_test
import test_torch_eval_slice as eval_slice
import test_torch_loader_steps as loader_steps
import test_torch_loaders as loaders
import test_torch_material_trainer as material_trainer
import test_torch_trainer as trainer_test
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.ops import image as jimage
from neural_radiance_caching_tpu.parallel import mesh as jmesh
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees
from neural_radiance_caching_tpu_torch.utils import weights
from test_torch_material_slice import jax_encoder_switch_restored  # noqa: F401 (fixture)

MATERIAL = (material_trainer.MATERIAL_TINY + material_trainer.MATERIAL
            + material_trainer.SMOOTH)
STAGE = "material_light_from_scratch"
EXTRA = ["material_ray_sampler", "material_smoothness", "light_sampling",
         "direct_indirect_consistency"]


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


def _from_disk(monkeypatch, cast=None):
    """`_step_parity`'s JAX batch from the JAX loader of the scene on disk,
    its rays cast by `cast` where the port casts them in the step."""
    load = jdatasets.load_dataset

    def load_from_disk(split, _, cfg, **kw):
        data = load(split, cfg.data_dir, cfg, **kw)
        if cast is not None:
            next_train = data.next_train
            data.next_train = lambda: (lambda b: b.replace(rays=cast(data, b.rays)))(next_train())
        return data

    monkeypatch.setattr(material_trainer.jdatasets, "load_dataset", load_from_disk)


# --- 1. the README's second stage on a COLMAP scene ---------------------------------------

@pytest.fixture(scope="module")
def colmap_dir(tmp_path_factory):
    return colmap_test.write_llff_colmap(str(tmp_path_factory.mktemp("colmap")))


@pytest.mark.parametrize("in_step", [False, True])
def test_readme_material_stage_from_a_colmap_scene(colmap_dir, in_step, monkeypatch):
    """One `material_light_from_scratch` step of the narrow ngp_yobo.gin (the
    llff loader its default) from the distorted COLMAP scene at factor 4:
    every loss term, every gradient leaf, the Adam step; the rays cast on
    the host, or in the step (JAX's jnp cast of its Pixels, op by op). No
    scatter launch: ngp_yobo's final level takes density normals (the plain
    encoder) and its light sampler has no grid."""
    _from_disk(monkeypatch, colmap_test._jax_in_step if in_step else None)
    bindings = trainer_test.NGP_TINY + MATERIAL + [
        "Config.dataset_loader = 'llff'", f"Config.data_dir = '{colmap_dir}'",
        "Config.near = 0.2", f"Config.cast_rays_in_train_step = {in_step}"]
    jt, jmodel, tt = material_trainer._trainers(colmap_test.NGP, bindings, STAGE)
    assert type(tt.dataset).__name__ == "LLFF" and tt.dataset.distortion_params is not None
    next_train = tt.dataset.next_train
    batches = []
    tt.dataset.next_train = lambda: batches.append(next_train()) or batches[-1]
    got = material_trainer._step_parity(jt, jmodel, tt, material_trainer._variables(jmodel, 5),
                                        monkeypatch, [])
    assert isinstance(batches[0].rays, tpytrees.Pixels) == in_step
    assert [k for k in got if k in EXTRA] == EXTRA
    assert got["light_sampling"] != 0 and got["material_smoothness"] != 0


# --- 2. nero_bell's material stage --------------------------------------------------------

# The leveled launches of one bell material step: the SLF's reflectance grid
# for the cache's queries along the secondary rays, at the surface points
# and at the primary rays' samples, in the backward's order.
BELL_LAUNCHES = ["leveled"] * 3


@pytest.fixture(scope="module")
def bell_dir(tmp_path_factory):
    return loaders.write_glossy(str(tmp_path_factory.mktemp("bell")))


def test_nero_bell_material_stage_from_disk(bell_dir, monkeypatch):
    """One `material_light_from_scratch` step of nero_ngp_yobo_bell.gin (its
    SLF narrowed) from the glossy-synthetic scene through both trainers,
    each package's batch from its own loader (the flattened pixel stream):
    every loss term, every gradient leaf, the Adam step, the launches."""
    _from_disk(monkeypatch)
    bindings = loader_steps.bindings("nero_bell", bell_dir) + MATERIAL
    jt, jmodel, tt = material_trainer._trainers(loader_steps.BELL, bindings, STAGE)
    assert type(tt.dataset).__name__ == "GlossySynthetic"
    got = material_trainer._step_parity(jt, jmodel, tt, material_trainer._variables(jmodel, 5),
                                        monkeypatch, BELL_LAUNCHES)
    assert [k for k in got if k in EXTRA] == EXTRA
    assert got["light_sampling"] != 0


# --- 3. --vis_only on a steady family -----------------------------------------------------

RESULTS = {"psnr": dict(rtol=0, atol=1e-2), "ssim": dict(rtol=0, atol=1e-3),
           "albedo_psnr": dict(rtol=0, atol=1e-2)}
RENDER = 1e-3


def _results(path):
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
    bindings = trainer_test.NGP_TINY + MATERIAL + [
        "Config.dataset_loader = 'blender_active'", f"Config.data_dir = '{hotdog_dir}'",
        "Config.near = 2.0", "Config.factor = 1", "Config.compute_albedo_metrics = True", "Trainer.vis_only = True",
        "Config.vis_only = True", "Trainer.vis_end = 2"]
    files = loader_steps.HOTDOG
    jt, jmodel, tt = material_trainer._trainers(files, bindings, STAGE)
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

    want, got = (_results(os.path.join(d, "results.txt")) for d in (jt.save_dir, tt.save_dir))
    assert sorted(got) == sorted(want)
    for key, tol in RESULTS.items():
        assert len(got[key]) == len(want[key]) == 3, key
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)
    assert all(np.isfinite(got["albedo_psnr"]))
    ratio = [np.load(os.path.join(d, "albedo_ratio.npy")) for d in (tt.save_dir, jt.save_dir)]
    np.testing.assert_allclose(*ratio, rtol=1e-3)
    for view in range(2):
        g, w = (np.load(os.path.join(d, "color", f"{view:06d}.npy"))
                for d in (tt.save_dir, jt.save_dir))
        assert g.shape == w.shape == (loaders.RES, loaders.RES, 3)
        np.testing.assert_allclose(g, w, rtol=RENDER, atol=RENDER * np.abs(w).max())

