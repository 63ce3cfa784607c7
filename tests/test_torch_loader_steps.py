"""One cache step of scenes read from disk, through both trainers: the
README's hotdog (`nerf_ngp_yobo_hotdog.gin`) from a blender scene,
`orb_ngp_yobo_teapot.gin` from an ORB scene (EXR images, mask PNGs) and
`nero_ngp_yobo_bell.gin` from a NeRO glossy-synthetic scene (pickled
cameras, RGBA and 16-bit depth PNGs, the flattened pixel stream), each
loaded by the JAX loader and by the port's from the same files
(`test_torch_loaders.py` writes them); and the entry point training the
hotdog's cache stage from its scene.

The models run at test widths (`test_torch_trainer.NGP_TINY`, with the
scene's surface light field narrowed as `test_torch_slf_distance.py`
narrows it), at each scene's own near plane, reading the images at
`Config.factor = 4`, as the narrow bindings set it (blender keeps the
JSON's intrinsics there, as JAX does).

Tolerances as in `test_torch_invprop_scenes.py`: loss terms to 1e-4
relative with an absolute 1e-7, every gradient leaf to rtol 2e-3 with an
absolute 2e-4 x the leaf's largest entry, and after the trainer's Adam step
a parameter within 2 x its group's learning rate of optax's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import test_torch_loaders as loaders
import test_torch_material_slice as material_slice
import test_torch_material_trainer as material_trainer
import test_torch_slf_distance as slf_distance
import test_torch_trainer as trainer_test
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu_torch import train_with_trainer
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.utils import checkpoints as tckpt
from neural_radiance_caching_tpu_torch.utils import weights

HOTDOG = ["configs/nerf_ngp_yobo_hotdog.gin"]
TEAPOT = ["configs/orb_ngp_yobo_teapot.gin"]
BELL = ["configs/nero_ngp_yobo_bell.gin"]
# scene: (gin files, loader, the fixture's writer, the config's near plane,
# narrow bindings, the step's scatter launches). The hotdog's final density
# level takes density normals (the plain encoder): no launch; the SLF's
# reflectance grid (nero, orb) and orb's own SLF grid each launch the
# leveled kernel at these widths.
SCENES = {
    "hotdog": (HOTDOG, "blender", loaders.write_blender, 2.0, trainer_test.NGP_TINY, []),
    "orb_teapot": (TEAPOT, "orb", loaders.write_orb, 0.25, slf_distance.scene_bindings(TEAPOT),
                   ["leveled", "leveled"]),
    "nero_bell": (BELL, "glossy_synthetic", loaders.write_glossy, 1.0,
                  slf_distance.scene_bindings(BELL), ["leveled"]),
}
TRAIN_FRAC = 0.25
GRAD = material_trainer.GRAD
LOSS = trainer_test.LOSS


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


@pytest.fixture(scope="module")
def scene_dirs(tmp_path_factory):
    out = {}
    for scene, (_, _, write, *_) in SCENES.items():
        root = tmp_path_factory.mktemp(scene)
        out[scene] = write(str(root))
    return out


def bindings(scene, data_dir):
    _, loader, _, near, narrow, _ = SCENES[scene]
    return narrow + [f"Config.dataset_loader = '{loader}'", f"Config.data_dir = '{data_dir}'",
                     f"Config.near = {near}"]


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_one_cache_step_from_disk_through_both_trainers(scene, scene_dirs, monkeypatch):
    """One cache step from the same weights and draws (every leaf from
    U(-0.5, 0.5), the tables at their init range), each package's batch from
    its own loader of the scene: every loss term (the mask losses among
    them), every gradient leaf, the Adam step, the step's scatter
    launches."""
    files, _, _, _, _, launches = SCENES[scene]
    jt, jmodel, tt = material_trainer._trainers(files, bindings(scene, scene_dirs[scene]),
                                                "cache")
    jcfg = jt.config
    jdata = jdatasets.load_dataset("train", jcfg.data_dir, jcfg)
    assert type(tt.dataset).__name__ == type(jdata).__name__
    variables = material_trainer._variables(jmodel, 5)
    jbatch = jdata.next_train()
    with material_slice.injected(7), jhash.xla_encoder_scope():
        (_, jlosses_), jgrad = slf_distance.jax_step_loss(jmodel, jcfg, TRAIN_FRAC)(
            variables, jbatch)
    jgrad = jlosses.clip_gradients(jax.tree_util.tree_map(jnp.nan_to_num, jgrad), jcfg)
    jstate, _ = jtrain.create_optimizer(jcfg, variables)
    updates, _ = jstate.tx.update(jgrad, jstate.opt_state, variables)
    jnew = material_slice._leaves(optax.apply_updates(variables, updates)["params"])

    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    calls = []
    material_slice._counting_scatters(monkeypatch, calls)
    tbatch = tt.dataset.next_train()
    np.testing.assert_allclose(tbatch.rgb.numpy(), jbatch.rgb, rtol=loaders.IMAGE_TOL,
                               atol=loaders.IMAGE_TOL)
    with material_slice.injected(7):
        state, stats = tt.train_step(tt.rng, tt.state, tbatch, TRAIN_FRAC)
    assert calls == launches

    got = {k: float(v) for k, v in stats["losses"].items()}
    assert sorted(got) == sorted(jlosses_)
    assert {"data", "cache_data", "mask", "cache_mask"} <= set(got)
    assert got["mask"] > 0
    for k, v in jlosses_.items():
        np.testing.assert_allclose(got[k], float(v), err_msg=k, **LOSS)
    want = material_slice._leaves(jgrad["params"])
    params = dict(tt.model.named_parameters())
    assert sorted(params) == sorted(want)
    for k, p in params.items():
        material_slice._close(p.grad.numpy(), material_slice._tr(k, want[k]), *GRAD, k)
    for k, p in params.items():
        lr = max(g["lr"] for g in state.optimizer.param_groups
                 if any(q is p for q in g["params"]))
        np.testing.assert_allclose(p.detach().numpy(), material_slice._tr(k, jnew[k]),
                                   rtol=0, atol=2 * lr + 1e-7, err_msg=k)


def test_entry_point_trains_hotdog_from_disk(scene_dirs, tmp_path):
    """The README's first hotdog stage through the entry point on the CPU,
    reading the blender scene: 2 steps, the train log with the mask losses,
    the checkpoint, and an eval view of the test split."""
    ckpt = str(tmp_path / "hotdog_cache")
    args = bindings("hotdog", scene_dirs["hotdog"]) + [
        "Trainer.stage = 'cache'", f"Config.checkpoint_dir = '{ckpt}'",
        "Config.early_exit_steps = 2", "Config.print_every = 1",
        "Config.train_render_every = 2",
        "Config.metric_harness_train_config = {'disable_lpips': True}"]
    trainer = train_with_trainer.main(["--device", "cpu", f"--gin_configs={HOTDOG[0]}"]
                                      + [f"--gin_bindings={b}" for b in args])
    assert type(trainer.dataset).__name__ == "Blender"
    assert (trainer.test_dataset.height, trainer.test_dataset.width) == (4, 4)
    assert tckpt.latest_checkpoint_step(ckpt) == 2
    log = [json.loads(line) for line in open(os.path.join(ckpt, "train_log.jsonl"))]
    assert {"loss/data", "loss/mask", "loss/cache_mask"} <= set(log[-1])
    assert all(np.isfinite(v) for r in log for k, v in r.items() if k.startswith("loss"))
