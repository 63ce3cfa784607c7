"""open_ngp_yobo_egg.gin from an OpenIllumination object on disk, through
both trainers: one cache step, and one step of its material stage
(`material_light_from_scratch` with resampling), each package's batch from
its own loader of the same files (`test_torch_open_loaders.py` writes
them: JPEG views, mask PNGs, per-frame intrinsics), at the config's own
near 0.25 and far 2.0.

The models run at test widths (`test_torch_trainer.NGP_TINY` with the
scene's surface light field narrowed as `test_torch_slf_distance.py`
narrows it, `test_torch_material_trainer.MATERIAL_TINY`), reading the
views at `Config.factor = 4`, as the narrow bindings set it.

Tolerances as in `test_torch_material_trainer.py`: loss terms to 1e-4
relative with an absolute 1e-7 (the smoothness terms to 1e-3), every
gradient leaf to rtol 2e-3 with an absolute 2e-4 x the leaf's largest
entry, and after the trainer's Adam step a parameter within 2 x its
group's learning rate of optax's.
"""

import pytest

import test_torch_material_trainer as material_trainer
import test_torch_open_loaders as open_loaders
import test_torch_slf_distance as slf_distance
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin

OPEN = ["configs/open_ngp_yobo_egg.gin"]
# The fixture's views at 2.5 x the test fixture's size, so that factor 4
# keeps 16 x 21 pixels; the cameras 1.2 from the object, inside far 2.
SIZE = (64, 84)


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


@pytest.fixture(scope="module")
def egg_dir(tmp_path_factory):
    return open_loaders.write_open_illum(str(tmp_path_factory.mktemp("egg")), size=SIZE)


def bindings(data_dir):
    return slf_distance.scene_bindings(OPEN) + [
        "Config.dataset_loader = 'open_illum'", f"Config.data_dir = '{data_dir}'",
        "Config.near = 0.25"]


def _from_disk(monkeypatch):
    """The step helper with JAX's batch from its loader of the scene on disk
    (the helper loads the split with data_dir None, for its data-free
    scenes)."""
    load = jdatasets.load_dataset
    monkeypatch.setattr(material_trainer.jdatasets, "load_dataset",
                        lambda split, _, cfg, **kw: load(split, cfg.data_dir, cfg, **kw))


def test_one_cache_step_from_disk_through_both_trainers(egg_dir, monkeypatch):
    """One cache step from the same weights and draws: every loss term (the
    mask losses of the `com_masks` among them), every gradient leaf, the
    Adam step, and the step's two leveled launches (the SLF's reflectance
    grid and its own grid)."""
    _from_disk(monkeypatch)
    jt, jmodel, tt = material_trainer._trainers(OPEN, bindings(egg_dir), "cache")
    assert type(tt.dataset).__name__ == "OpenIllum"
    assert (tt.config.near, tt.config.far) == (0.25, 2.0)
    assert tt.dataset.images.shape[1:3] == (SIZE[0] // 4, SIZE[1] // 4)
    got = material_trainer._step_parity(jt, jmodel, tt, material_trainer._variables(jmodel, 5),
                                        monkeypatch, ["leveled", "leveled"])
    assert {"data", "cache_data", "mask", "cache_mask"} <= set(got)
    assert got["mask"] > 0


# The leveled launches of one material step: the SLF's reflectance grid (at
# 8 points per query) and its own grid, for its queries along the secondary
# rays (batch x num_secondary_samples), at the surface points (one per
# ray) and at the primary rays' final samples, in the backward's order.
MATERIAL_LAUNCHES = ["leveled"] * 6


def test_one_material_step_from_disk_through_both_trainers(egg_dir, monkeypatch):
    """The README's second stage, `material_light_from_scratch` with
    resampling, one step from the same weights and draws: every loss term,
    every gradient leaf, the Adam step, the step's leveled launches."""
    _from_disk(monkeypatch)
    jt, jmodel, tt = material_trainer._trainers(
        OPEN, bindings(egg_dir) + material_trainer.MATERIAL_TINY + material_trainer.MATERIAL
        + material_trainer.SMOOTH, "material_light_from_scratch")
    assert type(tt.dataset).__name__ == "OpenIllum"
    got = material_trainer._step_parity(jt, jmodel, tt, material_trainer._variables(jmodel, 5),
                                        monkeypatch, MATERIAL_LAUNCHES)
    extra = ["material_ray_sampler", "material_smoothness", "light_sampling",
             "direct_indirect_consistency"]
    assert [k for k in got if k in extra] == extra
    assert got["light_sampling"] != 0 and got["material_smoothness"] != 0
