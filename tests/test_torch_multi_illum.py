"""Training under several illuminations (`Config.multi_illumination`, the
`_multi_illum` suffix of `train_one_stage.py`) against the JAX package, on
an OpenIllumination object written from numpy seeds with illuminations 013,
011 and 009 and their three Radiance env maps three levels above `output/`.

- The `open_illum` loader under `multi_illumination`: the images of the
  three illuminations, each pixel's light index, the cameras repeated once
  per illumination, the three env maps' tables concatenated along JAX's
  axes, both splits, `vis_only` (013 alone), batches and eval views.
- The heads alone, from carried weights: the surface light field with its
  illumination embedding, its per-illumination rgb head and the
  illumination's rotation of the query directions; the light sampler with
  its embedding and one mixture per illumination.
- One cache step and one `material_light_from_scratch` step of
  open_ngp_yobo_egg.gin through both trainers with the embeddings of the
  four shaders on (`use_illumination_feature`), and
  `Config.multiple_illumination_outputs = False`: every loss term, every
  gradient leaf, the Adam step, equal parameter names, the launches.
- The reference gaps: the configs' own `Config.multiple_illumination_outputs
  = True` (the SLF's ambient head is sized for every illumination and never
  selected), the ground-truth illumination, structured light; each raising
  in JAX and in the port, the port naming JAX's failure.
- The light-sampling NaN: with `Config.multiple_illumination_outputs =
  False` the light sampler's output layer holds one mixture, and its field
  `multiple_illumination_outputs` (True in the configs) still picks the
  ray's by its light index: JAX's gather out of bounds (take_along_axis's
  fill mode) gives NaN for the rays of illuminations 011 and 009, so the
  light_sampling loss is NaN in JAX, and in the port, which computes it as
  JAX does.
- `_rotate_illum`'s quirk: it acts as `_multi_illum`.

Tolerances: the loaders' arrays as `test_torch_open_loaders.py` holds them
(images to 2 float32 ulps of white, everything else bit for bit); the heads'
outputs to rtol 1e-5 / atol 1e-5 (`test_torch_material_slice.py`'s light
sampler) and their gradient leaves to `GRAD` (rtol 2e-3, an absolute 2e-4 x
the leaf's largest entry); the steps as `test_torch_material_trainer.py`:
loss terms to 1e-4 relative with an absolute 1e-7 (the smoothness terms to
1e-3), every gradient leaf to `GRAD`, after the trainer's Adam step a
parameter within 2 x its group's learning rate of optax's.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import test_torch_loaders as loaders
import test_torch_material_slice as material_slice
import test_torch_material_trainer as material_trainer
import test_torch_open_loaders as open_loaders
import test_torch_open_steps as open_steps
import test_torch_relight_inputs as relight
import test_torch_slf_distance as slf_distance
import test_torch_trainer as trainer_test
import test_torch_transient_trainer as transient_trainer
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import configs as jconfigs
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.models import construct as jconstruct
from neural_radiance_caching_tpu.models import light_sampler as jlight
from neural_radiance_caching_tpu.models import surface_light_field as jslf
from neural_radiance_caching_tpu.ops import coord as jcoord
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch import flagship
from neural_radiance_caching_tpu_torch import train_one_stage as ttrain_one_stage
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.engine import configs as tconfigs
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.models import construct as tconstruct
from neural_radiance_caching_tpu_torch.models import light_sampler as tlight
from neural_radiance_caching_tpu_torch.models import surface_light_field as tslf
from neural_radiance_caching_tpu_torch.ops import coord as tcoord
from neural_radiance_caching_tpu_torch.utils import weights

OPEN = open_steps.OPEN
ILLUMS = ("013", "011", "009")
HEADS = ("NeRFMLP", "MaterialMLP", "LightMLP", "SurfaceLightFieldMLP")
FEATURES = [f"{c}.use_illumination_feature = True" for c in HEADS]
# The `_multi_illum` stage's binding, with the one form of the outputs that
# JAX can run.
MULTI = ["Config.multi_illumination = True", "Config.multiple_illumination_outputs = False"]
GRAD = material_trainer.GRAD
OUT = dict(rtol=1e-5, atol=1e-5)
JConfig, TConfig = jconfigs.Config, tconfigs.Config


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


def write_multi_illum(root, size=open_steps.SIZE):
    """`test_torch_open_loaders.write_open_illum`'s object (illumination
    013) under `root/scenes/egg`, with the same views under illuminations
    011 and 009 (other seeded JPEGs) and the three illuminations' Radiance
    env maps in `root/scenes/env_maps/hdrs/` (8 x 16 each). Returns the
    data_dir."""
    out = open_loaders.write_open_illum(os.path.join(root, "scenes", "egg"), size=size)
    lights = os.path.join(os.path.dirname(out), "Lights")
    names = sorted(os.listdir(os.path.join(lights, "013", "raw_undistorted")))
    for k, illum in enumerate(ILLUMS[1:]):
        for i, name in enumerate(names):
            rgb = np.random.RandomState(200 + 20 * k + i).rand(*size, 3)
            open_loaders._jpeg(os.path.join(lights, illum, "raw_undistorted", name), rgb)
    hdrs = os.path.join(root, "scenes", "env_maps", "hdrs")
    os.makedirs(hdrs)
    for k, illum in enumerate(ILLUMS):
        relight.write_hdr(os.path.join(hdrs, f"{illum}.hdr"), relight.hdr_image(30 + k, 8, 16),
                          "rle")
    return out


@pytest.fixture(scope="module")
def multi_dir(tmp_path_factory):
    return write_multi_illum(str(tmp_path_factory.mktemp("multi")))


# --- the loader --------------------------------------------------------------------------

TABLES = relight.TABLES


def _loader_pair(data_dir, split, size=open_steps.SIZE, **extra):
    kw = dict(dataset_loader="open_illum", batch_size=32, multi_illumination=True,
              **dict(open_loaders.LOADER_CONFIG["open_illum"], **extra))
    want = jdatasets.load_dataset(split, data_dir, JConfig(**kw))
    got = tdatasets.load_dataset(split, data_dir, TConfig(**kw), device="cpu")
    return want, got


@pytest.mark.parametrize("split,vis_only", [("train", False), ("test", False), ("train", True)])
def test_multi_illum_loader_equals_jax(multi_dir, split, vis_only):
    """Arrays, light indices, the repeated cameras, the env-map tables, the
    first batches and an eval view of each illumination."""
    want, got = _loader_pair(multi_dir, split, vis_only=vis_only)
    views = open_loaders.OPEN_VIEWS[split]
    n_illum = 1 if vis_only else 3
    assert got.images.shape[0] == want.images.shape[0] == n_illum * views
    for name in open_loaders.ARRAYS + TABLES + ("camtoworlds", "pixtocams", "lights"):
        w = getattr(want, name, None)
        if w is None:
            assert getattr(got, name, None) is None, name
        elif name in open_loaders.ARRAYS and name != "light_idx":
            loaders._close_images(getattr(got, name), w, name)
        else:
            g = getattr(got, name)
            assert np.asarray(g).dtype == np.asarray(w).dtype, name
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)
    assert [int(got.light_idx[i].max()) for i in range(0, n_illum * views, views)] == list(
        range(n_illum))
    assert got.env_map.shape[-2] == got.env_map_pmf.shape[-1] == n_illum
    np.testing.assert_array_equal(got.camtoworlds[:views], got.camtoworlds[-views:])
    if n_illum > 1:
        assert not np.array_equal(got.images[:views], got.images[views:2 * views])
    for _ in range(2):
        tb, jb = got.next_train(), want.next_train()
        loaders._assert_batch(tb, jb, loaders._exact)
    if n_illum > 1:
        assert set(np.unique(tb.rays.light_idx.numpy())) == {0, 1, 2}
    for cam in range(0, n_illum * views, views):
        tb, jb = got.generate_ray_batch(cam), want.generate_ray_batch(cam)
        loaders._assert_batch(tb, jb, loaders._exact)
        assert set(np.unique(tb.rays.light_idx.numpy())) == {cam // views}


def test_multi_illum_loader_runs_without_pil_or_jax(multi_dir):
    """The multi-illumination loader reads the object with PIL, OpenCV,
    imageio, h5py and JAX hidden (the card's machine has none of them)."""
    hidden = ("PIL", "cv2", "imageio", "h5py", "jax", "neural_radiance_caching_tpu")
    code = (
        "import sys\n"
        f"for m in {hidden!r}:\n"
        "    sys.modules[m] = None\n"
        "from neural_radiance_caching_tpu_torch.data import datasets\n"
        "from neural_radiance_caching_tpu_torch.engine.configs import Config\n"
        f"d = datasets.load_dataset('train', {multi_dir!r}, Config(dataset_loader='open_illum',\n"
        "    batch_size=8, factor=2, near=0.25, multi_illumination=True), device='cpu')\n"
        "assert d.env_map.shape[-2] == 3 and int(d.light_idx.max()) == 2\n"
        "print('ok')\n")
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


# --- the heads alone ---------------------------------------------------------------------

# (Config.multiple_illumination_outputs, the SLF's rotation of the queries)
SLF_CASES = {"outputs_rotated": (True, True), "one_output": (False, False)}


def _multi_config(cfg, outputs, rotate=False):
    return dataclasses.replace(cfg, multi_illumination=True, num_illuminations=3,
                               multiple_illumination_outputs=outputs,
                               rotate_illumination=rotate, light_rotations=[0.0, 120.0, 240.0])


def _nan_free(x, xnp):
    return xnp.where(xnp.isnan(x), xnp.zeros_like(x), x)


@pytest.mark.parametrize("case", sorted(SLF_CASES))
def test_slf_with_illuminations_matches_jax(case):
    """open's narrowed SLF with its illumination embedding: per-illumination
    rgb (selected by the ray's light index) and ambient (left unselected, as
    in JAX) heads, the queries turned by the illumination's angle; or, with
    one output and the field's selection, NaN where the light index passes
    the head (in both packages, at the same entries). Outputs, and every
    gradient leaf of a probe of the finite outputs."""
    outputs, rotate = SLF_CASES[case]
    params = slf_distance.narrow_slf_params(OPEN)
    bindings = slf_distance.scene_bindings(OPEN)
    jconfigs.load_config(config_files=OPEN, bindings=bindings)
    tconfigs.load_config(config_files=OPEN, bindings=bindings)
    kwargs = dict(params, use_env_alpha=True, use_illumination_feature=True,
                  multiple_illumination_outputs=True, rotate_illumination=rotate,
                  distance_near=tgin.query_parameter("NeRFMLP.surface_lf_distance_near"),
                  distance_far=tgin.query_parameter("NeRFMLP.surface_lf_distance_far"))
    jmod = jslf.SurfaceLightFieldMLP(config=_multi_config(JConfig(), outputs, rotate), **kwargs)
    tmod = tslf.SurfaceLightFieldMLP(config=_multi_config(TConfig(), outputs, rotate),
                                     shader_bottleneck_dim=16, **kwargs)
    x = slf_distance._slf_inputs(1)
    light_idx = np.array([[0], [1], [2], [2], [0], [1]], np.int32)
    n_out = 3 if outputs else 1
    probe = np.random.RandomState(4).normal(size=(6, 5, 3 + 3 * n_out)).astype(np.float32)

    def call(mod, to, rng):
        rays = types.SimpleNamespace(near=to(x["near"]), lights=to(x["lights"]),
                                     light_idx=to(light_idx))
        return mod(rng, rays, {k: to(x[k]) for k in ("means", "covs", "tdist")}, to(x["means"]),
                   to(x["refdirs"]), roughness=to(x["roughness"]),
                   shader_bottleneck=to(x["bottleneck"]), train=True,
                   train_frac=slf_distance.TRAIN_FRAC)

    def loss(out, p, xnp):
        return ((_nan_free(out["incoming_rgb"], xnp) * p[..., :3]).sum()
                + (out["incoming_ambient_rgb"] * p[..., 3:]).sum()
                + xnp.sum(out["incoming_env_rgba"]) + xnp.sum(out["incoming_weights"]))

    jrays = types.SimpleNamespace(near=x["near"], lights=x["lights"], light_idx=light_idx)
    jargs = (jrays, {k: x[k] for k in ("means", "covs", "tdist")}, x["means"], x["refdirs"])
    jkw = dict(roughness=x["roughness"], shader_bottleneck=x["bottleneck"])
    jkey = jax.random.PRNGKey(0)
    with jhash.xla_encoder_scope():
        shapes = jax.eval_shape(lambda: jmod.init(jkey, jkey, *jargs, **jkw))
    rng = np.random.RandomState(3)

    def draw(path, s):
        table = str(getattr(path[-1], "key", "")) in ("hash_levels", "dense_levels")
        return (rng.uniform(-0.5, 0.5, s.shape) * (2e-4 if table else 1.0)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    assert variables["params"]["light_vecs"]["embedding"].shape == (3, 64)

    def jfn(v):
        out = jmod.apply(v, jkey, *jargs, **jkw, train=True, train_frac=slf_distance.TRAIN_FRAC)
        return loss(out, jnp.asarray(probe), jnp), out

    with jhash.xla_encoder_scope():
        (_, want), jgrad = jax.value_and_grad(jfn, has_aux=True)(variables)
    tmod.load_state_dict(weights.state_dict_from_jax(variables, tmod))
    out = call(tmod, torch.as_tensor, None)
    loss(out, torch.as_tensor(probe), torch).backward()
    assert tuple(out["incoming_rgb"].shape) == (6, 5, 3)
    assert tuple(out["incoming_ambient_rgb"].shape) == (6, 5, 3 * n_out)
    nan = np.isnan(out["incoming_rgb"].detach().numpy())
    assert np.array_equal(nan, np.isnan(np.asarray(want["incoming_rgb"])))
    assert nan.any(axis=(1, 2)).tolist() == [False] * 6 if outputs else (
        nan.any(axis=(1, 2)) == (light_idx[:, 0] > 0)).all()
    for k, v in want.items():
        g, w = out[k].detach().numpy(), np.asarray(v)
        np.testing.assert_allclose(g, w, err_msg=k, **OUT)
    leaves = material_slice._leaves(jgrad["params"])
    params_t = dict(tmod.named_parameters())
    assert sorted(params_t) == sorted(leaves) and "light_vecs.embedding" in params_t
    for k, p in params_t.items():
        material_slice._close(p.grad.numpy(), material_slice._tr(k, leaves[k]), *GRAD, k)
    if rotate:
        # The rotation moves every query but illumination 0's.
        tmod_still = tslf.SurfaceLightFieldMLP(
            config=_multi_config(TConfig(), outputs, False), shader_bottleneck_dim=16,
            **dict(kwargs, rotate_illumination=False))
        tmod_still.load_state_dict(tmod.state_dict())
        still = call(tmod_still, torch.as_tensor, None)["incoming_rgb"].detach().numpy()
        moved = ~np.isclose(still, out["incoming_rgb"].detach().numpy()).all(axis=(1, 2))
        assert moved.tolist() == (light_idx[:, 0] > 0).tolist()


LIGHT_CASES = {"outputs": (True, True), "one_output_selected": (False, True),
               "one_output": (False, False)}


@pytest.mark.parametrize("case", sorted(LIGHT_CASES))
def test_light_mlp_with_illuminations_matches_jax(case):
    """The light sampler with its illumination embedding: one vMF mixture
    per illumination picked by the ray's light index; one mixture picked by
    the field (the NaN of the light-sampling loss: rays of illuminations 1
    and 2 get NaN lobes, in both packages); one mixture read by all."""
    outputs, select = LIGHT_CASES[case]
    jcfg = _multi_config(bench._cache_config(), outputs)
    tcfg = _multi_config(flagship.cache_config(), outputs)
    grid = dict(hash_map_size=4096, max_grid_size=128, num_features=4, scale_supersample=1.0,
                interpolation="simplex", bbox_scaling=2.0)
    common = dict(net_depth=2, net_width=16, bottleneck_width=128, num_components=8,
                  vmf_scale=20.0, use_density_feature=False, use_grid=True, grid_params=grid,
                  use_illumination_feature=True, multiple_illumination_outputs=select)
    jm = jlight.LightMLP(config=jcfg, warp_fn=jcoord.contract_radius_2, **common)
    tm = tlight.LightMLP(config=tcfg, warp_fn=tcoord.contract_radius_2, **common)
    rng = np.random.RandomState(13)
    n = 6
    sr = {"means": rng.randn(n, 1, 3).astype(np.float32),
          "covs": np.tile(np.eye(3, dtype=np.float32) * 1e-3, (n, 1, 1, 1)),
          "tdist": np.tile(np.linspace(2, 6, 9, dtype=np.float32), (n, 1)),
          "normals_to_use": rng.randn(n, 1, 3).astype(np.float32),
          "weights": rng.rand(n, 1).astype(np.float32)}
    jrays, trays = material_slice._unit_rays(n, 14)
    light_idx = np.array([[0], [1], [2], [0], [2], [1]], np.int32)
    jrays = jrays.replace(light_idx=jnp.asarray(light_idx))
    trays = trays.replace(light_idx=torch.as_tensor(light_idx))
    jsr = {k: jnp.asarray(v) for k, v in sr.items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), None, jrays, jsr))
    variables = material_slice.random_variables(shapes, 15)
    n_out = 3 if outputs else 1
    assert variables["params"]["output_layer"]["kernel"].shape[-1] == 8 * 5 * n_out
    tm.load_state_dict(weights.state_dict_from_jax(variables, tm))
    with material_slice.injected(16):  # the lobe-mean jitter
        want = jm.apply(variables, None, jrays, jsr)
        got = tm(None, trays, {k: torch.as_tensor(v) for k, v in sr.items()})
    assert sorted(got) == sorted(want)
    nan_rays = np.isnan(got["vmf_kappas"].detach().numpy()).any(axis=(1, 2, 3))
    assert nan_rays.tolist() == ((light_idx[:, 0] > 0).tolist() if select and not outputs
                                 else [False] * n)
    for k in want:
        g, w = got[k].detach().numpy(), np.asarray(want[k])
        assert np.array_equal(np.isnan(g), np.isnan(w)), k
        np.testing.assert_allclose(g, w, err_msg=k, **OUT)


# --- one step through both trainers -------------------------------------------------------

def bindings(data_dir, features=True):
    return open_steps.bindings(data_dir) + MULTI + (FEATURES if features else [])


# The launches of a step: those of open_egg's single-illumination steps.
CACHE_LAUNCHES = ["leveled", "leveled"]
# The light vectors the stages create: every shader that reads its feature,
# but the material shader (JAX never calls its embedding).
CACHE_VECS = ["cache.shader.light_vecs.embedding", "cache.shader.surface_lf.light_vecs.embedding"]
MATERIAL_VECS = CACHE_VECS + ["light_sampler.light_vecs.embedding"]


def test_one_cache_step_under_three_illuminations(multi_dir, monkeypatch):
    """open_egg's `cache_multi_illum` stage, one step through both trainers
    from the same weights and draws, each package's batch from its own
    loader (rays of all three illuminations): every loss term, every
    gradient leaf (the embeddings' among them), the Adam step, the
    launches."""
    open_steps._from_disk(monkeypatch)
    jt, jmodel, tt = material_trainer._trainers(OPEN, bindings(multi_dir), "cache")
    # Config.num_dataset_images = 2 (trainer_test.TINY) views per illumination.
    assert tt.dataset.images.shape[0] == 3 * 2
    assert [k for k in tt.model.state_dict() if "light_vecs" in k] == CACHE_VECS
    got = material_trainer._step_parity(jt, jmodel, tt, material_trainer._variables(jmodel, 5),
                                        monkeypatch, CACHE_LAUNCHES)
    assert all(np.isfinite(v) for v in got.values())
    for k in CACHE_VECS:
        assert float(dict(tt.model.named_parameters())[k].grad.abs().max()) > 0, k


def test_one_material_step_under_three_illuminations(multi_dir, monkeypatch):
    """`material_light_from_scratch_resample_multi_illum`, one step through
    both trainers: every loss term, every gradient leaf, the Adam step, the
    launches. light_sampling is NaN in both (the light sampler's one mixture
    read past its end for illuminations 1 and 2, see the module docstring);
    the step's gradients are taken with NaN set to 0, as both train steps
    do, and every other term is finite."""
    open_steps._from_disk(monkeypatch)
    jt, jmodel, tt = material_trainer._trainers(
        OPEN, bindings(multi_dir) + material_trainer.MATERIAL_TINY + material_trainer.MATERIAL
        + material_trainer.SMOOTH, "material_light_from_scratch")
    assert [k for k in tt.model.state_dict() if "light_vecs" in k] == MATERIAL_VECS
    got = material_trainer._step_parity(jt, jmodel, tt, material_trainer._variables(jmodel, 5),
                                        monkeypatch, open_steps.MATERIAL_LAUNCHES)
    assert np.isnan(got["light_sampling"])
    assert all(np.isfinite(v) for k, v in got.items() if k != "light_sampling")
    assert got["material_smoothness"] != 0


# --- the reference gaps ------------------------------------------------------------------


def _jax_init(jt):
    jmodel = jconstruct.make_model(jt.config)
    rays = jpytrees.dummy_rays(4)
    return jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1), rays,
                                              train_frac=1.0, train=False))


@pytest.mark.parametrize("stage", ["cache", "material_light_from_scratch"])
def test_multiple_illumination_outputs_is_a_reference_gap(stage):
    """The configs' own `Config.multiple_illumination_outputs = True`, the
    `_multi_illum` suffix as it stands: JAX's first query raises at the
    cache shader (the SLF's unselected 9-channel ambient head against its
    3-channel tint); the port refuses the model, naming that failure."""
    gin = slf_distance.scene_bindings(OPEN) + ["Config.multi_illumination = True"]
    jt = trainer_test.synthesize("jax", OPEN, gin, stage)
    with pytest.raises(TypeError, match="mul got incompatible shapes"):
        _jax_init(jt)
    tt = trainer_test.synthesize("torch", OPEN, gin, stage)
    with pytest.raises(NotImplementedError, match="reference gap.*ambient_rgb.*TypeError"):
        tconstruct.make_model(tt.config, device="cpu")


def test_ground_truth_illumination_is_a_reference_gap():
    """`Config.use_ground_truth_illumination` under multi_illumination: JAX's
    environment sampler reads the env map tables its trainer never hands the
    model; the port refuses by name."""
    gin = trainer_test.TINY + ["Config.multi_illumination = True",
                               "Config.use_ground_truth_illumination = True"]
    stage = "material_light_from_scratch"
    jt = trainer_test.synthesize("jax", [trainer_test.SPHERES], gin, stage)
    with pytest.raises(ValueError, match="No input was provided to the clip function"):
        _jax_init(jt)
    tt = trainer_test.synthesize("torch", [trainer_test.SPHERES], gin, stage)
    with pytest.raises(NotImplementedError, match="reference gap.*env_map_pmf = None"):
        tconstruct.make_model(tt.config, device="cpu")


@pytest.mark.parametrize("stage", ["cache", "material_light_from_scratch"])
def test_structured_light_is_a_reference_gap(stage):
    """`train_one_stage.py --sl_relight` on a transient scene: JAX's active
    cache shader reads kwargs['env_map'], which its trainer never passes
    (KeyError at the first query, in both stages); the port refuses by name
    in the cache shader, and so in every stage. The steady cache shader
    reads no structured light: cornell's passive twin builds in both."""
    gin = transient_trainer.TRANSIENT_TINY + ["Config.sl_relight = True"]
    jt = trainer_test.synthesize("jax", transient_trainer.CORNELL, gin, stage)
    with pytest.raises(KeyError, match="env_map"):
        _jax_init(jt)
    tt = trainer_test.synthesize("torch", transient_trainer.CORNELL, gin, stage)
    with pytest.raises(NotImplementedError, match="reference gap.*KeyError: 'env_map'"):
        tconstruct.make_model(tt.config, device="cpu")
    if stage == "cache":
        jt = trainer_test.synthesize("jax", [trainer_test.SPHERES],
                                     trainer_test.TINY + ["Config.sl_relight = True"], stage)
        _jax_init(jt)
        tt = trainer_test.synthesize("torch", [trainer_test.SPHERES],
                                     trainer_test.TINY + ["Config.sl_relight = True"], stage)
        assert tconstruct.make_model(tt.config, device="cpu") is not None


def test_the_other_shaders_name_the_structured_light_gap():
    """The learnable light and the transient material shader, built alone
    under sl_relight, refuse with the same message."""
    from neural_radiance_caching_tpu_torch.models import material_shader as tms
    cfg = dataclasses.replace(TConfig(), sl_relight=True, use_transient=True)
    with pytest.raises(NotImplementedError, match="reference gap.*KeyError: 'env_map'"):
        tlight.LightSourceMap(config=cfg)
    with pytest.raises(NotImplementedError, match="reference gap.*KeyError: 'env_map'"):
        tms.TransientMaterialMLP(config=cfg)


# --- the stage suffixes ------------------------------------------------------------------


def _jax_stage_command(argv, monkeypatch):
    """The JAX script's command for `argv` (its main, the call stubbed)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_train_one_stage", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "scripts", "train_one_stage.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    calls = []
    monkeypatch.setattr(script.subprocess, "call", lambda cmd: calls.append(cmd) or 0)
    monkeypatch.setattr("sys.argv", ["train_one_stage"] + argv)
    with pytest.raises(SystemExit):
        script.main()
    return calls[0]


def test_rotate_illum_acts_as_multi_illum(monkeypatch):
    """Both packages' `train_one_stage.py`: `_rotate_illum` sets a flag that
    nothing binds (`rotate_illum`), so its command is `_multi_illum`'s:
    Config.multi_illumination = True and no rotation binding; JAX's and the
    port's commands bind the same."""
    base = ["-s", "obj_02_egg", "-e", "open", "--checkpoint_root", "/ckpt"]
    got, want = {}, {}
    for suffix in ("_multi_illum", "_rotate_illum"):
        argv = base + ["-t", f"cache{suffix}"]
        got[suffix] = ttrain_one_stage.stage_command(argv)
        want[suffix] = _jax_stage_command(argv, monkeypatch)
        for cmd in (got[suffix], want[suffix]):
            assert "--gin_bindings=Config.multi_illumination=True" in cmd
            assert "--gin_bindings=Trainer.stage='cache'" in cmd
            assert not any("rotat" in c for c in cmd)
        assert [c for c in got[suffix] if c.startswith("--gin_")] == [
            c for c in want[suffix] if c.startswith("--gin_")]
    assert got["_rotate_illum"] == got["_multi_illum"]
    assert want["_rotate_illum"] == want["_multi_illum"]
