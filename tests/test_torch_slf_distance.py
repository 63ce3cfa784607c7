"""The surface light field's distance head and grids against the JAX
package's, at test widths: the SLF of the nero family (the distance head
over the shader's bottleneck, 8 proposed points, the reflectance grid
tapped there) and of the open / orb families (the origins' encoding and
the SLF's own grid as the bottleneck) alone on the same inputs and weights,
one cache step of nero_ngp_yobo_bell and open_ngp_yobo_egg through both
trainers, the cache stage of every nero / open / orb config against JAX's
parameter groups, the SLF fields read only under a flag that is off, and
the `rawnerf_original` cache loss that the JAX package cannot run.

Every scene runs without its data (SyntheticSpheres): the glossy_synthetic,
open_illum and orb captures and loaders are not in the repository.

Tolerances (float32): the SLF alone to 1e-4 relative with an absolute
1e-5 x the largest entry (outputs) and rtol 2e-3 with an absolute 2e-4 x
the leaf's largest entry (gradients: the tables' sums run in another order
through the hash grids); a train step as in `test_torch_invprop_scenes.py`:
loss terms to 1e-4 relative with an absolute 1e-7, every gradient leaf to
rtol 2e-3 with an absolute 2e-4 x the leaf's largest entry, and after the
trainer's Adam step a parameter within 2 x its group's learning rate of
optax's.
"""

import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_material_slice as material_slice
import test_torch_material_trainer as material_trainer
import test_torch_trainer as trainer_test
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import configs as jconfigs
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.models import construct as jconstruct
from neural_radiance_caching_tpu.models import surface_light_field as jslf
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.parallel import extra_losses as jextra
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch.engine import configs as tconfigs
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.models import construct as tconstruct
from neural_radiance_caching_tpu_torch.models import surface_light_field as tslf
from neural_radiance_caching_tpu_torch.utils import weights

NERO = ["configs/nero_ngp_yobo_bell.gin"]
OPEN = ["configs/open_ngp_yobo_egg.gin"]
SCENES = {"nero_bell": NERO, "open_egg": OPEN}
# open's far plane of 2 ends SyntheticSpheres' rays before its spheres (an
# empty render, no gradient but the background's, in JAX too): its step
# takes nero's far plane of 4.
STEP_BINDINGS = {"nero_bell": [], "open_egg": ["Config.far = 4.0"]}
# One step's scatter launches: the reflectance grid's backward, and on open
# the SLF's own grid's (the final density level takes density normals, the
# plain encoder).
STEP_LAUNCHES = {"nero_bell": ["leveled"], "open_egg": ["leveled", "leveled"]}
FAMILY_CONFIGS = sorted(p.name for p in pathlib.Path("configs").glob("*.gin")
                        if p.name.startswith(("nero_", "open_", "orb_")))
TRAIN_FRAC = 0.25
OUT = (1e-4, 1e-5)
GRAD = material_trainer.GRAD
LOSS = trainer_test.LOSS


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


def narrow_slf_params(files):
    """The scene's `NeRFMLP.surface_lf_params` at test widths: 16-wide
    trunks and distance head, 4096-row grids (the reflectance grid keeps its
    max size, the own grid 128)."""
    tgin.clear_config()
    tconfigs.load_config(config_files=files, bindings=[])
    params = dict(tgin.query_parameter("NeRFMLP.surface_lf_params"))
    tgin.clear_config()
    params.update(net_width=16, net_width_viewdirs=16, net_width_distance=16,
                  reflectance_grid_params=dict(params["reflectance_grid_params"],
                                               hash_map_size=4096),
                  grid_params=dict(params["grid_params"], hash_map_size=4096, max_grid_size=128))
    return params


def scene_bindings(files):
    """ngp_yobo.gin's test widths (trainer_test.NGP_TINY) with the scene's
    SLF narrowed."""
    return trainer_test.NGP_TINY + [
        f"NeRFMLP.surface_lf_params = {narrow_slf_params(files)!r}"]


# --- the SLF alone -----------------------------------------------------------------------


def _slf_pair(files):
    """The scene's SLF in both packages under its gin bindings, as the cache
    shader builds it (its distance range, `use_env_alpha`)."""
    params = narrow_slf_params(files)
    bindings = scene_bindings(files)
    kwargs = dict(params, use_env_alpha=True)
    jconfigs.load_config(config_files=files, bindings=bindings)
    tconfigs.load_config(config_files=files, bindings=bindings)
    near = tgin.query_parameter("NeRFMLP.surface_lf_distance_near")
    far = tgin.query_parameter("NeRFMLP.surface_lf_distance_far")
    kwargs.update(distance_near=near, distance_far=far)
    jcfg, tcfg = jconfigs.Config(), tconfigs.Config()
    jmod = jslf.SurfaceLightFieldMLP(config=jcfg, **kwargs)
    tmod = tslf.SurfaceLightFieldMLP(config=tcfg, shader_bottleneck_dim=16, **kwargs)
    return jmod, tmod, params


def _slf_inputs(seed, rays=6, samples=5):
    rng = np.random.RandomState(seed)
    means = rng.uniform(-0.6, 0.6, (rays, samples, 3)).astype(np.float32)
    refdirs = rng.normal(size=(rays, samples, 3)).astype(np.float32)
    refdirs /= np.linalg.norm(refdirs, axis=-1, keepdims=True)
    return dict(
        means=means, refdirs=refdirs,
        covs=np.tile(np.eye(3, dtype=np.float32) * 1e-4, (rays, samples, 1, 1)),
        tdist=np.sort(rng.uniform(0.5, 3.0, (rays, samples + 1)), -1).astype(np.float32),
        near=np.full((rays, 1), 0.2, np.float32),
        lights=rng.uniform(-2, 2, (rays, 3)).astype(np.float32),
        roughness=rng.uniform(0.01, 0.5, (rays, samples, 1)).astype(np.float32),
        bottleneck=rng.normal(size=(rays, samples, 16)).astype(np.float32),
        probe=rng.normal(size=(rays, samples, 4)).astype(np.float32))


def _slf_call(mod, x, to, rng):
    rays = types.SimpleNamespace(near=to(x["near"]), lights=to(x["lights"]))
    sampler = {k: to(x[k]) for k in ("means", "covs", "tdist")}
    return mod(rng, rays, sampler, to(x["means"]), to(x["refdirs"]),
               roughness=to(x["roughness"]), shader_bottleneck=to(x["bottleneck"]),
               train=True, train_frac=TRAIN_FRAC)


def _probe(out, probe, xnp):
    return ((out["incoming_rgb"] + out["incoming_ambient_rgb"]) * probe[..., :3]).sum() + (
        out["incoming_weights"].sum(-1) * probe[..., 3]).sum() + xnp.sum(out["incoming_env_rgba"])


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_slf_alone_matches_jax(scene):
    """The SLF's outputs and every gradient leaf of a probe of its radiance,
    blend weights and env RGBA: nero's distance head over the shader's
    bottleneck and reflectance grid (64^3 at most, contracted by radius 2),
    open's with the origins' encoding, the own grid through its trunk as the
    bottleneck and the light's encoding (the cube contraction)."""
    jmod, tmod, params = _slf_pair(SCENES[scene])
    x = _slf_inputs(1)
    jkey = jax.random.PRNGKey(0)
    with jhash.xla_encoder_scope():
        shapes = jax.eval_shape(lambda: jmod.init(
            jkey, jkey, types.SimpleNamespace(near=x["near"], lights=x["lights"]),
            {k: x[k] for k in ("means", "covs", "tdist")}, x["means"], x["refdirs"],
            roughness=x["roughness"], shader_bottleneck=x["bottleneck"]))
    rng = np.random.RandomState(3)

    def draw(path, s):
        table = str(getattr(path[-1], "key", "")) in ("hash_levels", "dense_levels")
        return (rng.uniform(-0.5, 0.5, s.shape) * (2e-4 if table else 1.0)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    names = set(variables["params"])
    assert {"distance_layer_0", "distance_output_layer", "reflectance_grid"} <= names
    assert ("distance_grid" in names) == (scene == "open_egg")
    assert params["use_origins"] == (scene == "open_egg")

    def jfn(v):
        out = jmod.apply(v, jkey, types.SimpleNamespace(near=x["near"], lights=x["lights"]),
                         {k: x[k] for k in ("means", "covs", "tdist")}, x["means"],
                         x["refdirs"], roughness=x["roughness"],
                         shader_bottleneck=x["bottleneck"], train=True, train_frac=TRAIN_FRAC)
        return _probe(out, x["probe"], jnp), out

    with jhash.xla_encoder_scope():
        (_, want), jgrad = jax.value_and_grad(jfn, has_aux=True)(variables)
    tmod.load_state_dict(weights.state_dict_from_jax(variables, tmod))
    out = _slf_call(tmod, x, torch.as_tensor, None)
    _probe(out, torch.as_tensor(x["probe"]), torch).backward()
    assert tuple(out["incoming_weights"].shape) == (6, 5, 8)
    assert 0 < float(out["incoming_acc"].min()) and float(out["incoming_acc"].max()) <= 1
    for k, v in want.items():
        material_slice._close(out[k].detach().numpy(), np.asarray(v), *OUT, k)
    leaves = material_slice._leaves(jgrad["params"])
    params_t = dict(tmod.named_parameters())
    assert sorted(params_t) == sorted(leaves)
    for k, p in params_t.items():
        material_slice._close(p.grad.numpy(), material_slice._tr(k, leaves[k]), *GRAD, k)
    assert float(tmod.reflectance_grid.hash_levels.grad.abs().max()) > 0


# --- one step through both trainers ------------------------------------------------------


def jax_step_loss(jmodel, jcfg, train_frac):
    """The JAX cache step's loss (`parallel/train.py` without the mesh): the
    forward, the debias forward, per *main output its losses and extra
    losses (geometry smoothness), then the parameter regularizers."""

    def loss_fn(variables, batch):
        rng = jax.random.PRNGKey(0)
        kw = dict(train_frac=train_frac, train=True, compute_extras=False)
        results = jmodel.apply(variables, rng, batch.rays, **kw)
        nocorr = jmodel.apply(
            variables, jax.random.fold_in(rng, 0x5EED), batch.rays,
            cache_outputs={"sampler": results["cache_main"]["sampler"]},
            filtered_sampler_inds=results["cache_main"]["filtered_sampler_inds"], **kw)
        results["render"]["rgb_nocorr"] = nocorr["render"]["rgb"]
        losses, stats = {}, {}
        for i, key in enumerate(sorted(k for k in results if k.endswith("main"))):
            jtrain._compute_losses_for_output(None, batch, batch.rays, results, jcfg, train_frac,
                                              key, losses, stats)
            jextra.compute_extra_losses(jmodel, variables, jax.random.fold_in(rng, 7919 + i),
                                        batch.rays, jcfg, batch, results, key, losses,
                                        train_frac)
        for k, v in jlosses.param_regularizer_loss(variables, jcfg).items():
            losses["regularizer_" + k] = v
        return sum(jax.tree_util.tree_leaves(losses)), losses

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_one_cache_step_through_both_trainers(scene, monkeypatch):
    """One cache step of the scene from the same weights and draws (every
    leaf from U(-0.5, 0.5), the tables at their init range, the distance
    head's zero-initialised output layer drawn too): every loss term, every
    gradient leaf, the Adam step, and the step's scatter launches."""
    files = SCENES[scene]
    jt, jmodel, tt = material_trainer._trainers(
        files, scene_bindings(files) + STEP_BINDINGS[scene], "cache")
    jcfg = jt.config
    variables = material_trainer._variables(jmodel, 5)
    jbatch = jdatasets.load_dataset("train", None, jcfg).next_train()
    with material_slice.injected(7), jhash.xla_encoder_scope():
        (_, jlosses_), jgrad = jax_step_loss(jmodel, jcfg, TRAIN_FRAC)(variables, jbatch)
    jgrad = jlosses.clip_gradients(jax.tree_util.tree_map(jnp.nan_to_num, jgrad), jcfg)
    jstate, _ = jtrain.create_optimizer(jcfg, variables)
    updates, _ = jstate.tx.update(jgrad, jstate.opt_state, variables)
    jnew = material_slice._leaves(optax.apply_updates(variables, updates)["params"])

    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    calls = []
    material_slice._counting_scatters(monkeypatch, calls)
    with material_slice.injected(7):
        state, stats = tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), TRAIN_FRAC)
    assert calls == STEP_LAUNCHES[scene]

    got = {k: float(v) for k, v in stats["losses"].items()}
    assert sorted(got) == sorted(jlosses_)
    for k, v in jlosses_.items():
        np.testing.assert_allclose(got[k], float(v), err_msg=k, **LOSS)
    want = material_slice._leaves(jgrad["params"])
    params = dict(tt.model.named_parameters())
    assert sorted(params) == sorted(want)
    slf = "cache.shader.surface_lf."
    for leaf in ("reflectance_grid.hash_levels", "distance_output_layer.weight"):
        assert float(params[slf + leaf].grad.abs().max()) > 0
    for k, p in params.items():
        material_slice._close(p.grad.numpy(), material_slice._tr(k, want[k]), *GRAD, k)
    for k, p in params.items():
        lr = max(g["lr"] for g in state.optimizer.param_groups
                 if any(q is p for q in g["params"]))
        np.testing.assert_allclose(p.detach().numpy(), material_slice._tr(k, jnew[k]),
                                   rtol=0, atol=2 * lr + 1e-7, err_msg=k)


# --- the families' cache stages ----------------------------------------------------------


@pytest.mark.parametrize("config", FAMILY_CONFIGS)
def test_every_family_config_builds_jax_groups(config):
    """The cache stage of every configs/{nero,open,orb}_*.gin at its own
    widths builds JAX's parameter groups, and every leaf of JAX's shapes."""
    bindings = ["Config.batch_size = 16"]
    tt = trainer_test.synthesize("torch", [f"configs/{config}"], bindings, "cache")
    state = tconstruct.make_model(tt.config, device="cpu").state_dict()
    jt = trainer_test.synthesize("jax", [f"configs/{config}"], bindings, "cache")
    jmodel = jconstruct.make_model(jt.config)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))
    want = {weights.torch_key(tuple(str(getattr(k, "key", k)) for k in path)): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    got = {k: tuple(v.shape[::-1] if v.dim() == 2 and k.endswith(".weight") else v.shape)
           for k, v in state.items()}
    assert {weights.jax_path(k)[0] for k in state} == set(shapes["params"]) == {"Cache"}
    assert got == want
    assert any(".surface_lf.reflectance_grid." in k for k in got)


# --- the repaired fields -----------------------------------------------------------------

# (field, value, flags that keep it unread): each field of the SLF that JAX
# reads only under a flag, changed while that flag is off.
GATED_FIELDS = [
    ("use_points_ide", True, {}),
    ("deg_points", 6, {}),
    ("deg_sphere_points", 7, {}),
    ("sphere_radius", 2.0, {}),
    ("point_offset_scale", 0.5, {}),
    ("point_offset_bias", -1.0, {}),
    ("roughness_scale", 0.1, {}),
    ("use_roughness", True, {"use_reflectance_grid": False}),
    ("per_ref_feature_output", True, {"use_reflectance_grid": False}),
    ("reflectance_grid_representation", "triplane", {"use_reflectance_grid": False}),
    ("reflectance_grid_params", {"num_features": 8}, {"use_reflectance_grid": False}),
    ("use_point_offsets", True, {"use_distance_prediction": False,
                                 "use_reflectance_grid": False}),
    ("deg_origins", 2, {"use_distance_prediction": False, "use_reflectance_grid": False}),
]


def _gated_forward(extra, head_scale=0.0):
    """nero's SLF with `extra` on seeded weights (the distance head's
    zero-initialised output layer drawn at `head_scale` if nonzero)."""
    files = NERO
    params = dict(narrow_slf_params(files), use_env_alpha=True, distance_near=0.05,
                  distance_far=20.0, **extra)
    tconfigs.load_config(config_files=files, bindings=scene_bindings(files))
    torch.manual_seed(0)
    mod = tslf.SurfaceLightFieldMLP(config=tconfigs.Config(), shader_bottleneck_dim=16, **params)
    if head_scale and hasattr(mod, "distance_output_layer"):
        with torch.no_grad():
            mod.distance_output_layer.weight.normal_(0.0, head_scale)
    x = _slf_inputs(2)
    return mod.state_dict(), _slf_call(mod, x, torch.as_tensor, None)


@pytest.mark.parametrize("field,value,flags", GATED_FIELDS, ids=[f[0] for f in GATED_FIELDS])
def test_gated_field_is_read_only_under_its_flag(field, value, flags):
    """The field at another value, with the flag it is read under off,
    builds the same parameters and gives the default's forward bit for bit
    (nero's SLF: the distance head and the reflectance grid on unless the
    case turns them off)."""
    want_state, want = _gated_forward(flags)
    got_state, got = _gated_forward(dict(flags, **{field: value}))
    assert sorted(got_state) == sorted(want_state)
    for k, v in want_state.items():
        assert torch.equal(got_state[k], v), k
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("field,flag", [("use_roughness", "use_reflectance_grid"),
                                        ("per_ref_feature_output", "use_reflectance_grid"),
                                        ("use_point_offsets", "use_distance_prediction")])
def test_gated_field_raises_where_its_branch_is_on(field, flag):
    """Where its branch is on, the field is read: the forward differs from
    the branch's without it (each option against JAX in
    tests/test_torch_slf_options.py). The fields once raised there."""
    # A drawn distance head (its nudge) and a coarse roughness scale, so
    # that the field's effect shows.
    extra = {flag: True, "roughness_scale": 10.0}
    _, want = _gated_forward(extra, head_scale=0.5)
    _, got = _gated_forward(dict(extra, **{field: True}), head_scale=0.5)
    assert not torch.equal(got["incoming_rgb"], want["incoming_rgb"])


# --- a reference gap ---------------------------------------------------------------------


def test_rawnerf_original_cache_step_raises_in_jax():
    """blender_ngp_yobo_lego's cache loss `rawnerf_original`
    (`MaterialModel.cache_loss`): the JAX step's data loss raises a
    ValueError naming it, and so does the port's step (its steady active
    shader, which the port refused at construction before, now builds)."""
    files = ["configs/blender_ngp_yobo_lego.gin"]
    bindings = trainer_test.HOTDOG_BINDINGS + trainer_test.TINY
    jt = trainer_test.synthesize("jax", files, bindings, "cache")
    assert jgin.query_parameter("MaterialModel.cache_loss") == "rawnerf_original"
    jmodel = jconstruct.make_model(jt.config)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))
    jbatch = jdatasets.load_dataset("train", None, jt.config).next_train()
    with pytest.raises(ValueError, match="Unknown data loss type: rawnerf_original"):
        with jhash.xla_encoder_scope():
            jax.eval_shape(jax_step_loss(jmodel, jt.config, TRAIN_FRAC), shapes, jbatch)
    tt = trainer_test.synthesize("torch", files, bindings, "cache")
    tt._setup_rng()
    tt._load_datasets()
    tt._setup_model()
    assert tt.model.cache.shader.use_active
    with pytest.raises(ValueError, match="Unknown data loss type: rawnerf_original"):
        tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), TRAIN_FRAC)
