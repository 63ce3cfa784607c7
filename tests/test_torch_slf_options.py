"""The surface light field's remaining options against the JAX package's, at
test widths: each option of the SLF alone on nero's narrowed
`surface_lf_params` (the distance head over the shader's bottleneck, the
reflectance grid tapped at the proposed points) with the same numpy-seeded
inputs and carried weights, outputs and every gradient leaf; `dist_only`
through `NeRFModel.get_slf_results`; one cache step of nero_ngp_yobo_bell
through both trainers under option set E (points with IDE, sphere points,
sorted distances with point offsets, the reflectance grid's roughness and
density head) and under set E' (voxel-plane placement and far-field
points); the options JAX cannot run raising in both packages; open_egg's
cache step and SLF material step with the environment map
(`tests/test_torch_env_map.py`'s bindings) with the env distance at 2.0,
inside the SLF's range (the config's 0.5 is its near plane), at weights
where camera rays meet the surface: the map's and the SLF grids'
gradients nonzero in both packages, and the lit lobes' env x (1 - acc) the
same nonzero values.

Tolerances as in `tests/test_torch_slf_distance.py`: the SLF alone to 1e-4
relative with an absolute 1e-5 x the largest entry (`OUT`), gradients to
rtol 2e-3 with an absolute 2e-4 x the leaf's largest entry (`GRAD`); a step's
loss terms to 1e-4 relative with an absolute 1e-7 (`LOSS`).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_material_slice as material_slice
import test_torch_material_trainer as material_trainer
import test_torch_env_map as env_map
import test_torch_slf_distance as slf_distance
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import configs as jconfigs
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.models import surface_light_field as jslf
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu_torch.engine import configs as tconfigs
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.models import surface_light_field as tslf
from neural_radiance_caching_tpu_torch.utils import weights

NERO = slf_distance.NERO
TRAIN_FRAC = slf_distance.TRAIN_FRAC
OUT = slf_distance.OUT
GRAD = slf_distance.GRAD
LOSS = slf_distance.LOSS
RESAMPLE = ["Trainer.resample = True", "Trainer.resample_render = True"]

# Each option (or option group) over nero's SLF; `None` values drop a key.
CASES = {
    "points": dict(use_points=True),
    "points_ide": dict(use_points=True, use_points_ide=True),
    "sphere_points": dict(use_sphere_points=True, sphere_radius=1.5, deg_sphere_points=3),
    "far_field_points": dict(use_far_field_points=True),
    "far_field_alone": dict(use_far_field_points=True, use_distance_prediction=False,
                            use_points=True),
    "voxel_grid": dict(use_voxel_grid=True, num_distance_samples=6, voxel_end=4.0),
    "voxel_grid_warped": dict(use_voxel_grid=True, num_distance_samples=3,
                              use_uniform_grid=False, voxel_start=0.1, voxel_end=4.0,
                              raydist_fn=("power_ladder", "inv_power_ladder",
                                          {"p": -1.5, "premult": 2.0})),
    "sorted_distances": dict(use_sorted_distances=True),
    "sorted_offsets": dict(use_sorted_distances=True, use_point_offsets=True,
                           num_distance_samples=3, point_offset_bias=0.0),
    "point_offsets": dict(use_point_offsets=True, point_offset_scale=0.5,
                          point_offset_bias=0.0),
    "roughness": dict(use_roughness=True, roughness_scale=0.5),
    "density": dict(use_density_prediction=True, net_width_density=16),
    "per_ref_feature_output": dict(per_ref_feature_output=True),
    "per_ref_density": dict(per_ref_feature_output=True, use_density_prediction=True,
                            net_width_density=16, use_roughness=True, roughness_scale=0.5),
}


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


def _raydist(spec, lib):
    """A `raydist_fn` triple of the package `lib` (JAX's or the port's
    `ops/math.py` by name)."""
    if spec is None:
        return None
    fn, fn_inv, kw = spec
    return getattr(lib, fn), getattr(lib, fn_inv), kw


def _pair(case):
    """nero's SLF with the case's options in both packages, as the cache
    shader builds it (its distance range, `use_env_alpha`)."""
    from neural_radiance_caching_tpu.ops import math as jmath
    from neural_radiance_caching_tpu_torch.ops import math as tmath

    files = NERO
    params = dict(slf_distance.narrow_slf_params(files), **CASES[case])
    bindings = slf_distance.scene_bindings(files)
    jconfigs.load_config(config_files=files, bindings=bindings)
    tconfigs.load_config(config_files=files, bindings=bindings)
    params.update(use_env_alpha=True,
                  distance_near=tgin.query_parameter("NeRFMLP.surface_lf_distance_near"),
                  distance_far=tgin.query_parameter("NeRFMLP.surface_lf_distance_far"))
    spec = params.pop("raydist_fn", None)
    jmod = jslf.SurfaceLightFieldMLP(config=jconfigs.Config(), raydist_fn=_raydist(spec, jmath),
                                     **params)
    tmod = tslf.SurfaceLightFieldMLP(config=tconfigs.Config(), shader_bottleneck_dim=16,
                                     raydist_fn=_raydist(spec, tmath), **params)
    return jmod, tmod


def _jax_args(x):
    return (types.SimpleNamespace(near=x["near"], lights=x["lights"]),
            {k: x[k] for k in ("means", "covs", "tdist")}, x["means"], x["refdirs"])


def _probe(out, probe, xnp):
    """A scalar of every output the SLF gives (the per-point decode gives no
    ambient radiance, and its alpha per point)."""
    total = (out["incoming_rgb"] * probe[..., :3]).sum() + (
        out["incoming_weights"].sum(-1) * probe[..., 3]).sum() + xnp.sum(out["incoming_env_rgba"])
    if "incoming_ambient_rgb" in out:
        total = total + (out["incoming_ambient_rgb"] * probe[..., :3]).sum()
    return total + xnp.sum(out["incoming_alpha"]) + xnp.sum(out["incoming_s_dist"])


def _variables(jmod, x, seed=3):
    jkey = jax.random.PRNGKey(0)
    with jhash.xla_encoder_scope():
        shapes = jax.eval_shape(lambda: jmod.init(
            jkey, jkey, *_jax_args(x), roughness=x["roughness"],
            shader_bottleneck=x["bottleneck"]))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        table = str(getattr(path[-1], "key", "")) in ("hash_levels", "dense_levels")
        return (rng.uniform(-0.5, 0.5, s.shape) * (2e-4 if table else 1.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_forward(jmod, variables, x):
    jkey = jax.random.PRNGKey(0)

    def fn(v):
        out = jmod.apply(v, jkey, *_jax_args(x), roughness=x["roughness"],
                         shader_bottleneck=x["bottleneck"], train=True, train_frac=TRAIN_FRAC)
        return _probe(out, x["probe"], jnp), out

    with jhash.xla_encoder_scope():
        return jax.jit(jax.value_and_grad(fn, has_aux=True))(variables)


@pytest.mark.parametrize("case", sorted(CASES))
def test_slf_option_matches_jax(case):
    """The SLF's outputs and every gradient leaf of a probe of them under
    the case's options, from the same inputs and weights (each leaf drawn
    from U(-0.5, 0.5), the tables at 2e-4 of that)."""
    jmod, tmod = _pair(case)
    x = slf_distance._slf_inputs(1)
    variables = _variables(jmod, x)
    (_, want), jgrad = _jax_forward(jmod, variables, x)
    tmod.load_state_dict(weights.state_dict_from_jax(variables, tmod))
    out = slf_distance._slf_call(tmod, x, torch.as_tensor, None)
    _probe(out, torch.as_tensor(x["probe"]), torch).backward()
    assert sorted(out) == sorted(want)
    for k, v in want.items():
        assert np.all(np.isfinite(np.asarray(v))), k
        material_slice._close(out[k].detach().numpy(), np.asarray(v), *OUT, k)
    leaves = material_slice._leaves(jgrad["params"])
    params_t = dict(tmod.named_parameters())
    assert sorted(params_t) == sorted(leaves)
    for k, p in params_t.items():
        material_slice._close(p.grad.numpy(), material_slice._tr(k, leaves[k]), *GRAD, k)
    assert float(tmod.reflectance_grid.hash_levels.grad.abs().max()) > 0


# --- dist_only ---------------------------------------------------------------------------


def test_dist_only_through_get_slf_results():
    """A `use_slf` query of the cache with `cache_tdist` reports those
    distances in the memory's s (its warp over its distance range): with
    `dist_only` that alone, else beside the memory's render; against JAX's
    `get_slf_results`."""
    files = NERO
    jt, jmodel, tt = material_trainer._trainers(
        files, slf_distance.scene_bindings(files) + RESAMPLE, "material_surface_light_field_light")
    variables = material_trainer._variables(jmodel, 5)
    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    jrays = jdatasets.load_dataset("train", None, jt.config).next_train().rays
    trays = tt.dataset.next_train().rays
    rng = np.random.RandomState(4)
    tdist = np.sort(rng.uniform(0.05, 30.0, jrays.origins.shape[:-1] + (5,)), -1)
    tdist = tdist.astype(np.float32)
    for dist_only in (True, False):
        with jhash.xla_encoder_scope():
            want = jmodel.apply(variables, jax.random.PRNGKey(0), jrays, use_slf=True,
                                dist_only=dist_only, cache_tdist=tdist, train=False,
                                method=lambda m, *a, **k: m.cache(*a, **k))
        got = tt.model.cache(None, trays, train=False, use_slf=True, dist_only=dist_only,
                             cache_tdist=torch.as_tensor(tdist))
        assert sorted(got) == sorted(want)
        assert ("rgb" in got) == (not dist_only)
        for k, v in want.items():
            if isinstance(v, (jnp.ndarray, np.ndarray)):
                material_slice._close(got[k].detach().numpy(), np.asarray(v), *OUT, k)


# --- one cache step under each option set ------------------------------------------------

# Set E: the points' integrated encoding, the sphere point, sorted distances
# with the nudge (3 samples, SORTED_NUDGE_GAP past that), the roughness-
# scaled reflectance query and its density head. Set E': voxel-plane
# placement with the far-field point as the reflectance grid's query.
STEP_SETS = {
    "E": dict(use_points=True, use_points_ide=True, use_sphere_points=True, sphere_radius=1.5,
              use_sorted_distances=True, use_point_offsets=True, num_distance_samples=3,
              point_offset_bias=0.0, use_roughness=True, roughness_scale=0.5,
              use_density_prediction=True, net_width_density=16),
    "E_prime": dict(use_voxel_grid=True, num_distance_samples=6, voxel_end=4.0,
                    use_far_field_points=True),
}


@pytest.mark.parametrize("case", sorted(STEP_SETS))
def test_nero_cache_step_under_option_set(case, monkeypatch):
    """One cache step of nero_ngp_yobo_bell with its SLF under the option
    set, through both trainers from the same weights and draws: every loss
    term, every gradient leaf, the Adam step and the reflectance grid's one
    leveled launch."""
    params = dict(slf_distance.narrow_slf_params(NERO), **STEP_SETS[case])
    bindings = slf_distance.scene_bindings(NERO) + [f"NeRFMLP.surface_lf_params = {params!r}"]
    jt, jmodel, tt = material_trainer._trainers(NERO, bindings, "cache")
    slf = tt.model.cache.shader.surface_lf
    for k, v in STEP_SETS[case].items():
        assert getattr(slf, k) == v, k
    variables = material_trainer._variables(jmodel, 5)
    material_trainer._step_parity(jt, jmodel, tt, variables, monkeypatch, ["leveled"])


# --- reference gaps ----------------------------------------------------------------------


def _jax_slf_raises(case_params, exc, match):
    params = dict(slf_distance.narrow_slf_params(NERO), use_env_alpha=True, **case_params)
    jconfigs.load_config(config_files=NERO, bindings=slf_distance.scene_bindings(NERO))
    jmod = jslf.SurfaceLightFieldMLP(config=jconfigs.Config(), **params)
    x = slf_distance._slf_inputs(1)
    with pytest.raises(exc, match=match), jhash.xla_encoder_scope():
        jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0),
                                         *_jax_args(x), roughness=x["roughness"],
                                         shader_bottleneck=x["bottleneck"]))
    return params


def _port_slf_raises(params, match):
    tgin.clear_config()
    tconfigs.load_config(config_files=NERO, bindings=slf_distance.scene_bindings(NERO))
    tmod = tslf.SurfaceLightFieldMLP(config=tconfigs.Config(), shader_bottleneck_dim=16,
                                     **params)
    with pytest.raises(NotImplementedError, match=match):
        slf_distance._slf_call(tmod, slf_distance._slf_inputs(1), torch.as_tensor, None)


def test_voxel_grid_off_triplets_raises_in_both():
    params = _jax_slf_raises(dict(use_voxel_grid=True, num_distance_samples=8), TypeError,
                             "reshape")
    _port_slf_raises(params, "reference gap.*TypeError: cannot reshape")


@pytest.mark.parametrize("field", ["use_reflectance_grid", "use_points"])
def test_points_without_a_source_raise_in_both(field):
    """Without the distance head or far-field points the SLF has no points:
    JAX fails at their first read."""
    case = dict(use_distance_prediction=False,
                use_reflectance_grid=field == "use_reflectance_grid",
                use_points=field == "use_points")
    params = _jax_slf_raises(case, (TypeError, AttributeError, ValueError), "")
    _port_slf_raises(params, f"{field} without use_distance_prediction.*reference gap")


def test_sorted_offsets_past_three_samples_give_nan_in_jax():
    """Sorted distances with point offsets at 8 samples: JAX's nudge gather
    fills NaN past index 2, and its points are NaN; the port raises naming
    it."""
    params = dict(slf_distance.narrow_slf_params(NERO), use_env_alpha=True,
                  **dict(CASES["sorted_offsets"], num_distance_samples=8))
    jgin.clear_config()
    jconfigs.load_config(config_files=NERO, bindings=slf_distance.scene_bindings(NERO))
    jmod = jslf.SurfaceLightFieldMLP(config=jconfigs.Config(), **params)
    x = slf_distance._slf_inputs(1)
    variables = _variables(jmod, x)
    with jhash.xla_encoder_scope():
        out = jmod.apply(variables, jax.random.PRNGKey(0), *_jax_args(x),
                         roughness=x["roughness"], shader_bottleneck=x["bottleneck"])
    assert np.isnan(np.asarray(out["incoming_rgb"])).any()
    _port_slf_raises(params, "reference gap.*NaN")


# --- the SLF's range under the environment map ------------------------------------------

# open_egg's env distance, 0.5, is its SLF's near plane: the SLF's range is
# empty and nothing it or its grids compute reaches a loss. At 2.0 the SLF
# (the cache shader's, and the memory's far plane) has a range to cover.
INSIDE = ["Config.env_map_distance = 2.0"]
# open_egg's material and SLF loss radius, 0.5, takes in none of the narrow
# synthetic scene's surface points: no material output would take a gradient.
LIVE_MATERIAL = ["Config.material_loss_radius = 10.0",
                 "Config.surface_light_field_loss_radius = 10.0"]
# nerf_ngp_yobo.gin's stop-gradient weights of the secondary cache queries:
# at open_egg's (1, 1) a query's `acc` and `acc_no_stopgrad` are one value
# with one gradient, and nothing tells the two transparencies apart.
SECONDARY_WEIGHTS = ["MaterialMLP.stopgrad_cache_weight = (1e2, 1e-4)"]
# Leaves that must take a gradient in both packages, by the port's names.
CACHE_LIVE = ("cache.shader.surface_lf.grid.hash_levels",
              "cache.shader.surface_lf.reflectance_grid.hash_levels",
              "cache.shader.env_map.output_ambient_rgb_layer.bias")
MATERIAL_LIVE = CACHE_LIVE + ("cache.env_map.output_rgba_layer.weight",
                              "cache.env_map.output_rgba_layer.bias")


def _live_variables(jmodel):
    """The parity's drawn weights (`material_trainer._variables`) with the
    cache's density MLPs' kernels at a tenth: at U(-0.5, 0.5) their
    density underflows to 0 and every camera ray is empty."""

    def scale(path, x):
        names = [str(getattr(p, "key", p)) for p in path]
        cache_mlp = names[1:3] == ["Cache", "Sampler"] and names[-1] == "kernel"
        return x * np.float32(0.1) if cache_mlp else x

    return jax.tree_util.tree_map_with_path(scale, material_trainer._variables(jmodel, 5))


def _assert_live(tt, jax_grads, names):
    params = dict(tt.model.named_parameters())
    for k in names:
        assert float(np.abs(jax_grads[k]).max()) > 0, k
        assert float(params[k].grad.abs().max()) > 0, k


def test_env_map_cache_step_inside_the_slf_range_matches_jax(monkeypatch):
    """open_egg's cache stage with the environment map and the SLF ending at
    2.0: the shader's map lights what the SLF leaves transparent, every loss
    term, gradient leaf and the Adam step against JAX's; the SLF's grids and
    the map take a gradient in both packages."""
    jt, jmodel, tt = material_trainer._trainers(
        env_map.OPEN, env_map.CACHE_BINDINGS + env_map.ENV + INSIDE, "cache")
    assert tt.model.cache.shader.surface_lf.distance_far == 2.0
    jax_grads = {}
    material_trainer._step_parity(jt, jmodel, tt, _live_variables(jmodel), monkeypatch,
                                  env_map.CACHE_LAUNCHES, jax_grads=jax_grads)
    _assert_live(tt, jax_grads, CACHE_LIVE)


def _recording_env_map_fn(monkeypatch, cls, record):
    """`cls._make_env_map_fn` handing `record` each lit lobe's env radiance
    times the transparency that its cache or memory query left."""
    real = cls._make_env_map_fn

    def make(self, *args, **kw):
        fn = real(self, *args, **kw)

        def env_map_fn(*a):
            out = fn(*a)
            record(out[0])
            return out

        return env_map_fn

    monkeypatch.setattr(cls, "_make_env_map_fn", make)


def test_env_map_material_step_inside_the_slf_range_matches_jax(monkeypatch):
    """The SLF material stage under the environment map with the SLF and
    the memory ending at 2.0, at weights where camera rays meet the
    surface: the direct lobes lit by the model's map where the cache left
    the secondary rays partly transparent (env x (1 - acc) nonzero, the
    same values in both packages; the queries' stop-gradient weights apart,
    so that `acc` and `acc_no_stopgrad` differ), every loss term, gradient
    leaf and the Adam step against JAX's; the model's map and the SLF's
    grids take a gradient in both."""
    from neural_radiance_caching_tpu.models import material_shader as jshader
    from neural_radiance_caching_tpu_torch.models import material_shader as tshader

    jt, jmodel, tt = material_trainer._trainers(
        env_map.OPEN,
        env_map.MATERIAL_BINDINGS + env_map.MATERIAL_ENV + INSIDE + LIVE_MATERIAL
        + SECONDARY_WEIGHTS, env_map.SLF_STAGE)
    assert tt.model.cache.surface_lf_mem.distance_far == 2.0
    jseen, tseen = [], []
    _recording_env_map_fn(monkeypatch, jshader.MaterialMLP, lambda rgb: jax.debug.callback(
        lambda v: jseen.append(float(v)), jnp.abs(rgb).max()))
    _recording_env_map_fn(monkeypatch, tshader.MaterialMLP,
                          lambda rgb: tseen.append(float(rgb.detach().abs().max())))
    jax_grads = {}
    material_trainer._step_parity(jt, jmodel, tt, _live_variables(jmodel), monkeypatch,
                                  env_map.MATERIAL_LAUNCHES, jax_grads=jax_grads)
    lit_j, lit_t = sorted(v for v in jseen if v > 0), sorted(v for v in tseen if v > 0)
    assert lit_t and len(lit_j) == len(lit_t)
    np.testing.assert_allclose(lit_t, lit_j, rtol=OUT[0])
    _assert_live(tt, jax_grads, MATERIAL_LIVE)
