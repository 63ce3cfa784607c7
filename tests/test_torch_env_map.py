"""The environment map against the JAX package's, at test widths, on
open_ngp_yobo_egg with `NeRFModel.use_env_map`, `NeRFMLP.use_env_map` and
`MaterialMLP.use_env_map` bound True and the config's own `env_map_params`,
`env_map_near`, `env_map_far` and `Config.env_map_distance`:

- one cache step through both trainers (the cache shader's own map, the
  surface light field ending at the env distance);
- one step of the SLF material stage (the config's own `slf_variate`):
  the indirect lobes one at a time, the direct lobes lit by the cache's
  map where the cache or the memory left the secondary rays transparent,
  the cache queries ending at the env distance (the config's 0.5 is the
  SLF's near plane: its range is empty, and the SLF and its grids take no
  gradient; `tests/test_torch_slf_options.py` holds both steps again
  inside the SLF's range);
- `Model._handle_env_map` with the tables of `data/env_maps.build_env_map_tables`
  and the `env_map_only` pass alone, from the same weights;
- the configurations JAX cannot run raising in both packages.

Tolerances as in `tests/test_torch_slf_distance.py`: outputs to 1e-4
relative with an absolute 1e-5 x the largest entry, a step's loss terms to
1e-4 relative with an absolute 1e-7, every gradient leaf to rtol 2e-3 with
an absolute 2e-4 x its largest entry.
"""

import jax
import numpy as np
import pytest
import torch

import test_torch_material_slice as material_slice
import test_torch_material_trainer as material_trainer
import test_torch_slf_distance as slf_distance
import test_torch_trainer as trainer_test
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.data import env_maps as jenv_maps
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.models import construct as jconstruct
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch.data import env_maps as tenv_maps
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.models import construct as tconstruct
from neural_radiance_caching_tpu_torch.utils import weights

OPEN = slf_distance.OPEN
OUT = slf_distance.OUT
ENV = ["NeRFModel.use_env_map = True", "NeRFMLP.use_env_map = True"]
MATERIAL_ENV = ENV + ["MaterialMLP.use_env_map = True"]
CACHE_BINDINGS = slf_distance.scene_bindings(OPEN) + slf_distance.STEP_BINDINGS["open_egg"]
MATERIAL_BINDINGS = (CACHE_BINDINGS + material_trainer.MATERIAL_TINY + material_trainer.MATERIAL
                     + material_trainer.SMOOTH + ["Trainer.resample_render = True"])
SLF_STAGE = "material_surface_light_field_light"
# One cache step: the reflectance grid's and the SLF's own grid's backward.
CACHE_LAUNCHES = ["leveled", "leveled"]


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


def test_env_map_cache_step_matches_jax(monkeypatch):
    """open_egg's cache stage with the environment map: the cache shader's
    map along the reflected direction (JAX creates the shader's EnvMap, not
    the model's, which no cache-stage query reads), the SLF's far plane at
    `Config.env_map_distance`; every loss term, gradient leaf and the Adam
    step."""
    jt, jmodel, tt = material_trainer._trainers(OPEN, CACHE_BINDINGS + ENV, "cache")
    assert tt.config.env_map_distance == 0.5
    shader = tt.model.cache.shader
    assert shader.surface_lf.distance_far == 0.5 and not hasattr(tt.model.cache, "env_map")
    assert (shader.env_map.distance_near, shader.env_map.distance_far) == (0.5, 10.0)
    variables = material_trainer._variables(jmodel, 5)
    assert "EnvMap" in variables["params"]["Cache"]["Shader"]
    losses = material_trainer._step_parity(jt, jmodel, tt, variables, monkeypatch,
                                           CACHE_LAUNCHES)
    assert np.isfinite(sum(losses.values()))
    grad = dict(tt.model.named_parameters())[
        "cache.shader.env_map.output_ambient_rgb_layer.weight"].grad
    assert float(grad.abs().max()) > 0


@pytest.fixture
def material_pair():
    """The SLF material stage with the environment map in both packages
    (their gin bindings loaded: flax builds the submodules at the first
    apply), and the step's JAX parameters."""
    jt, jmodel, tt = material_trainer._trainers(OPEN, MATERIAL_BINDINGS + MATERIAL_ENV, SLF_STAGE)
    return jt, jmodel, tt, material_trainer._variables(jmodel, 5)


def test_env_map_material_step_matches_jax(material_pair, monkeypatch):
    """One step of the SLF material stage under the environment map: the
    map's parameters in the cache and its shader, every loss term, every
    gradient leaf (the model's map reached through the lit lobes) and the
    Adam step."""
    jt, jmodel, tt, variables = material_pair
    assert set(variables["params"]["Cache"]) >= {"EnvMap", "SurfaceLightFieldMem"}
    cache = tt.model.cache
    assert cache.surface_lf_mem.distance_far == 0.5 and cache.shader.env_map is not None
    assert tt.model.slf_variate and tt.model.shader.use_env_map
    # The map reaches the render through the variate's cache estimate (the
    # memory's opacity is 1 along every ray, the cache's below 1 at the port's
    # own initial weights): moving it moves the render. (At the parity's
    # drawn weights every camera ray is empty, so no material output takes a
    # gradient, in JAX too: the test inside the SLF's range below holds the
    # map's gradient at weights where the rays meet the surface.)
    own = {k: v.clone() for k, v in tt.model.state_dict().items()}
    losses = material_trainer._step_parity(jt, jmodel, tt, variables, monkeypatch,
                                           MATERIAL_LAUNCHES)
    assert np.isfinite(sum(losses.values()))
    tt.model.load_state_dict(own)
    rays = tt.dataset.next_train().rays

    def render():
        with torch.no_grad():
            return tt.model(torch.Generator().manual_seed(0), rays, train=True,
                            train_frac=0.25)["render"]["rgb"]

    before = render()
    with torch.no_grad():
        cache.env_map.output_rgba_layer.bias += 1.0
    assert not torch.equal(render(), before)


# The SLF material step under the environment map, leveled launches: the
# primary cache pass's two grids, the variate's per-lobe cache queries (two
# lobes, two grids each), the material shader's grid and the light
# sampler's.
MATERIAL_LAUNCHES = ["leveled"] * 8


def _rays(jt, tt):
    jrays = jdatasets.load_dataset("train", None, jt.config).next_train().rays
    trays = tt.dataset.next_train().rays
    return jrays, trays


def _apply_cache(jmodel, variables, method):
    with jhash.xla_encoder_scope():
        return jmodel.apply(variables, method=lambda m: method(m.cache))


def test_env_map_tables_lookup_matches_jax(material_pair):
    """`_handle_env_map` with env map tables (two illuminations, the rays'
    light index picking one): the equirectangular lookup along the rays'
    directions, in place of the learned map."""
    jt, jmodel, tt, variables = material_pair
    rng = np.random.RandomState(8)
    hdr = rng.uniform(0.0, 3.0, (8, 16, 3)).astype(np.float32)
    jtab = jenv_maps.build_env_map_tables(hdr)
    ttab = tenv_maps.build_env_map_tables(hdr)
    jrays, trays = _rays(jt, tt)
    want = _apply_cache(jmodel, variables, lambda c: c._handle_env_map(
        jax.random.PRNGKey(0), jrays, False, 1.0, env_map=jtab["env_map"],
        env_map_w=jtab["env_map_w"], env_map_h=jtab["env_map_h"]))
    got = tt.model.cache._handle_env_map(
        None, trays, False, 1.0, env_map=torch.as_tensor(np.asarray(ttab["env_map"])),
        env_map_w=ttab["env_map_w"], env_map_h=ttab["env_map_h"])
    assert sorted(got) == sorted(want) == ["incoming_rgb"]
    material_slice._close(got["incoming_rgb"].numpy(), np.asarray(want["incoming_rgb"]), *OUT,
                          "incoming_rgb")
    assert float(got["incoming_rgb"].max()) > 0


def test_env_map_only_pass_matches_jax(material_pair):
    """The `env_map_only` query of the cache: the learned map from each
    ray's origin along its direction, its radiance's gradient scaled by the
    outputs' weight (`incoming_rgb_no_stopgrad` unscaled), every output of
    the map against JAX's."""
    jt, jmodel, tt, variables = material_pair
    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    jrays, trays = _rays(jt, tt)
    weight = (1.0, 0.1)
    with jhash.xla_encoder_scope():
        want = jmodel.apply(variables, jax.random.PRNGKey(0), jrays, env_map_only=True,
                            use_env_map=True, train=False, stopgrad_cache_weight=weight,
                            method=lambda m, *a, **k: m.cache(*a, **k))
    got = tt.model.cache(None, trays, env_map_only=True, use_env_map=True, train=False,
                         stopgrad_cache_weight=weight)
    assert sorted(got) == sorted(want)
    assert "incoming_rgb_no_stopgrad" in got
    for k, v in want.items():
        material_slice._close(got[k].detach().numpy(), np.asarray(v), *OUT, k)


# --- reference gaps ----------------------------------------------------------------------


def test_material_env_map_without_the_caches_raises_in_both():
    """MaterialMLP.use_env_map over a cache without its map: JAX renders
    the env_map_only query as primary rays, passing the stop-gradient
    weights twice, and raises TypeError; the port refuses the model."""
    bindings = MATERIAL_BINDINGS + ["NeRFMLP.use_env_map = True",
                                    "MaterialMLP.use_env_map = True"]
    jt = trainer_test.synthesize("jax", OPEN, bindings, SLF_STAGE)
    jmodel = jconstruct.make_model(jt.config)
    with pytest.raises(TypeError, match="multiple values for keyword argument "
                       "'stopgrad_cache_weight'"), jhash.xla_encoder_scope():
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1),
                                           jpytrees.dummy_rays(4), train_frac=1.0, train=False))
    tt = trainer_test.synthesize("torch", OPEN, bindings, SLF_STAGE)
    with pytest.raises(NotImplementedError, match="reference gap.*multiple values"):
        tconstruct.make_model(tt.config, device="cpu")


def test_per_point_slf_in_the_cache_shader_raises_in_both():
    """An env map (or SLF) decoding per point in the cache shader: JAX's
    per-point decode returns no ambient radiance, which the shader reads."""
    params = dict(tgin_query_env_params(), per_ref_feature_output=True,
                  use_reflectance_grid=True, use_far_field_points=True,
                  reflectance_grid_params={"hash_map_size": 4096, "max_grid_size": 64})
    bindings = CACHE_BINDINGS + ENV + [f"NeRFMLP.env_map_params = {params!r}"]
    jt = trainer_test.synthesize("jax", OPEN, bindings, "cache")
    jmodel = jconstruct.make_model(jt.config)
    with pytest.raises(KeyError, match="incoming_ambient_rgb"), jhash.xla_encoder_scope():
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1),
                                           jpytrees.dummy_rays(4), train_frac=1.0, train=False))
    tt = trainer_test.synthesize("torch", OPEN, bindings, "cache")
    with pytest.raises(NotImplementedError, match="reference gap.*'incoming_ambient_rgb'"):
        tconstruct.make_model(tt.config, device="cpu")


def tgin_query_env_params():
    """open_egg's `NeRFModel.env_map_params`, as the port's gin reads them."""
    tgin.clear_config()
    trainer_test.synthesize("torch", OPEN, [], "cache")
    params = dict(tgin.query_parameter("NeRFModel.env_map_params"))
    tgin.clear_config()
    jgin.clear_config()
    return {k: v for k, v in params.items() if not callable(v)}


CORNELL = ["configs/transient_simulation_ngp_yobo_cornell.gin"]
CORNELL_FWP = ["configs/transient_simulation_ngp_yobo_cornell_fwp.gin"]


def _jax_init(files, bindings, stage):
    jt = trainer_test.synthesize("jax", files, bindings, stage)
    jmodel = jconstruct.make_model(jt.config)
    return jmodel, jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))


def test_cache_map_never_queried_raises_where_read_in_both():
    """The cache's map under a material shader that does not query it: JAX's
    init creates no EnvMap parameters, and a later read (the SLF pass, over
    the map) fails in flax; the port raises naming it."""
    bindings = MATERIAL_BINDINGS + ENV
    jmodel, shapes = _jax_init(OPEN, bindings, SLF_STAGE)
    assert "EnvMap" not in shapes["params"]["Cache"]
    rays = jpytrees.dummy_rays(4)
    with pytest.raises(Exception, match="EnvMap"), jhash.xla_encoder_scope():
        jax.eval_shape(lambda v: jmodel.apply(v, jax.random.PRNGKey(0), rays, train=False,
                                              passes=("surface_light_field",)), shapes)
    tgin.clear_config()
    tt = trainer_test.synthesize("torch", OPEN, bindings, SLF_STAGE)
    model = tconstruct.make_model(tt.config, device="cpu")
    assert not hasattr(model.cache, "env_map")
    trays = tt_rays(tt)
    with pytest.raises(NotImplementedError, match="reference gap.*ScopeParamNotFoundError"):
        model(None, trays, train=False, passes=("surface_light_field",))


def tt_rays(tt):
    """A train batch's rays of the port trainer `tt` (its datasets loaded)."""
    tt._setup_rng()
    tt._load_datasets()
    return tt.dataset.next_train().rays


def test_passive_transient_shader_map_raises_in_both():
    """cornell_fwp's passive transient shader with its map on: JAX builds no
    EnvMap for a transient shader and its passive path reads one."""
    bindings = trainer_test.HOTDOG_BINDINGS + trainer_test.TINY + [
        "TransientNeRFMLP.use_env_map = True"]
    with pytest.raises(AttributeError, match="env_map"):
        _jax_init(CORNELL_FWP, bindings, "cache")
    tt = trainer_test.synthesize("torch", CORNELL_FWP, bindings, "cache")
    with pytest.raises(NotImplementedError, match="reference gap.*AttributeError"):
        tconstruct.make_model(tt.config, device="cpu")


def test_transient_cache_map_raises_in_both():
    """cornell's transient cache with the model's map on: JAX's
    TransientNeRFModel builds no EnvMap, and its shadow rays' secondary
    query reads one (at init, under the occlusion bindings); the port raises
    naming it at such a query."""
    import test_torch_transient_trainer as transient_trainer

    bindings = transient_trainer.TRANSIENT_TINY + transient_trainer.OCCLUSIONS + [
        "TransientNeRFModel.use_env_map = True"]
    with pytest.raises(AttributeError, match="env_map"):
        _jax_init(CORNELL, bindings, "cache")
    tgin.clear_config()
    tt = trainer_test.synthesize("torch", CORNELL, bindings, "cache")
    tt._setup_rng()
    tt._load_datasets()
    tt._setup_model()
    _, trays = transient_trainer._rays(tt)
    with pytest.raises(NotImplementedError, match="reference gap.*no attribute 'env_map'"):
        tt.model.cache(None, trays, is_secondary=True, weights_only=True)
