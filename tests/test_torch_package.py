"""Package boundaries of the PyTorch port: it imports without JAX, its
sources name no JAX library, and the weight bridge covers every leaf of the
full-width flagship cache, material and transient cache models in both
directions."""

import importlib
import pathlib
import pkgutil
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

import bench
import neural_radiance_caching_tpu_torch as port
from neural_radiance_caching_tpu.models.nerf_model import NeRFModel as JNeRFModel
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch import flagship
from neural_radiance_caching_tpu_torch.models.nerf_model import NeRFModel
from neural_radiance_caching_tpu_torch.utils import weights

PKG_DIR = pathlib.Path(port.__file__).parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG_DIR)], port.__name__ + "."))


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in ('jax', 'jaxlib', 'flax', 'optax', 'neural_radiance_caching_tpu')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG_DIR.parent, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_sources_name_no_jax_library():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|"
                         r"neural_radiance_caching_tpu)(\.|\s|$)", re.M)
    offenders = [str(p) for p in PKG_DIR.rglob("*.py") if pattern.search(p.read_text())]
    assert not offenders
    assert len(_modules()) >= 25
    for name in _modules():
        importlib.import_module(name)


def test_port_and_chip_smoke_name_no_reader_missing_on_the_card():
    """Neither the port nor chip_smoke.py imports JAX, the JAX package, or a
    reader the card's machine lacks (h5py, PIL, OpenCV, imageio): the port
    reads h5, PNG and EXR with its own code."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|h5py|PIL|cv2|imageio|"
                         r"neural_radiance_caching_tpu)(\.|\s|$)", re.M)
    sources = list(PKG_DIR.rglob("*.py")) + [PKG_DIR.parent / "chip_smoke.py"]
    assert not [str(p) for p in sources if pattern.search(p.read_text())]


@pytest.fixture(scope="module")
def flagship_pair():
    jcfg = bench._cache_config()
    jmodel = JNeRFModel(config=jcfg, **bench.flagship_cache_params(jcfg))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tmodel = flagship.build_flagship_cache_model(flagship.cache_config(), device="cpu")
    return tree, tmodel


def test_bridge_covers_every_flagship_leaf(flagship_pair):
    tree, tmodel = flagship_pair
    leaves = jax.tree_util.tree_leaves(tree)
    sd = weights.state_dict_from_jax(tree, tmodel)
    assert len(sd) == len(leaves) == len(tmodel.state_dict())
    assert sum(v.numel() for v in sd.values()) == sum(x.size for x in leaves)
    # Tables are copied as they are; Dense kernels are transposed.
    grid = tree["params"]["Sampler"]["MLP_2"]["density_grid"]
    assert tuple(sd["sampler.mlps.2.grid.hash_levels"].shape) == grid["hash_levels"].shape
    kernel = tree["params"]["Shader"]["SurfaceLightField"]["layer_bottleneck"]["kernel"]
    assert tuple(sd["shader.surface_lf.view_dependent_layers.layer_bottleneck.weight"].shape) \
        == kernel.shape[::-1]
    tmodel.load_state_dict(sd)


def test_bridge_raises_on_leftover_or_missing_leaves(flagship_pair):
    tree, tmodel = flagship_pair
    extra = jax.tree_util.tree_map(lambda x: x, tree)
    extra["params"]["Shader"]["bogus_layer"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="bogus_layer"):
        weights.state_dict_from_jax(extra, tmodel)
    missing = jax.tree_util.tree_map(lambda x: x, tree)
    del missing["params"]["Shader"]["tint_layer"]
    with pytest.raises(KeyError, match="tint_layer"):
        weights.state_dict_from_jax(missing, tmodel)


def test_unknown_and_unported_options_raise():
    cfg = flagship.cache_config()
    with pytest.raises(TypeError, match="bogus"):
        NeRFModel(config=cfg, bogus=1, **flagship.flagship_cache_params())
    with pytest.raises(NotImplementedError, match="resample"):
        NeRFModel(config=cfg, resample=True, **flagship.flagship_cache_params())


def test_bridge_covers_every_flagship_material_leaf():
    import dataclasses

    jcfg = dataclasses.replace(bench._cache_config(), batch_size=1536)
    jmodel = bench.build_flagship_material_model(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tmodel = flagship.build_flagship_material_model(flagship.material_config(), device="cpu")
    sd = weights.state_dict_from_jax(tree, tmodel)
    leaves = jax.tree_util.tree_leaves(tree)
    assert len(sd) == len(leaves) == len(tmodel.state_dict())
    assert sum(v.numel() for v in sd.values()) == sum(x.size for x in leaves)
    grid = tree["params"]["MaterialShader"]["material_grid"]
    assert tuple(sd["shader.grid.hash_levels"].shape) == grid["hash_levels"].shape
    assert tuple(sd["light_sampler.output_layer.weight"].shape) == \
        tree["params"]["LightSampler"]["output_layer"]["kernel"].shape[::-1]
    tmodel.load_state_dict(sd)


def test_unported_material_options_raise():
    cfg = flagship.material_config()
    params = flagship.flagship_material_params()
    shader = dict(params["shader_params"], use_active=True)
    with pytest.raises(NotImplementedError, match="use_active"):
        flagship.build_flagship_material_model(cfg, dict(params, shader_params=shader),
                                               device="cpu")


def _port_material_model(config, jmm):
    """The port's counterpart of test_material_model.make_material_model
    (its JAX functions swapped for the port's)."""
    import torch

    from neural_radiance_caching_tpu_torch.models.layers import softplus
    from neural_radiance_caching_tpu_torch.models.material_model import MaterialModel
    from neural_radiance_caching_tpu_torch.ops import coord

    jmodel = jmm.make_material_model(config, slf_variate=True)
    swap = {jmm.coord.contract_radius_2: coord.contract_radius_2, jax.nn.softplus: softplus}

    def port(v):
        if isinstance(v, dict):
            return {k: port(x) for k, x in v.items()}
        if isinstance(v, tuple):
            return tuple(port(x) for x in v)
        return swap.get(v, v) if callable(v) else v

    kwargs = {k: port(getattr(jmodel, k)) for k in (
        "cache_model_params", "use_light_sampler", "light_sampler_params", "shader_params",
        "resample", "num_resample", "slf_variate")}
    return jmodel, MaterialModel(config=config, **kwargs).to(torch.float32)


def test_slf_variate_without_an_slf_matches_jax():
    """The SLF variate of a model without an SLF memory (JAX's runs whenever
    slf_variate is set): a second estimate of the cache at the detached
    surface points, whose secondary rays replace the main pass's and whose
    radiance, times the detached surface weights, adds to the render. The
    forward against test_material_model's JAX model, on the same weights and
    draws, to 1e-4 relative (a ~100-op forward)."""
    import torch

    import test_material_model as jmm
    import test_torch_material_slice as material_slice
    from neural_radiance_caching_tpu.engine.configs import Config as JConfig
    from neural_radiance_caching_tpu.ops import hashgrid as jhash
    from neural_radiance_caching_tpu_torch.engine.configs import Config as TConfig
    from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees

    kw = dict(near=0.2, far=6.0, secondary_far=2.0, mask_lossmult=False, material_loss_radius=2.0,
              linear_to_srgb=True, dataset_loader="synthetic_spheres")
    jmodel, tmodel = _port_material_model(JConfig(**kw), jmm)
    tmodel.config = TConfig(**kw)
    for m in tmodel.modules():
        if hasattr(m, "config") and m.config is not None:
            m.config = tmodel.config
    jrays = jpytrees.dummy_rays(6)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1),
                                                jrays, train_frac=0.5, train=True))
    variables = material_slice.random_variables(shapes, 2)
    tmodel.load_state_dict(weights.state_dict_from_jax(variables, tmodel))
    trays = tpytrees.Rays(**{k: None if v is None else torch.as_tensor(np.asarray(v))
                             for k, v in vars(jrays).items()})
    with material_slice.injected(3), jhash.xla_encoder_scope():
        def forward(v, r):
            out = jmodel.apply(v, jax.random.PRNGKey(2), r, train_frac=0.5, train=True)
            shader = {k: x for k, x in out["main"]["shader"].items()
                      if k.startswith("ref_rays") or hasattr(x, "shape")}
            return {"render": out["render"], "main": {"shader": shader}}

        jout = jax.jit(forward)(variables, jrays)
    with material_slice.injected(3), torch.no_grad():
        tout = tmodel(torch.Generator(), trays, train_frac=0.5, train=True)
    for k in ("rgb", "diffuse_rgb", "specular_rgb", "lighting_irradiance"):
        np.testing.assert_allclose(tout["render"][k].numpy(), np.asarray(jout["render"][k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    jshader, tshader = jout["main"]["shader"], tout["main"]["shader"]
    assert sorted(k for k in tshader if k.startswith("ref_rays")) == sorted(
        k for k in jshader if k.startswith("ref_rays"))
    assert "irradiance_cache" not in jshader and "irradiance_cache" not in tshader
    # The variate's rays: 2 per lobe (num_secondary_samples 4, where the main
    # pass's are 2 per lobe too, num_secondary_samples_diff being unread).
    for lobe in ("specular", "diffuse"):
        np.testing.assert_allclose(
            tshader[f"ref_rays_indirect_{lobe}"].viewdirs.numpy(),
            np.asarray(jshader[f"ref_rays_indirect_{lobe}"].viewdirs), rtol=1e-4, atol=1e-6)


def test_bridge_covers_every_flagship_transient_leaf():
    import dataclasses

    jcfg = dataclasses.replace(
        bench._cache_config(), batch_size=2048, use_transient=True, n_bins=700,
        exposure_time=0.02, learnable_light=True, light_source_position=[0.0, 0.0, 1.0],
        data_loss_type="rawnerf_transient_unbiased", linear_to_srgb=False)
    jmodel = bench.build_flagship_transient_cache_model(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tmodel = flagship.build_flagship_transient_cache_model(flagship.transient_config(),
                                                           device="cpu")
    sd = weights.state_dict_from_jax(tree, tmodel)
    leaves = jax.tree_util.tree_leaves(tree)
    assert len(sd) == len(leaves) == len(tmodel.state_dict())
    assert sum(v.numel() for v in sd.values()) == sum(x.size for x in leaves)
    shader = tree["params"]["Shader"]
    # The time-binned heads: 3 x 700 channels (+ alpha on the SLF's).
    assert tuple(sd["shader.transient_indirect_layer.weight"].shape) == \
        shader["transient_indirect_layer"]["kernel"].shape[::-1] == (2100, 64)
    assert sd["shader.surface_lf.output_rgba_layer.bias"].shape[0] == 2101
    for key in ("shader.light_power", "shader.albedo_layer.weight", "shader.brdf_layers.1.weight",
                "shader.output_brdf_layer.bias", "shader.irradiance_layers.0.weight"):
        assert key in sd
    tmodel.load_state_dict(sd)
