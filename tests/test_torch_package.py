"""Package boundaries of the PyTorch port: it imports without JAX, its
sources name no JAX library, and the weight bridge covers every leaf of the
full-width flagship cache model in both directions."""

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


@pytest.fixture(scope="module")
def flagship_pair():
    jcfg = bench._cache_config()
    jmodel = JNeRFModel(config=jcfg, **bench.flagship_cache_params(jcfg))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tmodel = flagship.build_flagship_cache_model(flagship.cache_config())
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
