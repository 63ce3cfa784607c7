"""The port's gin engine and Config against the JAX package's: every
configs/*.gin file parses into an equal Config, every binding names a field
of the port's class, the port's configurable defaults equal JAX's, and the
gin function registry resolves to functions that compute what JAX's do.

Callables compare by the gin name they are registered under, enums by
value, and the JAX importance-sampler objects of the (unported) sampler
tuples by class name. Function values agree to 1e-6 relative (float32, the
same formulas).
"""

import dataclasses
import enum
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_radiance_caching_tpu.engine import configs as jconfigs
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu_torch.engine import configs as tconfigs
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin

CONFIG_FILES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs",
                                             "*.gin")))

# Configurables that gin files bind and the port does not register yet.
UNREGISTERED = {"VignetteMap", "EnvironmentSampler"}

CONFIGURABLES = (
    "NeRFModel", "TransientNeRFModel", "MaterialModel", "TransientMaterialModel",
    "ProposalVolumeSampler", "DensityMLP", "HashEncoding", "NeRFMLP", "TransientNeRFMLP",
    "SurfaceLightFieldMLP", "TransientSurfaceLightFieldMLP", "MaterialMLP",
    "TransientMaterialMLP", "LightMLP", "LightSourceMap", "VolumeIntegrator",
    "TransientVolumeIntegrator", "Trainer",
)


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


def _gin_names(registry):
    return {id(v): k for k, v in registry.items() if "." in k}


def normalize(value, names):
    """A value with its callables replaced by their gin names, enums by their
    values and sampler objects by their class names."""
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, dict):
        return {k: normalize(v, names) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(normalize(v, names) for v in value)
    if isinstance(value, (str, int, float, bool, type(None))):
        return value
    if id(value) in names:
        return "@" + names[id(value)]
    if type(value).__name__.endswith("Sampler"):
        return type(value).__name__
    if dataclasses.is_dataclass(value):
        return (type(value).__name__, normalize(dataclasses.asdict(value), names))
    raise TypeError(f"no normal form for {value!r}")


def _config_dict(config, registry):
    names = _gin_names(registry)
    return {f.name: normalize(getattr(config, f.name), names)
            for f in dataclasses.fields(config)}


def load_both(config_files=(), bindings=()):
    jcfg = jconfigs.load_config(config_files=config_files, bindings=bindings)
    tcfg = tconfigs.load_config(config_files=config_files, bindings=bindings)
    return jcfg, tcfg


@pytest.mark.parametrize("path", CONFIG_FILES, ids=os.path.basename)
def test_config_file_parses_into_equal_config(path):
    jcfg, tcfg = load_both([path])
    want = _config_dict(jcfg, jgin._REGISTRY)
    got = _config_dict(tcfg, tgin._REGISTRY)
    assert got.pop("transient_shift_form") == "fft"
    assert got == want


def test_config_fields_and_defaults_equal_jax():
    want = _config_dict(jconfigs.Config(), jgin._REGISTRY)
    got = _config_dict(tconfigs.Config(), tgin._REGISTRY)
    assert set(got) - set(want) == {"transient_shift_form"}
    got.pop("transient_shift_form")
    assert got == want
    # A Config never raises when it is built.
    tconfigs.Config(use_shift_invariance=True)


def test_every_binding_names_a_port_field():
    tconfigs.register_all_configurables()
    unregistered, missing = set(), set()
    assert len(CONFIG_FILES) == 91
    for path in CONFIG_FILES:
        tgin.clear_config()
        tgin.parse_config_files_and_bindings([path])
        for cname, bindings in tgin._BINDINGS.items():
            cls = tgin._REGISTRY.get(cname)
            if cls is None:
                unregistered.add(cname)
                continue
            fields = getattr(cls, "__dataclass_fields__", {})
            missing |= {f"{cname}.{k}" for k in bindings if not (hasattr(cls, k) or k in fields)}
    assert not missing
    assert unregistered == UNREGISTERED


@pytest.mark.parametrize("name", CONFIGURABLES)
def test_configurable_defaults_equal_jax(name):
    jconfigs.register_all_configurables()
    tconfigs.register_all_configurables()
    jcls, tcls = jgin._REGISTRY[name], tgin._REGISTRY[name]
    jnames, tnames = _gin_names(jgin._REGISTRY), _gin_names(tgin._REGISTRY)
    diffs = []
    for f in dataclasses.fields(jcls):
        if f.name in ("parent", "name", "config"):
            continue
        default = f.default if f.default is not dataclasses.MISSING else f.default_factory()
        if not hasattr(tcls, f.name):
            diffs.append((f.name, "missing"))
            continue
        want, got = normalize(default, jnames), normalize(getattr(tcls, f.name), tnames)
        if got != want:
            diffs.append((f.name, want, got))
    assert not diffs


def test_explicit_keywords_win_and_subclasses_take_their_own_bindings():
    tconfigs.load_config(bindings=[
        "DensityMLP.net_width = 7", "NeRFModel.num_resample = 5",
        "TransientNeRFModel.num_resample = 3"])
    from neural_radiance_caching_tpu_torch.models import geometry

    assert geometry.DensityMLP(config=tconfigs.Config()).net_width == 7
    assert geometry.DensityMLP(config=tconfigs.Config(), net_width=9).net_width == 9
    assert tgin.query_parameter("TransientNeRFModel.num_resample") == 3
    assert tgin.query_parameter("Config.max_steps") == 25000
    assert "DensityMLP.net_width = 7" in tgin.operative_config_str()


def test_unported_field_raises_naming_it():
    from neural_radiance_caching_tpu_torch.models import geometry

    geometry.DensityMLP(config=tconfigs.Config(), use_feature_filter=False)
    with pytest.raises(NotImplementedError, match="use_feature_filter"):
        geometry.DensityMLP(config=tconfigs.Config(), use_feature_filter=True)
    with pytest.raises(TypeError, match="no field"):
        geometry.DensityMLP(config=tconfigs.Config(), not_a_field=1)


_X = np.random.RandomState(0).uniform(-2.5, 2.5, (7, 3)).astype(np.float32)
# gin name -> keyword arguments of the call compared.
FUNCTION_CASES = {
    "math.power_ladder": dict(p=-1.5, premult=2.0),
    "math.inv_power_ladder": dict(p=-1.5, premult=2.0),
    "math.laplace_cdf": dict(beta=0.3),
    "math.scaled_softplus": dict(scale=10.0),
    "math.power_3": {},
}


@pytest.mark.parametrize("name", sorted(k for k in tconfigs.GIN_FUNCTIONS
                                        if k != "math.create_learning_rate_decay"))
def test_gin_functions_compute_what_jax_computes(name):
    jconfigs.register_all_configurables()
    jfn, tfn = jgin._resolve_ref(name), tgin._resolve_ref(name)
    assert tfn is tconfigs.GIN_FUNCTIONS[name]
    kwargs = FUNCTION_CASES.get(name, {})
    x = _X if name != "math.inv_power_ladder" else np.clip(_X, -1.5, 1.5)
    if name in ("math.safe_log", "math.safe_sqrt", "jnp.log"):
        x = np.abs(x) + 0.1
    want = np.asarray(jfn(jnp.asarray(x), **kwargs))
    got = tfn(torch.as_tensor(x), **kwargs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)


def test_learning_rate_decay_factory_matches_jax():
    jfn = jgin._resolve_ref("math.create_learning_rate_decay")
    tfn = tgin._resolve_ref("math.create_learning_rate_decay")
    kw = dict(lr_init=1e-2, lr_final=1e-4, max_steps=100, lr_delay_steps=10, lr_delay_mult=0.1)
    for step in (0, 5, 50, 100):
        np.testing.assert_allclose(tfn(**kw)(step), float(jfn(**kw)(step)), rtol=1e-6)
