"""The flagship model builders' device: the card unless the caller passes
``device="cpu"``, raising without one (as the datasets do), the same
weights from one seed on either device, and the JAX weight bridge onto a
model that is already on the card.

This file imports no JAX, so its GPU-marked test also runs on a machine
without it: ``python -m pytest --noconftest tests/test_torch_builders.py``.
"""

import numpy as np
import pytest
import torch

from neural_radiance_caching_tpu_torch import flagship
from neural_radiance_caching_tpu_torch.models import layers
from neural_radiance_caching_tpu_torch.utils import weights

BUILDERS = {
    "cache": (flagship.build_flagship_cache_model, flagship.cache_config),
    "material": (flagship.build_flagship_material_model, flagship.material_config),
    "transient": (flagship.build_flagship_transient_cache_model, flagship.transient_config),
    "transient_material": (flagship.build_flagship_transient_material_model,
                           flagship.transient_material_config),
}


@pytest.mark.parametrize("stage", sorted(BUILDERS))
def test_builder_puts_the_model_on_the_card_unless_told_otherwise(stage):
    build, config = BUILDERS[stage]
    cfg = config()
    torch.manual_seed(0)
    on_cpu = build(cfg, device="cpu")
    assert {p.device.type for p in on_cpu.parameters()} == {"cpu"}
    if torch.cuda.is_available():
        torch.manual_seed(0)
        on_card = build(cfg)
        assert {p.device.type for p in on_card.parameters()} == {"cuda"}
        # Initialised on the CPU and moved: one seed, the same weights.
        for key, value in on_card.state_dict().items():
            assert torch.equal(value.cpu(), on_cpu.state_dict()[key]), key
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(cfg, device="cuda:0")


@pytest.mark.gpu
def test_bridge_loads_onto_a_model_on_the_card():
    # JAX trees of two of the cache model's modules, as the bridge reads
    # them: a hash grid's tables (copied as they are) and a Dense layer
    # (kernel [in, out] transposed to the weight).
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = flagship.build_flagship_cache_model(flagship.cache_config())
    grid = model.sampler.mlps[2].grid
    dense = next(m for m in model.modules()
                 if isinstance(m, layers.Dense) and m.bias is not None)
    rng = np.random.RandomState(0)

    def like(t):
        return rng.uniform(-1, 1, tuple(t.shape)).astype(np.float32)

    trees = ((grid, {"hash_levels": like(grid.hash_levels),
                     "dense_levels": like(grid.dense_levels)}),
             (dense, {"kernel": like(dense.weight.T), "bias": like(dense.bias)}))
    for module, tree in trees:
        sd = weights.state_dict_from_jax({"params": tree}, module)
        assert {v.device.type for v in sd.values()} == {"cuda"}
        module.load_state_dict(sd)
    torch.testing.assert_close(grid.hash_levels.cpu(),
                               torch.as_tensor(trees[0][1]["hash_levels"]), rtol=0, atol=0)
    torch.testing.assert_close(dense.weight.cpu(), torch.as_tensor(trees[1][1]["kernel"].T),
                               rtol=0, atol=0)
