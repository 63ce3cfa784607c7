"""InvProp's baseline scenes against the JAX package's, at test widths: the
passive transient cache shader of the simulated `_fwp` scenes
(`TransientNeRFMLP.use_active=False`) and the transient shader without
indirect light of the `_tnerf` scenes and pots_kitchen
(`use_indirect=False`, whose zero transient the render shifts as JAX's
does), one cache step each through both trainers; and their material
stages, which neither package can run.

Tolerances (float32), those of `test_torch_invprop_scenes.py`: loss terms
of a train step to 1e-4 relative with an absolute 1e-7; every gradient
leaf to rtol 2e-3 with an absolute 2e-4 x the leaf's largest entry; after
the trainer's Adam step a parameter within 2 x its group's learning rate
of optax's.
"""

import jax
import numpy as np
import pytest
import torch

import test_torch_material_slice as material_slice
import test_torch_material_trainer as material_trainer
import test_torch_transient_material_trainer as transient_material_trainer
import test_torch_trainer as trainer_test
import test_torch_transient_trainer as transient_trainer
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.models import construct as jconstruct
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.models import construct as tconstruct
from neural_radiance_caching_tpu_torch.utils import weights

FWP = ["configs/transient_simulation_ngp_yobo_cornell_fwp.gin"]
TNERF = ["configs/transient_simulation_ngp_yobo_cornell_tnerf.gin"]
SCENES = {"cornell_fwp": FWP, "cornell_tnerf": TNERF}
TRAIN_FRAC = 0.25


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_one_cache_step_through_both_trainers(scene, monkeypatch):
    """One cache step from the same weights and draws: every loss term,
    every gradient leaf, the Adam step; the leveled kernel's one launch (the
    appearance grid). cornell_fwp: the passive shader (no light, no
    transient of its own; the direct pulse binned by each sample's light
    path from the density output), its SLF's binned head unread.
    cornell_tnerf: the active shader with a zero transient and no ambient
    term, so no tint, integrated BRDF or indirect heads."""
    jt, jmodel, tt = transient_trainer._cornell((), SCENES[scene])
    shader = tt.model.cache.shader
    if scene == "cornell_fwp":
        assert not shader.use_active and shader.surface_lf.use_indirect
        assert hasattr(shader, "irradiance_layer") and not hasattr(shader, "albedo_layer")
    else:
        assert shader.use_active and not shader.use_indirect and not shader.use_ambient
        assert not hasattr(shader, "tint_layer") and not hasattr(shader, "irradiance_layers")
        assert shader.surface_lf.output_rgba_layer.out_features == 3 + 1
    variables = material_trainer._variables(jmodel, 5)
    got, calls = transient_material_trainer._step_parity(jt, jmodel, tt, variables, monkeypatch)
    assert calls == ["leveled"]
    assert got["data"] > 0 and "cache_data" in got


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_material_stage_raises_in_both(scene):
    """`material_light_from_scratch` of the passive (`use_indirect=True`)
    and the no-indirect material shader: JAX's forward raises an
    AttributeError at the first read of the direct lobe's sums (the float
    0.0 they are seeded with; its parameters' init traces the forward and
    raises there), the port names that failure at construction."""
    stage = "material_light_from_scratch"
    bindings = transient_material_trainer.MATERIAL_TINY
    jt = trainer_test.synthesize("jax", SCENES[scene], bindings, stage)
    jmodel = jconstruct.make_model(jt.config)
    jdata = jdatasets.load_dataset("train", None, jt.config)
    want = "'shape'" if scene == "cornell_fwp" else "'reshape'"
    with pytest.raises(AttributeError, match=f"'float' object has no attribute {want}"):
        # The parameters' init traces the forward, which raises already.
        variables = material_trainer._variables(jmodel, 5)
        with material_slice.injected(7), jhash.xla_encoder_scope():
            jax.eval_shape(
                transient_material_trainer.jax_step_loss(jmodel, jt.config, jdata, TRAIN_FRAC),
                variables, jdata.next_train())
    tt = trainer_test.synthesize("torch", SCENES[scene], bindings, stage)
    with pytest.raises(NotImplementedError, match=f"use_active=False: the JAX package .*{want}"):
        tconstruct.make_model(tt.config, device="cpu")


def test_zero_transient_is_shifted_and_composited():
    """cornell_tnerf's shader hands the render a zero transient of
    [..., samples, bins, C] (JAX repeats its zeros over the bins), which the
    render shifts and composites into zeros: the indirect render is 0 and
    the rgb is the direct pulses alone."""
    jt, jmodel, tt = transient_trainer._cornell((), TNERF)
    variables = material_trainer._variables(jmodel, 5)
    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    _, trays = transient_trainer._rays(tt)
    with material_slice.injected(3), torch.no_grad():
        out = tt.model(tt.rng, trays, train_frac=TRAIN_FRAC, train=True, compute_extras=False)
    shader, render = out["main"]["shader"], out["render"]
    n_bins = tt.config.n_bins
    assert shader["transient_indirect"].shape[-2:] == (n_bins, 3)
    assert float(shader["transient_indirect"].abs().max()) == 0
    assert float(render["transient_indirect"].abs().max()) == 0
    assert float(render["transient_direct"].abs().max()) > 0
    np.testing.assert_array_equal(render["rgb"].numpy(), render["transient_direct"].numpy())
