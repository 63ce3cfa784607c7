"""Model construction entry point (counterpart of ``models/construct.py``)."""

from __future__ import annotations

from neural_radiance_caching_tpu_torch.engine.configs import ModelType
from neural_radiance_caching_tpu_torch.models import material_model, nerf_model
from neural_radiance_caching_tpu_torch.utils import torchutil


def make_model(config, device="cuda"):
    """The configured model on `device` (the gin bindings supply its
    parameters): a NeRFModel for ``ModelType.DEFAULT``, else a material
    model; the transient variants with ``Config.use_transient``.

    Parameters are initialised on the CPU from torch's default generator and
    then moved, so one seed gives the same weights on every device; a CUDA
    device raises without a card.
    """
    torchutil.check_device(device, "a model", "build it on the CPU")
    if config.model_type == ModelType.DEFAULT:
        cls = nerf_model.TransientNeRFModel if config.use_transient else nerf_model.NeRFModel
    else:
        cls = (material_model.TransientMaterialModel if config.use_transient
               else material_model.MaterialModel)
    return cls(config=config).to(device)
