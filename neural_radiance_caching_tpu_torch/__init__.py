"""PyTorch/CUDA port of the radiance-cache inverse renderer.

The JAX package ``neural_radiance_caching_tpu`` is the reference: this package
keeps its module layout (``ops/``, ``models/``, ``parallel/``, ``data/``,
``utils/``, ``engine/``) and its function and class names, so each piece has
an obvious counterpart. It imports ``torch`` and never ``jax``.

Users train through ``python -m neural_radiance_caching_tpu_torch.train_with_trainer``
(the gin configs of ``configs/``, the staged ``engine/trainer.Trainer``);
the flagship builders (``flagship.py``) give the JAX bench's four stages.
The hand-written kernels are the hash-grid table-gradient scatters
(``ops/scatter_cuda.py``, CUDA source in ``csrc/``).
"""
