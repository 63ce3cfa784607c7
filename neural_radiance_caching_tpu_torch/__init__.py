"""PyTorch/CUDA port of the radiance-cache inverse renderer.

The JAX package ``neural_radiance_caching_tpu`` is the reference: this package
keeps its module layout (``ops/``, ``models/``, ``parallel/``, ``data/``,
``utils/``, ``engine/``) and its function and class names, so each piece has
an obvious counterpart. It imports ``torch`` and never ``jax``.

The first slice covers the flagship cache-stage train step
(``flagship.build_flagship_cache_model`` + ``parallel.train``). Its one
hand-written kernel is the hash-grid table-gradient scatter
(``ops/scatter_cuda.py``, CUDA source in ``csrc/``).
"""
