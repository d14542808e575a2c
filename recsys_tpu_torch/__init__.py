"""recsys_tpu_torch — the PyTorch / CUDA port of ``recsys_tpu``.

It keeps the JAX package's module names and layout, so each module has a
counterpart of the same path under ``recsys_tpu/``. It imports PyTorch,
never JAX, and nothing of ``recsys_tpu``: the framework-free host layer
(config, data, serve store / batcher / ANN index, the native C++ sources)
is the port's own copy.
"""
