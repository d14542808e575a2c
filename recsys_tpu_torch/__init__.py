"""recsys_tpu_torch — the PyTorch / CUDA port of ``recsys_tpu``.

It keeps the JAX package's module names and layout, so each module has a
counterpart of the same path under ``recsys_tpu/``. It imports PyTorch and
never JAX; the framework-free host layer (config, data, serve store/ANN
index) is reused from ``recsys_tpu`` as it is.
"""
