"""repro_torch: the GLORAN range-delete LSM store on PyTorch and CUDA.

A port of the JAX package ``repro`` (which stays the reference).  Host
control code — core structures, the LSM tree, routing and planning — is
numpy as in the reference; filter state lives in torch tensors on one
device, and the lookup and compaction hot spots run as hand-written
CUDA kernels (``kernels/``, sources in ``csrc/``).  Nothing here imports
``jax`` or ``repro``.
"""
