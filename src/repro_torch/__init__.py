"""PyTorch/CUDA port of the Flag-Aggregator training system.

A second package beside the JAX reference ``repro``: the same layout
(``core/``, ``kernels/<name>/{ref,kernel,ops}.py``, ``dist/``, ``models/``,
``configs/``, ``optim/``, ``data/``, ``launch/``), PyTorch idiom inside,
and hand-written CUDA kernels for Hopper (``csrc/``) where the JAX package
has Pallas kernels.  It never imports ``jax`` or ``repro``.

Main path: ``python -m repro_torch.launch.train`` -- per-worker gradients
into one (W, N) buffer, attack, tree Gram (CUDA kernel), FA weights,
weighted combine (CUDA kernel), optimizer step.
"""
