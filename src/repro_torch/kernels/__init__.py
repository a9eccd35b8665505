"""Hand-written Hopper kernels of the port, each beside its plain version.

  gram/          K = scale * X_S X_S^T over the worker-major (W, N) stack
                 (replaces repro/kernels/gram/kernel.py::tree_gram_pallas)
  weighted_sum/  d = sum_w c_w X[w, :]
                 (replaces repro/kernels/weighted_sum/kernel.py::
                 weighted_sum_pallas)

Each kernel ships ``ref.py`` (plain PyTorch version), ``kernel.py`` (the
``ctypes`` binding of ``csrc/<name>.cu``, with a launch counter) and
``ops.py`` (dispatch by the tensor's device: CUDA -> kernel, CPU -> plain).
``_build.py`` compiles the CUDA sources with ``nvcc`` at first use.
"""
