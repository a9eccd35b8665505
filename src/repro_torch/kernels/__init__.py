"""Hand-written Hopper kernels of the port, each beside its plain version.
Every function of the JAX package that reaches ``pl.pallas_call`` has its
counterpart here:

  gram/          K = scale * X_S X_S^T over the worker-major (W, N) stack
                 (replaces repro/kernels/gram/kernel.py::tree_gram_pallas),
                 and K = G^T G for one strided (n, p) matrix, the looped
                 tree Gram's per-leaf op (gram_pallas): two entries of
                 csrc/gram.cu over one device body
  weighted_sum/  d = sum_w c_w X[w, :]
                 (csrc/weighted_sum.cu; replaces repro/kernels/weighted_sum/
                 kernel.py::weighted_sum_pallas)
  coord_stats/   median / trimmed mean / MeaMed / Phocas over the workers,
                 unmasked or masked, optionally over named rows
                 (csrc/coord_stats.cu; coord_stats_pallas); Krum scores
                 (krum_scores_pallas) and Bulyan's selection rounds
                 (bulyan_select_pallas) (csrc/krum_select.cu)
  flash_attn/    online-softmax attention, causal and / or sliding window,
                 queries tail-aligned, GQA read in place (csrc/flash_attn.cu;
                 replaces repro/kernels/flash_attn/kernel.py::
                 flash_attn_pallas), on the prefill path

Each kernel ships ``ref.py`` (plain PyTorch version), ``kernel.py`` (the
``ctypes`` binding of ``csrc/<name>.cu``, with a launch counter) and
``ops.py`` (dispatch by the tensor's device: CUDA -> kernel, CPU -> plain).
``coord_stats`` binds two sources, ``csrc/coord_stats.cu`` and
``csrc/krum_select.cu``, and counts launches per kernel in a dict;
``gram`` binds the two entries of ``csrc/gram.cu`` with one counter each
(``launches``, ``gram_launches``).
``_build.py`` compiles the CUDA sources with ``nvcc`` at first use.
"""
