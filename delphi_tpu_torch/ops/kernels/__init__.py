"""The port's hand-written Hopper kernels and their plain PyTorch versions.

* :mod:`.pair_counts` — K1, replacing the JAX package's Pallas
  ``_pair_count_kernel``;
* :mod:`.entropy` — K2, replacing its Pallas ``_entropy_kernel``;
* :mod:`.domain_scores` — K5, replacing both modes of its jitted
  ``_jit_bucket_kernel`` (the bucketed domain route's gather-reduce and
  its weak-label epilogue);
* :mod:`.gbdt` — K3 (``gbdt_hist``, ``gbdt_split``, ``gbdt_route``: one
  level of the tree builder) and K4 (``gbdt_predict``), replacing the
  jitted ``_build_tree`` and ``_predict_tree`` / ``_predict_boosted`` of
  its ``models/gbdt.py``;
* :mod:`.linear` — K10 (``logreg_forward``, ``logreg_backward``: one step
  of the logistic head's gather route; ``adam_step``: Adam's update over
  a fit's flat parameters, on every route of the logistic and MLP heads),
  replacing the jitted fits of its ``models/linear.py``.

Each wrapper launches its CUDA kernel for a CUDA tensor and uses its plain
version for a CPU tensor; nothing falls back from one to the other.
:mod:`.build` compiles the CUDA sources at first use.
"""
