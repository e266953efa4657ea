"""amf_tpu_torch — the PyTorch + CUDA port of amf_tpu for one NVIDIA H100.

A second package beside the JAX one (``amf_tpu``), which stays the
reference: each module here mirrors the JAX module of the same name and is
held against it by the ``tests/test_torch_*.py`` parity tests. This package
imports ``torch`` and never ``jax``.

The ported slice is the Gibbs BPMF ``exp-variance`` one-step lookahead and
its active loop:

  types         dense masked Problem of tensors; per-lane hypothesised cells
  data          synthetic generator and the reference npz schema IO (numpy)
  analysis      RMSE and misclassification metrics
  ops           adaptive line searches; the Cholesky solve-and-sample CUDA
                kernel (csrc/chol_solve_sample.cu) and its plain version;
                the trapezoid grid for continuous lookahead
  models        PMF MAP fit; Gibbs BPMF chains and the exp-variance lookahead
  active        the active-learning driver and the Gibbs loop
  run           the bayes_pmf command line
  convert       state conversion to and from the JAX package's field layout
  utils         device policy and seeded generator streams
"""

__version__ = "0.1.0"
