"""amf_tpu_torch — the PyTorch + CUDA port of amf_tpu for one NVIDIA H100.

A second package beside the JAX one (``amf_tpu``), which stays the
reference: each module here mirrors the JAX module of the same name and is
held against it by the ``tests/test_torch_*.py`` parity tests. This package
imports ``torch`` and never ``jax``.

Two slices are ported. The Gibbs BPMF ``exp-variance`` one-step lookahead
with its active loop and the ``bayes_pmf`` command line; and the PMF-refit
lookahead ``models/pmf.fit_lookahead_batch`` in all of its paths (proposal
loop, lane-blocked, poly line search, fused) with the ``add_rmse_boosts``
command line. Every kernel the JAX package wrote in Pallas has a
hand-written CUDA kernel here, built by nvcc at first use and loaded with
ctypes (factor widths d <= 32), and a plain PyTorch version beside it
that the CPU runs:

  types         dense masked Problem of tensors; per-lane hypothesised cells
  data          synthetic generator and the reference npz schema IO (numpy)
  analysis      RMSE and misclassification metrics
  ops           linesearch: the adaptive accept/reject and poly line searches
                chol_kernel: Cholesky solve-and-sample, given S or fed from
                  the masked Gram products (csrc/chol_solve_sample.cu)
                pmf_kernels: the index of the rated cells and, on it, the
                  per-lane value and gradients (csrc/pmf_value_grad.cu), the
                  line-search quartic's reductions (csrc/pmf_line_coeffs.cu)
                  and the whole line search in one launch
                  (csrc/pmf_lookahead_fused.cu)
                cuda_build: nvcc into build/amf_tpu_torch/, ctypes loading
                probe_kernels: registers, spills and launch timings on a card
                quadrature: the trapezoid grid for continuous lookahead
  models        PMF MAP fit and the batched lookahead refit; Gibbs BPMF chains
                and the exp-variance lookahead
  active        the active-learning driver and the Gibbs loop
  run           the bayes_pmf and add_rmse_boosts command lines
  convert       state conversion to and from the JAX package's field layout
  utils         device and precision policy, seeded generator streams

The entry points run on the card unless the caller names the CPU.
"""

__version__ = "0.1.0"
