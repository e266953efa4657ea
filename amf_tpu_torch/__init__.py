"""amf_tpu_torch — the PyTorch + CUDA port of amf_tpu for one NVIDIA H100.

A second package beside the JAX one (``amf_tpu``), which stays the
reference: each module here mirrors the JAX module of the same name and is
held against it by the ``tests/test_torch_*.py`` parity tests. This package
imports ``torch`` and never ``jax``.

Every module of the JAX package is ported.
The Gibbs BPMF ``exp-variance`` one-step lookahead with its active loop
and the ``bayes_pmf`` command line; the PMF-refit lookahead
``models/pmf.fit_lookahead_batch`` in all of its paths (proposal loop,
lane-blocked, poly line search, fused) with the ``add_rmse_boosts``
command line; ActivePMF, the variational-normal lookahead (full
covariance and matrix normal) with its active loop, the ``active_pmf``
command line and the flagship ``entry()`` step; the NUTS BPMF family (the
Stan path): a lane-batched No-U-Turn Sampler, the BPMF posterior in its
three density variants, the sample-based lookahead criteria, the stan
loop and the ``bpmf`` command line; cold-start BPMF and its
``bpmf_newitems`` command line; RatingConcentration (the maxent dual on a
lane-batched projected L-BFGS) and its ``active_rc`` command line; MMMF
(ADMM for the nuclear-norm program, the max-norm and ordinal variants,
the margin selectors, SDPA interchange) with its loop and ``active_mmmf``
command line; the scan sweep, each active step's own logic on the
device, behind ``--scan`` in three command lines; candidate and chain
sharding over ranks of a ``torch.distributed`` group, one process a card,
behind ``--shard-candidates`` in five command lines; and the native host
kernels. Every active loop checkpoints and resumes. Every kernel
the JAX package wrote in Pallas has a hand-written CUDA kernel here, built
by nvcc at first use and loaded with ctypes (any factor width d, the
Gibbs row draws' Cholesky kernel up to d = 149 in float32 and 104 in
float64: d <= 32 from one library a source, a wider d from a library
built for it; the fused line search, the masked Gram and the Cholesky
kernel one library a width), and a
plain PyTorch version beside it that the CPU runs. The variational, NUTS,
maxent and MMMF paths run PyTorch's own linear algebra and autograd, as
the JAX package runs XLA's:

  types         dense masked Problem of tensors (with lane dimensions);
                per-lane hypothesised cells and their own problems
  data          synthetic generator, splits, extractors and the reference
                npz schema IO (numpy)
  analysis      RMSE and misclassification; AUC, Kendall tau, R-hat, ESS
  ops           linesearch: the adaptive accept/reject and poly line searches
                chol_kernel: Cholesky solve-and-sample, given S or fed from
                  the masked Gram products (csrc/chol_solve_sample.cu)
                gram_kernel: the Gibbs draws' masked Gram products, each
                  side of a problem in one of two forms it picks: the dense
                  mask product, or below a crossover density on the card
                  the sums over the rated-cell index (csrc/masked_gram.cu)
                pmf_kernels: the index of the rated cells and, on it, the
                  per-lane value and gradients (csrc/pmf_value_grad.cu), the
                  line-search quartic's reductions (csrc/pmf_line_coeffs.cu)
                  and the whole line search in one launch
                  (csrc/pmf_lookahead_fused.cu)
                cuda_build: nvcc into build/amf_tpu_torch/, ctypes loading,
                  each source's defines for a factor width
                probe_kernels: registers, spills and launch timings on a card
                quadrature: lookahead integration weights (sum, simps,
                  Gauss-Legendre, the trapezoid grid)
                moments: batched Gaussian moments of the approximations
                psd: batched PSD projection
                lbfgsb: a lane-batched projected L-BFGS
  mcmc          nuts: the No-U-Turn Sampler over a lane axis (chains and
                lookahead lanes in lockstep), its ESJD-grid warmup, and
                the noise sources its draws come from
  models        PMF MAP fit, sigma updates and the batched lookahead refit;
                Gibbs BPMF chains and the exp-variance lookahead; the
                variational approximations vnormal and mnormal; bpmf_hmc,
                the NUTS BPMF posterior, chains and lookahead, and
                sample_stats, the statistics of its draws; newitems, cold
                start; ratingconc, the maxent model; mmmf, max-margin
                matrix factorization, and sdpa_io, its SDP interchange
  active        the active-learning driver with checkpoint/resume and
                replay; the Gibbs loop; the ActivePMF criteria, lookahead
                and loop; the stan, maxent and MMMF loops; scan_loop, the
                sweeps with their step logic on the device
  run           the bayes_pmf, add_rmse_boosts, active_pmf, bpmf,
                bpmf_newitems, active_rc and active_mmmf command lines
  parallel      mesh: one process a card joined by a process group
                (spawned, or under torchrun); sharding: the candidate
                shards, the gather, the pick and the chain split; dryrun:
                every sharded path once on tiny shapes
  _native       host C++ over numpy (the reference's MEX sparse sums),
                built by g++ at first use
  entry         the flagship step (one pred-variance scoring pass) and the
                sharded dry run
  convert       state conversion to and from the JAX package's field layout
  utils         device and precision policy, seeded generator streams,
                factorisations that give NaN where they fail, the loops'
                checkpointer

The entry points run on the card unless the caller names the CPU.
"""

__version__ = "0.1.0"
