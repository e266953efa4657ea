"""Experiment harness: named configurations reproducing the reference's
results/*/Makefile workloads (SURVEY.md §6), driven as one CLI, on PyTorch
(mirrors ``amf_tpu/run/experiment.py``: the same catalog, every command
naming the port's ``amf_tpu_torch.run.*`` CLI).

The reference runs experiments through per-directory Makefiles
(Makefile-template:1-113) with data-prep + per-model-result targets, git-rev
provenance stamping (get_git_rev.sh), and skip-if-exists semantics. This CLI
reproduces that: `--list` shows the catalog (one entry per reference
experiment directory, each naming its source Makefile); running an experiment
prepares data (cached), runs the requested model CLIs, and stamps provenance
notes. Flags below are transcribed from the cited Makefiles. ``--device``
(cuda by default, raising without a card; cpu only when named) is passed on
to every data and model command.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from typing import Dict, List, NamedTuple, Optional

from amf_tpu_torch.utils.platform import resolve_device


class Experiment(NamedTuple):
    name: str
    source: str  # reference Makefile this reproduces
    data_cmd: List[str]  # argv for the data-prep CLI (module, *args)
    runs: Dict[str, List[str]]  # result-kind -> argv for the model CLI


def _dataset(name: str) -> str:
    """Resolve a reference dataset path or fail with a clear message.

    Catalog entries are listed unconditionally; missing source data only
    errors when the experiment is actually run. The reference checkout is
    named by the ``AMF_REFERENCE_ROOT`` environment variable.
    """
    root = os.environ.get("AMF_REFERENCE_ROOT")
    if not root:
        raise FileNotFoundError(
            f"reference dataset {name!r} needs a reference checkout "
            "(set AMF_REFERENCE_ROOT)")
    paths = {
        "movielens-100k": "movielens-100k/ratings_matrix.npy.gz",
        "movielens-75k": "movielens-100k/half_ratings.npy.gz",
        "movielens-58k": "movielens-100k/half_ratings_70.npy.gz",
        "drugbank-94x425": "drugbank/subset_94x425.npy",
        "drugbank-70x306": "drugbank/subset_70x306.npy",
        "criteria-10x10-data": "results/criteria/10x10_r1_u10_v10_1/data.pkl",
    }
    path = os.path.join(root, paths[name])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"reference dataset {name!r} not found at {path} "
            "(set AMF_REFERENCE_ROOT to a reference checkout)"
        )
    return path


def catalog() -> Dict[str, Experiment]:
    """The reference workload table (BASELINE.md): every results/*/Makefile."""
    exps: Dict[str, Experiment] = {}

    # ---- 10x10 rank-2 discrete (results/10x10_discrete2_d2/Makefile:46-51):
    # generate.py --rows 10 --cols 10 --rank 2 --known-pos 10 --unknown-pos 90
    # --cutoff 0 (cutoff 0 makes the 10/90 positive counts trivially
    # satisfiable), LATENT_D=2, --no-subtract-mean everywhere.
    exps["10x10_discrete2_d2"] = Experiment(
        name="10x10_discrete2_d2",
        source="results/10x10_discrete2_d2/Makefile",
        data_cmd=[
            "amf_tpu_torch.run.generate", "--rows", "10", "--cols", "10",
            "--rank", "2", "--known-pos", "10", "--unknown-pos", "90",
            "--cutoff", "0", "{data}",
        ],
        runs={
            # Makefile:137-147 lists `pred-variance exp-variance random`;
            # exp-variance is not an ActivePMF key (active_pmf.py:901-923
            # would reject it) — run the valid keys.
            "apmf": [
                "amf_tpu_torch.run.active_pmf", "--load-data", "{data}",
                "--latent-d", "2", "--discrete-integration",
                "--refit-lookahead",
                "--checkpoint", "{out}/ckpt_apmf.pkl",
                "--save-results", "{out}/results_apmf.pkl", "--no-verbose",
                "pred-variance", "random",
            ],
            # Makefile:55-64: all keys (none listed), s200/w200,
            # lookahead s100/w50
            "stan": [
                "amf_tpu_torch.run.bpmf", "--load-data", "{data}",
                "--latent-d", "2", "--no-subtract-mean", "--float32",
                "--samps", "200", "--warmup", "200",
                "--lookahead-samps", "100", "--lookahead-warmup", "50",
                "--checkpoint", "{out}/ckpt_stan.pkl",
                "--save-results", "{out}/results_stan.pkl", "--no-verbose",
            ],
            # Makefile:127-136: all keys, s200, lookahead s100
            "bayes": [
                "amf_tpu_torch.run.bayes_pmf", "--load-data", "{data}",
                "--latent-d", "2", "--no-subtract-mean", "--samps", "200",
                "--lookahead-samps", "100",
                "--checkpoint", "{out}/ckpt_bayes.pkl",
                "--save-results", "{out}/results_bayes.pkl", "--no-verbose",
            ],
            # Makefile:149-156: -C 1 --cutoff 3.5, all selectors
            "mmmf": [
                "amf_tpu_torch.run.active_mmmf", "--load-data", "{data}",
                "--cutoff", "3.5", "-C", "1",
                "--checkpoint", "{out}/ckpt_mmmf.pkl",
                "--save-results", "{out}/results_mmmf.pkl", "--no-verbose",
            ],
            # Makefile:158-166: --delta 1.5 --pred-mean, entropy random;
            # the registry's remaining ge-1/ge-4 selectors
            # (active_rc.py:22-27) are run too so every RC key has a
            # recorded sweep on this workload
            "rc": [
                "amf_tpu_torch.run.active_rc", "--load-data", "{data}",
                "--delta", "1.5", "--pred-mode",
                "--checkpoint", "{out}/ckpt_rc.pkl",
                "--save-results", "{out}/results_rc.pkl", "--no-verbose",
                "entropy", "random", "ge-1", "ge-4",
            ],
        },
    )

    # ---- 10x10 rank-4 d=4 (results/10x10_discrete4_d4/Makefile:31,38-43)
    exps["10x10_discrete4_d4"] = Experiment(
        name="10x10_discrete4_d4",
        source="results/10x10_discrete4_d4/Makefile",
        data_cmd=[
            "amf_tpu_torch.run.generate", "--rows", "10", "--cols", "10",
            "--rank", "4", "--known-pos", "10", "--unknown-pos", "90",
            "--cutoff", "0", "{data}",
        ],
        runs={
            # Makefile:45-56: stan all keys, --test-set all, s200/w100
            "stan": [
                "amf_tpu_torch.run.bpmf", "--load-data", "{data}",
                "--latent-d", "4", "--no-subtract-mean", "--float32",
                "--test-set", "all",
                "--samps", "200", "--warmup", "100",
                "--lookahead-samps", "100", "--lookahead-warmup", "50",
                "--checkpoint", "{out}/ckpt_stan.pkl",
                "--save-results", "{out}/results_stan.pkl", "--no-verbose",
            ],
            # Makefile:58-66: mn_active_pmf --discrete --refit-lookahead,
            # all keys
            "mnpmf": [
                "amf_tpu_torch.run.active_pmf", "--model", "mn",
                "--load-data", "{data}",
                "--latent-d", "4", "--discrete-integration",
                "--refit-lookahead",
                "--checkpoint", "{out}/ckpt_mnpmf.pkl",
                "--save-results", "{out}/results_mnpmf.pkl", "--no-verbose",
            ],
            # Makefile:68-76: active_pmf --discrete --refit-lookahead,
            # in float32 as the JAX package's catalog runs it
            "apmf": [
                "amf_tpu_torch.run.active_pmf", "--load-data", "{data}",
                "--latent-d", "4", "--discrete-integration",
                "--refit-lookahead", "--float32",
                "--checkpoint", "{out}/ckpt_apmf.pkl",
                "--save-results", "{out}/results_apmf.pkl", "--no-verbose",
            ],
        },
    )

    # ---- MovieLens family: 100k / 75k / 58k-15d from-5% test-5%
    # (results/movielens-{100k,75k,58k}-from5%.../Makefile). Same recipe,
    # different source matrix + latent d; stan keys random pred-variance
    # pred prob-ge-3.5 at s200/w100, 200 steps, --subtract-mean.
    for name, src_mk, dataset, d in (
        ("movielens-100k-from5pct-test5pct",
         "results/movielens-100k-from5%-test5%/Makefile",
         "movielens-100k", 20),
        ("movielens-75k-from5pct-test5pct",
         "results/movielens-75k-from5%-test5%/Makefile",
         "movielens-75k", 20),
        ("movielens-58k-from5pct-test5pct-15d",
         "results/movielens-58k-from5%-test5%-15d/Makefile",
         "movielens-58k", 15),
    ):
        runs = {
            "stan": [
                "amf_tpu_torch.run.bpmf", "--load-data", "{data}",
                "--latent-d", str(d), "--subtract-mean",
                "--samps", "200", "--warmup", "100",
                "--steps", "200", "--float32",
                "--checkpoint", "{out}/ckpt_stan.pkl",
                "--save-results", "{out}/results_stan.pkl", "--no-verbose",
                "random", "pred-variance", "pred", "prob-ge-3.5",
            ],
            "bayes": [
                "amf_tpu_torch.run.bayes_pmf", "--load-data", "{data}",
                "--latent-d", str(d), "--subtract-mean",
                "--samps", "128", "--steps", "200", "--float32",
                "--checkpoint", "{out}/ckpt_bayes.pkl",
                "--save-results", "{out}/results_bayes.pkl", "--no-verbose",
                "random", "pred-variance",
            ],
            "mmmf": [
                # float32, as the JAX package's catalog runs it at 472x413
                "amf_tpu_torch.run.active_mmmf", "--load-data", "{data}",
                "-C", "1", "--cutoff", "3.5", "--steps", "200", "--float32",
                "--checkpoint", "{out}/ckpt_mmmf.pkl",
                "--save-results", "{out}/results_mmmf.pkl", "--no-verbose",
            ],
        }
        if name.startswith("movielens-58k-from"):
            # Makefile:62-73: mn_active_pmf 200 steps, refit-lookahead
            runs["mnpmf"] = [
                "amf_tpu_torch.run.active_pmf", "--model", "mn",
                "--load-data", "{data}",
                "--latent-d", str(d), "--discrete-integration",
                "--refit-lookahead", "--steps", "200", "--float32",
                "--checkpoint", "{out}/ckpt_mnpmf.pkl",
                "--save-results", "{out}/results_mnpmf.pkl", "--no-verbose",
                "random", "pred-variance", "pred", "prob-ge-3.5",
            ]
        exps[name] = Experiment(
            name=name,
            source=src_mk,
            data_cmd=[
                "amf_tpu_torch.run.choose_training", ("dataset", dataset), "{data}",
                "--pick-known-frac", "0.05",
                "--test-at-random", "--test-known-frac", "0.05",
            ],
            runs=runs,
        )

    # ---- MovieLens-58k new-movies cold start
    # (results/movielens-58k-newmovies-10%-10d/Makefile:40-78): 10% new
    # items, d=10, two-phase initfit (s200/w200) cached to .npz, then the
    # newitems active loop (s200/w100, 200 steps) over new-item columns.
    exps["movielens-58k-newmovies-10pct-10d"] = Experiment(
        name="movielens-58k-newmovies-10pct-10d",
        source="results/movielens-58k-newmovies-10%-10d/Makefile",
        data_cmd=[
            "amf_tpu_torch.run.choose_training", ("dataset", "movielens-58k"),
            "{data}",
            "--new-item-frac", "0.1", "--pick-no-extras",
            "--test-at-random", "--test-known-frac", "0.05",
        ],
        runs={
            "stan_newitems": [
                "amf_tpu_torch.run.bpmf_newitems", "--load-data", "{data}",
                "--latent-d", "10",
                "--initial-fit-file", "{out}/initfit_s200w200.npz",
                "--initial-fit-samps", "200",
                "--samps", "200", "--warmup", "100",
                "--steps", "200", "--float32",
                "--save-results", "{out}/results_stan_newitems.pkl",
                "--no-verbose",
                "random", "pred-variance", "pred", "prob-ge-3.5",
            ],
            # Makefile:80-95 (results_stan_nolookahead_s200w100_200steps):
            # the PLAIN one-phase stan loop on the same cold-start data,
            # restricted to new-item columns (--query-new-only)
            "stan": [
                "amf_tpu_torch.run.bpmf", "--load-data", "{data}",
                "--latent-d", "10", "--subtract-mean",
                "--query-new-only",
                "--samps", "200", "--warmup", "100",
                "--steps", "200", "--float32",
                "--checkpoint", "{out}/ckpt_stan.pkl",
                "--save-results", "{out}/results_stan.pkl", "--no-verbose",
                "random", "pred-variance", "pred", "prob-ge-3.5",
            ],
            # Makefile:97-105 (results_mmmf_200steps, -C 1 --cutoff 3.5,
            # all selectors); float32 like the other large mmmf arms
            "mmmf": [
                "amf_tpu_torch.run.active_mmmf", "--load-data", "{data}",
                "-C", "1", "--cutoff", "3.5", "--steps", "200", "--float32",
                "--checkpoint", "{out}/ckpt_mmmf.pkl",
                "--save-results", "{out}/results_mmmf.pkl", "--no-verbose",
            ],
        },
    )

    # ---- MovieLens-58k new-movies cold start, d=20 variant
    # (results/movielens-58k-newmovies-10%/Makefile): identical data recipe
    # to the -10d dir, LATENT_D=20; runs the newitems two-phase loop
    # (initfit s200/w200 -> s200/w100, 200 steps) and the mmmf arm
    # (Makefile:81-88, -C 1 --cutoff 3.5, all selectors, full sweep).
    exps["movielens-58k-newmovies-10pct-20d"] = Experiment(
        name="movielens-58k-newmovies-10pct-20d",
        source="results/movielens-58k-newmovies-10%/Makefile",
        data_cmd=[
            "amf_tpu_torch.run.choose_training", ("dataset", "movielens-58k"),
            "{data}",
            "--new-item-frac", "0.1", "--pick-no-extras",
            "--test-at-random", "--test-known-frac", "0.05",
        ],
        runs={
            "stan_newitems": [
                "amf_tpu_torch.run.bpmf_newitems", "--load-data", "{data}",
                "--latent-d", "20",
                "--initial-fit-file", "{out}/initfit_s200w200.npz",
                "--initial-fit-samps", "200",
                "--samps", "200", "--warmup", "100",
                "--steps", "200", "--float32",
                "--save-results", "{out}/results_stan_newitems.pkl",
                "--no-verbose",
                "random", "pred-variance", "pred", "prob-ge-3.5",
            ],
            "mmmf": [
                "amf_tpu_torch.run.active_mmmf", "--load-data", "{data}",
                "-C", "1", "--cutoff", "3.5", "--steps", "200", "--float32",
                "--checkpoint", "{out}/ckpt_mmmf.pkl",
                "--save-results", "{out}/results_mmmf.pkl", "--no-verbose",
            ],
        },
    )

    # ---- DrugBank 94x425 equal-class
    # (results/drugbank-94x425/Makefile:32,41-66): 500 drugbank-picked seeds,
    # 2000 equal-class test cells, binary accuracy, d=20, 150 steps, C=1
    exps["drugbank-94x425"] = Experiment(
        name="drugbank-94x425",
        source="results/drugbank-94x425/Makefile",
        data_cmd=[
            "amf_tpu_torch.run.choose_training", ("dataset", "drugbank-94x425"),
            "{data}",
            "--drugbank", "--n-pick", "500",
            "--test-equal-classes", "--n-test", "2000",
        ],
        runs={
            "mmmf": [
                "amf_tpu_torch.run.active_mmmf", "--load-data", "{data}",
                "-C", "1", "--steps", "150",
                "--checkpoint", "{out}/ckpt_mmmf.pkl",
                "--save-results", "{out}/results_mmmf.pkl", "--no-verbose",
                "random", "min-margin", "min-margin-pos",
            ],
            "stan": [
                "amf_tpu_torch.run.bpmf", "--load-data", "{data}",
                "--latent-d", "20", "--subtract-mean",
                "--samps", "200", "--warmup", "100",
                "--steps", "150", "--float32",
                "--checkpoint", "{out}/ckpt_stan.pkl",
                "--save-results", "{out}/results_stan.pkl", "--no-verbose",
                "random", "pred-variance", "pred", "prob-ge-0",
            ],
            # Makefile:66-76 (results_mnpmf_nolookahead_150steps): the MN
            # model's at-scale purpose (mn_active_pmf.py:119); direct keys
            # only — the Makefile lists prob-ge-3.5 even on this binary
            # dataset, mirrored as written. float32.
            "mnpmf": [
                "amf_tpu_torch.run.active_pmf", "--model", "mn",
                "--load-data", "{data}",
                "--latent-d", "20", "--discrete-integration",
                "--refit-lookahead", "--steps", "150", "--float32",
                "--checkpoint", "{out}/ckpt_mnpmf.pkl",
                "--save-results", "{out}/results_mnpmf.pkl", "--no-verbose",
                "random", "pred-variance", "pred", "prob-ge-3.5",
            ],
        },
    )

    # ---- DrugBank 70x306 Gibbs (no reference Makefile: this is the
    # north-star configuration "DrugBank 70x306 interaction subset,
    # Bayesian PMF Gibbs + active entry selection", BASELINE.json configs[1];
    # parameters scaled from the 94x425 recipe: the drugbank picker's
    # forced cover is ~one positive per drug + one negative per empty
    # target (~310 cells here), so 400 seed picks; 1000 equal-class test
    # cells). bayes_lookahead runs the exp-variance MCMC-per-candidate
    # lookahead for a budgeted step count.
    exps["drugbank-70x306-gibbs"] = Experiment(
        name="drugbank-70x306-gibbs",
        source="BASELINE.json configs[1] (no reference Makefile)",
        data_cmd=[
            "amf_tpu_torch.run.choose_training", ("dataset", "drugbank-70x306"),
            "{data}",
            "--drugbank", "--n-pick", "400",
            "--test-equal-classes", "--n-test", "1000",
        ],
        runs={
            "bayes": [
                "amf_tpu_torch.run.bayes_pmf", "--load-data", "{data}",
                "--latent-d", "20", "--subtract-mean",
                "--samps", "128", "--steps", "150", "--float32",
                "--checkpoint", "{out}/ckpt_bayes.pkl",
                "--save-results", "{out}/results_bayes.pkl", "--no-verbose",
                "random", "pred-variance", "prob-ge-0",
            ],
            # full-length exp-variance MCMC lookahead at reference scale:
            # ~20k candidates x 2 values, each lane a MAP refit + 30-sample
            # Gibbs chain, per step, in tiles of 256 candidates dispatched
            # from the host, every row draw through the Cholesky kernel
            # (ops/chol_kernel.py)
            "bayes_lookahead": [
                "amf_tpu_torch.run.bayes_pmf", "--load-data", "{data}",
                "--latent-d", "20", "--subtract-mean",
                "--samps", "128", "--steps", "150", "--float32",
                "--lookahead-samps", "30", "--lookahead-tile", "256",
                "--lookahead-host-tiles",
                "--checkpoint", "{out}/ckpt_bayes_la.pkl",
                "--save-results", "{out}/results_bayes_la.pkl",
                "--no-verbose", "exp-variance",
            ],
        },
    )

    # ---- DrugBank 94x425 with 2:1 negative:positive test classes
    # (results/drugbank-94x425-5to1/Makefile:41-86): class-ratio test set
    # {-1: .6666, 1: .3333}, n-test 1500; stan + mmmf at 200 steps.
    exps["drugbank-94x425-5to1"] = Experiment(
        name="drugbank-94x425-5to1",
        source="results/drugbank-94x425-5to1/Makefile",
        data_cmd=[
            "amf_tpu_torch.run.choose_training", ("dataset", "drugbank-94x425"),
            "{data}",
            "--drugbank", "--n-pick", "500",
            "--test-class-ratios", "{-1: .6666, 1: .3333}",
            "--n-test", "1500",
        ],
        runs={
            "stan": [
                "amf_tpu_torch.run.bpmf", "--load-data", "{data}",
                "--latent-d", "20", "--subtract-mean",
                "--samps", "200", "--warmup", "100",
                "--steps", "200", "--float32",
                "--checkpoint", "{out}/ckpt_stan.pkl",
                "--save-results", "{out}/results_stan.pkl", "--no-verbose",
                "random", "pred-variance", "pred", "prob-ge-0",
            ],
            "mmmf": [
                "amf_tpu_torch.run.active_mmmf", "--load-data", "{data}",
                "-C", "1", "--steps", "200",
                "--checkpoint", "{out}/ckpt_mmmf.pkl",
                "--save-results", "{out}/results_mmmf.pkl", "--no-verbose",
            ],
            # Makefile:66-76 (results_mnpmf_nolookahead_200steps); same
            # prob-ge-3.5-on-binary quirk as the 94x425 dir, mirrored
            "mnpmf": [
                "amf_tpu_torch.run.active_pmf", "--model", "mn",
                "--load-data", "{data}",
                "--latent-d", "20", "--discrete-integration",
                "--refit-lookahead", "--steps", "200", "--float32",
                "--checkpoint", "{out}/ckpt_mnpmf.pkl",
                "--save-results", "{out}/results_mnpmf.pkl", "--no-verbose",
                "random", "pred-variance", "pred", "prob-ge-3.5",
            ],
        },
    )

    # ---- criteria-agreement micro-workload
    # (results/criteria/10x10_r1_u10_v10_1/Makefile:36-96). The reference
    # directory commits its exact data.pkl (the gen.py target is stale);
    # copy that artifact so criterion maps are computed on the same data.
    exps["criteria_10x10_r1"] = Experiment(
        name="criteria_10x10_r1",
        source="results/criteria/10x10_r1_u10_v10_1/Makefile",
        data_cmd=["COPY", ("dataset", "criteria-10x10-data"), "{data}"],
        runs={
            # Makefile:67-80: continuous integration, refit-lookahead, 2 steps
            "apmf": [
                "amf_tpu_torch.run.active_pmf", "--load-data", "{data}",
                "--latent-d", "1", "--continuous-integration",
                "--refit-lookahead", "--steps", "2",
                "--save-results", "{out}/results_apmf.pkl", "--no-verbose",
                "pred-variance", "total-variance", "total-variance-approx",
                "uv-entropy", "uv-entropy-approx",
                "pred-entropy-bound", "pred-entropy-bound-approx",
            ],
            "mnpmf": [
                "amf_tpu_torch.run.active_pmf", "--model", "mn",
                "--load-data", "{data}",
                "--latent-d", "1", "--continuous-integration",
                "--refit-lookahead", "--steps", "2",
                "--save-results", "{out}/results_mnpmf.pkl", "--no-verbose",
                "pred-variance", "total-variance", "total-variance-approx",
                "uv-entropy", "uv-entropy-approx",
            ],
            # Makefile:37-53: continuous, s200/w100, lookahead s100/w50,
            # 2 steps, model-init at the PMF MAP
            "stan": [
                "amf_tpu_torch.run.bpmf", "--load-data", "{data}",
                "--latent-d", "1", "--no-subtract-mean", "--test-set", "all",
                "--samps", "200", "--warmup", "100",
                "--lookahead-samps", "100", "--lookahead-warmup", "50",
                "--model-init", "--steps", "2",
                "--save-results", "{out}/results_stan.pkl", "--no-verbose",
                "pred-variance", "exp-variance", "exp-entropy-est",
            ],
            # The Makefile also lists an rc target (:82-92), but the data's
            # continuous values trip the reference's own hard error
            # (evaluate_active.m:20-25 requires vals == 1:5 or 1:2), so the
            # reference cannot run it either; omitted.
        },
    )

    # ---- discrete criteria-agreement micro-workload, ALL FIVE families
    # (results/criteria/10x10_r1_u10_v10_1step_discrete/Makefile:36-96):
    # 2-step runs of stan/mnpmf/apmf/mmmf/rc on one discrete 10x10 dataset —
    # the reference's cross-family first-step comparison experiment (the
    # data compare_firsts.py's beanplot grids consume). The reference dir
    # commits no data.pkl (its gen.py target was never run into the tree);
    # the data recipe is the discrete2_d2 generator. Cheap enough to run
    # with --seeds N for replicate violin grids.
    exps["criteria_10x10_1step_discrete"] = Experiment(
        name="criteria_10x10_1step_discrete",
        source="results/criteria/10x10_r1_u10_v10_1step_discrete/Makefile",
        data_cmd=[
            "amf_tpu_torch.run.generate", "--rows", "10", "--cols", "10",
            "--rank", "2", "--known-pos", "10", "--unknown-pos", "90",
            "--cutoff", "0", "{data}",
        ],
        runs={
            # Makefile:37-49: stan --discrete, s200/w100, la s100/w50,
            # test-set all, 2 steps, all keys
            "stan": [
                "amf_tpu_torch.run.bpmf", "--load-data", "{data}",
                "--latent-d", "2", "--no-subtract-mean", "--float32",
                "--test-set", "all",
                "--samps", "200", "--warmup", "100",
                "--lookahead-samps", "100", "--lookahead-warmup", "50",
                "--steps", "2",
                "--save-results", "{out}/results_stan.pkl", "--no-verbose",
            ],
            # Makefile:51-60 / :62-71: mnpmf / apmf --discrete
            # refit-lookahead, 2 steps, all keys, in float32 as the JAX
            # package's catalog runs them (f32 noise << the seed noise the
            # replicate violin grids measure)
            "mnpmf": [
                "amf_tpu_torch.run.active_pmf", "--model", "mn",
                "--load-data", "{data}",
                "--latent-d", "2", "--discrete-integration",
                "--refit-lookahead", "--steps", "2", "--float32",
                "--save-results", "{out}/results_mnpmf.pkl", "--no-verbose",
            ],
            "apmf": [
                "amf_tpu_torch.run.active_pmf", "--load-data", "{data}",
                "--latent-d", "2", "--discrete-integration",
                "--refit-lookahead", "--steps", "2", "--float32",
                "--save-results", "{out}/results_apmf.pkl", "--no-verbose",
            ],
            # Makefile:73-82: mmmf -C 1 --cutoff 3.5, 2 steps, all selectors
            "mmmf": [
                "amf_tpu_torch.run.active_mmmf", "--load-data", "{data}",
                "--cutoff", "3.5", "-C", "1", "--steps", "2",
                "--save-results", "{out}/results_mmmf.pkl", "--no-verbose",
            ],
            # Makefile:84-94: rc --delta 1.5 --pred-mean, 2 steps,
            # entropy random
            "rc": [
                "amf_tpu_torch.run.active_rc", "--load-data", "{data}",
                "--delta", "1.5", "--pred-mode", "--steps", "2",
                "--save-results", "{out}/results_rc.pkl", "--no-verbose",
                "entropy", "random",
            ],
        },
    )

    # ---- sampler-robustness variants of the d2 workload
    # (results/10x10_discrete2_d2/Makefile:56-115): the reference's own
    # cross-density / sampler-budget consistency experiment — the
    # straightforward Stan density at the standard budget, and the default
    # density at 2x / 50x sample budgets (no lookahead keys). These are the
    # strongest available check of the native NUTS replacement: criterion
    # maps should agree across densities and stabilize with budget
    # (compare_firsts methodology, SURVEY.md §4.3).
    d2 = exps["10x10_discrete2_d2"]
    d2_runs = dict(d2.runs)
    d2_runs["stan_straightforward"] = [
        "amf_tpu_torch.run.bpmf", "--load-data", "{data}",
        "--latent-d", "2", "--no-subtract-mean", "--float32",
        "--model-filename", "bpmf_straightforward.stan",
        "--samps", "200", "--warmup", "200",
        "--lookahead-samps", "100", "--lookahead-warmup", "50",
        "--checkpoint", "{out}/ckpt_stan_straightforward.pkl",
        "--save-results", "{out}/results_stan_straightforward.pkl",
        "--no-verbose",
    ]
    # Makefile:56-66 (s400) and :68-78 (s10000): warmup 200, direct keys
    # only ("nolookahead")
    for budget in ("400", "10000"):
        d2_runs[f"stan_s{budget}"] = [
            "amf_tpu_torch.run.bpmf", "--load-data", "{data}",
            "--latent-d", "2", "--no-subtract-mean", "--float32",
            "--samps", budget, "--warmup", "200",
            "--checkpoint", "{out}/ckpt_stan_s" + budget + ".pkl",
            "--save-results", "{out}/results_stan_s" + budget + ".pkl",
            "--no-verbose",
            "random", "pred-variance", "pred", "prob-ge-3.5",
        ]
    # Makefile:90-100: an independent replicate of the s10000 arm ("_b") —
    # the reference's own sampler-repeatability probe at the largest
    # budget; fresh chains via a different seed
    d2_runs["stan_s10000_b"] = [
        "amf_tpu_torch.run.bpmf", "--load-data", "{data}",
        "--latent-d", "2", "--no-subtract-mean", "--float32",
        "--samps", "10000", "--warmup", "200", "--seed", "1",
        "--checkpoint", "{out}/ckpt_stan_s10000_b.pkl",
        "--save-results", "{out}/results_stan_s10000_b.pkl",
        "--no-verbose",
        "random", "pred-variance", "pred", "prob-ge-3.5",
    ]
    # Makefile:114-125: straightforward density at the 2x budget, direct
    # keys only — crosses density x budget in the consistency grid
    d2_runs["stan_straightforward_s400"] = [
        "amf_tpu_torch.run.bpmf", "--load-data", "{data}",
        "--latent-d", "2", "--no-subtract-mean", "--float32",
        "--model-filename", "bpmf_straightforward.stan",
        "--samps", "400", "--warmup", "200",
        "--checkpoint", "{out}/ckpt_stan_straightforward_s400.pkl",
        "--save-results", "{out}/results_stan_straightforward_s400.pkl",
        "--no-verbose",
        "random", "pred-variance", "pred", "prob-ge-3.5",
    ]
    exps["10x10_discrete2_d2"] = d2._replace(runs=d2_runs)

    # ---- remaining d4 families (results/10x10_discrete4_d4/Makefile:78-96):
    # mmmf (-C 1 --cutoff 3.5, all selectors) and rc (--delta 1.5
    # --pred-mean, entropy random)
    d4 = exps["10x10_discrete4_d4"]
    d4_runs = dict(d4.runs)
    d4_runs["mmmf"] = [
        "amf_tpu_torch.run.active_mmmf", "--load-data", "{data}",
        "--cutoff", "3.5", "-C", "1",
        "--checkpoint", "{out}/ckpt_mmmf.pkl",
        "--save-results", "{out}/results_mmmf.pkl", "--no-verbose",
    ]
    d4_runs["rc"] = [
        "amf_tpu_torch.run.active_rc", "--load-data", "{data}",
        "--delta", "1.5", "--pred-mode",
        "--checkpoint", "{out}/ckpt_rc.pkl",
        "--save-results", "{out}/results_rc.pkl", "--no-verbose",
        "entropy", "random",
    ]
    exps["10x10_discrete4_d4"] = d4._replace(runs=d4_runs)

    # ---- DrugBank matrix-normal arms — the MN model's at-scale reason to
    # exist (mn_active_pmf.py:119 docstring: covariance too big for the
    # full-normal model at 94x425). results/drugbank-94x425/Makefile:66-76
    # (150 steps) and results/drugbank-94x425-5to1/Makefile:66-76 (200):
    # no subtract-mean ("hardcoded :)"), discrete integration,
    # refit-lookahead, keys random pred-variance pred prob-ge-3.5 (the
    # Makefiles say prob-ge-3.5 even on ±1 data — mirrored as written).
    for db_name, db_steps in (("drugbank-94x425", "150"),
                              ("drugbank-94x425-5to1", "200")):
        dbe = exps[db_name]
        db_runs = dict(dbe.runs)
        db_runs["mnpmf"] = [
            "amf_tpu_torch.run.active_pmf", "--model", "mn",
            "--load-data", "{data}",
            "--latent-d", "20", "--discrete-integration",
            "--refit-lookahead", "--steps", db_steps, "--float32",
            "--checkpoint", "{out}/ckpt_mnpmf.pkl",
            "--save-results", "{out}/results_mnpmf.pkl", "--no-verbose",
            "random", "pred-variance", "pred", "prob-ge-3.5",
        ]
        exps[db_name] = dbe._replace(runs=db_runs)

    # ---- newmovies-10d: the plain (non-cold-start) stan arm restricted to
    # new-item columns and the mmmf arm its Makefile also builds
    # (results/movielens-58k-newmovies-10%-10d/Makefile:81-110)
    nm = exps["movielens-58k-newmovies-10pct-10d"]
    nm_runs = dict(nm.runs)
    nm_runs["stan"] = [
        "amf_tpu_torch.run.bpmf", "--load-data", "{data}",
        "--latent-d", "10", "--subtract-mean", "--query-new-only",
        "--samps", "200", "--warmup", "100",
        "--steps", "200", "--float32",
        "--checkpoint", "{out}/ckpt_stan.pkl",
        "--save-results", "{out}/results_stan.pkl", "--no-verbose",
        "random", "pred-variance", "pred", "prob-ge-3.5",
    ]
    nm_runs["mmmf"] = [
        "amf_tpu_torch.run.active_mmmf", "--load-data", "{data}",
        "-C", "1", "--cutoff", "3.5", "--steps", "200", "--float32",
        "--checkpoint", "{out}/ckpt_mmmf.pkl",
        "--save-results", "{out}/results_mmmf.pkl", "--no-verbose",
    ]
    exps["movielens-58k-newmovies-10pct-10d"] = nm._replace(runs=nm_runs)
    return exps


def _git_rev() -> str:
    """Provenance stamp (reference: get_git_rev.sh:7-31)."""
    try:
        rev = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
        ).stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain"], capture_output=True, text=True,
        ).stdout.strip()
        return rev + ("-dirty" if dirty else "")
    except Exception:
        return "unknown"


def _fill(tokens, data: str, out: str) -> List[str]:
    """Resolve {data}/{out} templates and ('dataset', name) references."""
    filled = []
    for t in tokens:
        if isinstance(t, tuple) and t[0] == "dataset":
            filled.append(_dataset(t[1]))
        else:
            # literal replacement, NOT str.format: argv tokens may contain
            # braces of their own (e.g. the --test-class-ratios dict)
            filled.append(t.replace("{data}", data).replace("{out}", out))
    return filled


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("experiment", nargs="?", default=None)
    parser.add_argument("--list", action="store_true")
    parser.add_argument("--outdir", default="experiments")
    parser.add_argument("--only", nargs="*", default=None,
                        help="run only these result kinds")
    parser.add_argument("--steps", type=int, default=None,
                        help="override the step budget of every run")
    parser.add_argument("--set", action="append", default=[],
                        metavar="NAME=VALUE",
                        help="override the value of --NAME in every run "
                             "that passes it, e.g. --set samps=20 to cut "
                             "the draws; a NAME that no run to be run "
                             "passes is an error")
    parser.add_argument("--force", action="store_true",
                        help="rerun even if the result file exists "
                             "(deletes stale checkpoints: starts fresh)")
    parser.add_argument("--redo", action="store_true",
                        help="rerun arms whose committed digest exists but "
                             "whose raw results pickle is gone (pickles are "
                             "gitignored and do not survive a fresh "
                             "checkout); resumes checkpoints, unlike --force")
    parser.add_argument("--seeds", type=int, default=None, metavar="N",
                        help="run N seed replicates under <out>/seed<k>/ "
                             "(k=1..N), varying both the data draw and the "
                             "model RNG; with --check, aggregates bands "
                             "over seed means into the parent report")
    parser.add_argument("--check", action="store_true",
                        help="run parity acceptance checks on the "
                             "experiment's existing results (writes "
                             "digest_<kind>.json.gz + parity_report.json)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu, passed on to every data "
                             "and model command; there is no fallback")
    args = parser.parse_args(argv)

    exps = catalog()
    if args.list or not args.experiment:
        print(f"{'experiment':<42} reproduces")
        for name, e in exps.items():
            print(f"{name:<42} {e.source}")
        return
    if args.experiment not in exps:
        sys.stderr.write(f"unknown experiment {args.experiment}\n")
        sys.exit(1)

    exp = exps[args.experiment]
    args.set = [tuple(kv.split("=", 1)) for kv in args.set]
    for pair in args.set:
        flag = "--" + pair[0]
        if len(pair) != 2 or not any(
                flag in argv for kind, argv in exp.runs.items()
                if not args.only or kind in args.only):
            sys.stderr.write(f"--set {'='.join(pair)}: no run of "
                             f"{exp.name} to be run passes {flag}\n")
            sys.exit(1)
    if not args.check:
        resolve_device(args.device)  # before anything is written
    out = os.path.join(args.outdir, exp.name)
    os.makedirs(out, exist_ok=True)

    seed_dirs = (
        [os.path.join(out, f"seed{k}") for k in range(1, args.seeds + 1)]
        if args.seeds else []
    )

    if args.check:
        import json

        from amf_tpu_torch.analysis.parity import (
            aggregate_seed_checks, check_experiment_dir, strict_active_for)

        rows = []
        hard_ok = True
        for d in ([out] if not seed_dirs else seed_dirs):
            drows, dok = check_experiment_dir(d)
            if seed_dirs:
                for r in drows:
                    r["seed_dir"] = os.path.basename(d)
            rows.extend(drows)
            hard_ok = hard_ok and dok
        if seed_dirs:
            agg = aggregate_seed_checks(seed_dirs, strict_active_for(out))
            rows.extend(agg)
            hard_ok = hard_ok and all(r["status"] != "fail" for r in agg)
        if not rows:
            sys.stderr.write(f"no results_*.pkl under {out}\n")
            sys.exit(2)
        width = max(len(r["key"]) for r in rows)
        for r in rows:
            print(f"[{r['status']:<4}] {r['check']:<18} "
                  f"{r['key']:<{width}}  {r['detail']}")
        report = {"experiment": exp.name, "source": exp.source,
                  "git_rev": _git_rev(), "checks": rows, "hard_ok": hard_ok}
        if args.seeds:
            report["seeds"] = args.seeds
        rpath = os.path.join(
            out, "parity_report_seeds.json" if seed_dirs
            else "parity_report.json")
        with open(rpath, "w") as f:
            json.dump(report, f, indent=1)
        print(f"\nreport: {rpath}  hard_ok={hard_ok}")
        sys.exit(0 if hard_ok else 1)

    for run_dir, seed in (
        [(out, None)] if not seed_dirs
        else [(d, k + 1) for k, d in enumerate(seed_dirs)]
    ):
        os.makedirs(run_dir, exist_ok=True)
        _run_experiment_once(exp, run_dir, args, seed)

    print(f"\nexperiment {exp.name} complete; results under {out}/")


def digest_path_for(result_path: str) -> str:
    """Committed digest path for a results pickle (analysis.parity naming)."""
    stem = os.path.basename(result_path)[len("results_"):-len(".pkl")]
    return os.path.join(os.path.dirname(result_path),
                        f"digest_{stem}.json.gz")


def _skip_reason(result_path: Optional[str], force: bool,
                 redo: bool) -> Optional[str]:
    """Why an arm should be skipped, or None to run it.

    Two durability tiers: the raw results pickle (evidence of this
    checkout; gitignored, lost on a fresh checkout) and the committed digest
    (the lasting record of a completed arm). --force reruns regardless;
    --redo reruns digest-only arms (a deliberate re-record) but still
    respects an existing pickle. A surviving different-era checkpoint
    cannot poison a --redo: the CLI's LoopCheckpointer moves it aside and
    re-records from scratch (utils/checkpoint.py era guard); a SAME-era
    checkpoint resumes, which is what lets killed re-records continue
    in a later run.
    """
    if not result_path or force:
        return None
    if os.path.exists(result_path):
        return f"exists: {result_path} (skipping; --force to rerun)"
    dpath = digest_path_for(result_path)
    if not redo and os.path.exists(dpath):
        return f"digest exists: {dpath} (skipping; --redo to re-record)"
    return None


def _run_experiment_once(exp: Experiment, out: str, args, seed=None) -> None:
    """Data prep + model runs for one (experiment, seed) replicate."""
    # choose_training saves via np.savez_compressed, which appends .npz to
    # any other suffix — name the file accordingly or it is never found
    mod0 = exp.data_cmd[0]
    suffix = ".npz" if "choose_training" in mod0 else ".pkl"
    data = os.path.join(out, "data" + suffix)
    rev = _git_rev()
    seed_args = [] if seed is None else ["--seed", str(seed)]

    if not os.path.exists(data):
        cmd = _fill(exp.data_cmd, data, out)
        if cmd[0] == "COPY":
            print(f"copying reference data: {cmd[1]} -> {cmd[2]}")
            shutil.copyfile(cmd[1], cmd[2])
        else:
            cmd = cmd + seed_args + ["--device", args.device]
            print("preparing data:", " ".join(cmd))
            mod, *rest = cmd
            subprocess.run([sys.executable, "-m", mod, *rest], check=True)
    else:
        print(f"data exists: {data} (skipping prep)")

    for kind, run_cmd in exp.runs.items():
        if args.only and kind not in args.only:
            continue
        cmd = _fill(run_cmd, data, out)
        # the file --save-results names (the JAX runner takes the first
        # argument that ends in .pkl and holds "results", which is the data
        # file when the output directory's path holds "results")
        result_path = (cmd[cmd.index("--save-results") + 1]
                       if "--save-results" in cmd else None)
        skip = _skip_reason(result_path, force=args.force,
                            redo=getattr(args, "redo", False))
        if skip:
            print(f"[{kind}] {skip}")
            continue
        if args.force:
            # a stale checkpoint would silently resume the OLD run and
            # immediately re-save it; --force means start fresh
            for tok in cmd:
                if isinstance(tok, str) and "/ckpt_" in tok and os.path.exists(tok):
                    os.remove(tok)
                    print(f"[{kind}] removed stale checkpoint {tok}")
        if args.steps is not None:
            if "--steps" in cmd:
                cmd[cmd.index("--steps") + 1] = str(args.steps)
            else:
                cmd = cmd[:1] + ["--steps", str(args.steps)] + cmd[1:]
        for name, value in args.set:
            if "--" + name in cmd:
                cmd[cmd.index("--" + name) + 1] = value
        cmd = cmd + seed_args + ["--device", args.device] + [
            "--note", f"git-rev:{rev}", "--note", f"experiment:{exp.name}"]
        print(f"[{kind}] running:", " ".join(cmd))
        mod, *rest = cmd
        proc = subprocess.run([sys.executable, "-m", mod, *rest])
        if proc.returncode != 0:
            sys.stderr.write(f"[{kind}] FAILED (exit {proc.returncode})\n")
            sys.exit(proc.returncode)


if __name__ == "__main__":
    main()
