"""CLI for the NUTS BPMF active loop on PyTorch, the reference's Stan path
(mirrors ``amf_tpu/run/bpmf.py``).

Same flags as the JAX package's CLI and ``stan-bpmf/bpmf.py MainProgram``
(:644-1056): --samps, --warmup, --lookahead-samps, --test-set,
--model-init, ..., the criterion keys and the results layout, plus
``--device`` (``cuda`` by default; ``cpu`` only when named). Binary data
(values {-1, 1} or {0, 1}) switches the metric to binary misclassification
like the reference (:53-54, :932-942). ``--checkpoint`` writes a
partial-results pickle and resumes from one. ``--scan`` runs each
criterion's sweep with its step logic on the device
(``active/scan_loop.run_stan_scan``) and writes the host path's layout;
it refuses ``--warm-adapt``, as the JAX package's does.
``--shard-candidates N`` runs N ranks (``parallel/mesh.launch``), each
scoring a shard of a lookahead criterion's candidates and, when
``--chains`` is a multiple of N, running its share of the chains; rank 0
prints and writes. With ``--scan`` the sweep runs unsharded.

    python -m amf_tpu_torch.run.bpmf --load-data data.npz -D 5 exp-variance
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys

import numpy as np

MODEL_BY_FILE = {
    "bpmf_w0identity.stan": "w0identity",
    "bpmf.stan": "bpmf",
    "bpmf_straightforward.stan": "straightforward",
}


def main(argv=None):
    from amf_tpu_torch.active.stan_loop import KEYS

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--latent-d", "-D", type=int, default=5)
    parser.add_argument("--steps", "-s", type=int, default=None)
    parser.add_argument("--samps", "-S", type=int, default=100)
    parser.add_argument("--warmup", "-W", type=int, default=None)
    parser.add_argument("--chains", type=int, default=1)
    parser.add_argument("--lookahead-samps", type=int, default=100)
    parser.add_argument("--lookahead-warmup", type=int, default=50)
    parser.add_argument("--lookahead-tile", type=int, default=256,
                        help="candidates per lockstep lookahead batch "
                             "(memory bound)")
    parser.add_argument("--shard-candidates", type=int, default=0,
                        metavar="N_DEVICES",
                        help="score the lookahead candidates (and split "
                             "the chains) on N ranks, one a card (gloo "
                             "processes with --device cpu)")
    parser.add_argument("--scan", action="store_true", default=False,
                        help="run each sweep with its step logic on the "
                             "device (active/scan_loop.py)")
    parser.add_argument("--scan-evals", action="store_true", default=False,
                        help="with --scan: also record per-step criterion "
                             "maps in the results (steps*n*m memory)")
    parser.add_argument("--warm-adapt", action="store_true", default=False,
                        help="carry NUTS adaptation (eps + inverse mass) "
                             "between active steps: refits after the first "
                             "use --warm-warmup transitions (no reference "
                             "analogue; see PARITY.md)")
    parser.add_argument("--warm-warmup", type=int, default=None,
                        help="warmup for warm-started refits "
                             "(default warmup//4, min 20)")
    parser.add_argument("--subtract-mean", action="store_true", default=True)
    parser.add_argument(
        "--no-subtract-mean", action="store_false", dest="subtract_mean")
    parser.add_argument("--model-init", action="store_true", default=True,
                        help="initialize chains at a PMF MAP fit")
    parser.add_argument("--no-model-init", action="store_false",
                        dest="model_init")
    parser.add_argument(
        "--model-filename", default="bpmf_w0identity.stan",
        help="density variant, by reference .stan filename "
             "(stan-bpmf/bpmf.py:739-742): bpmf_w0identity.stan (default), "
             "bpmf.stan (general-w_0 construction, w_0 = I data), "
             "bpmf_straightforward.stan (naive centered parameterization)")
    parser.add_argument("--test-set", default="all")
    parser.add_argument("--query-new-only", action="store_true",
                        default=False,
                        help="only query cells in columns flagged by the "
                             "data file's _is_new_item vector (reference: "
                             "stan-bpmf/bpmf.py:736-737,917-919)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--float32", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; there is no fallback")
    parser.add_argument("--verbose", action="store_true", default=True)
    parser.add_argument("--no-verbose", action="store_false", dest="verbose")
    parser.add_argument("--load-data", required=True, metavar="FILE")
    parser.add_argument("--save-results", nargs="?", default=True, const=True,
                        metavar="FILE")
    parser.add_argument("--no-save-results", action="store_false",
                        dest="save_results")
    parser.add_argument("--note", action="append")
    parser.add_argument("--checkpoint", default=None, metavar="FILE",
                        help="partial-results checkpoint for exact resume")
    parser.add_argument("keys", nargs="*",
                        help="Choices: {}.".format(", ".join(sorted(KEYS))))
    args = parser.parse_args(argv)

    key_names = args.keys or sorted(KEYS)
    for k in key_names:
        if k not in KEYS:
            sys.stderr.write(
                f"Invalid key name {k}; options are {', '.join(sorted(KEYS))}.\n"
            )
            sys.exit(1)
    if args.scan and args.warm_adapt:
        parser.error("--warm-adapt needs the host loop, as in the JAX "
                     "package; drop --scan")
    if args.model_filename not in MODEL_BY_FILE:
        sys.stderr.write(
            f"Unknown --model-filename {args.model_filename}; options are "
            f"{', '.join(sorted(MODEL_BY_FILE))}.\n")
        sys.exit(1)
    from amf_tpu_torch.parallel.mesh import launch_cli

    return launch_cli(_run, args, key_names)


def _run(mesh, args, key_names):
    import torch

    from amf_tpu_torch import types
    from amf_tpu_torch.active.gibbs_loop import split_query_test
    from amf_tpu_torch.active.stan_loop import (KEYS, run_active_stan,
                                                stan_family)
    from amf_tpu_torch.data.loaders import load_npz_schema
    from amf_tpu_torch.mcmc.nuts import SAMPLER_ERA
    from amf_tpu_torch.models import bpmf_hmc
    from amf_tpu_torch.parallel.mesh import is_lead
    from amf_tpu_torch.utils.platform import setup as platform_setup

    device, dtype = platform_setup(use_x64=not args.float32, device=args.device)

    if args.save_results is True:
        args.save_results = "results.pkl"
    if args.save_results and is_lead(mesh):
        dirname = os.path.dirname(args.save_results)
        if dirname:
            os.makedirs(dirname, exist_ok=True)

    data = load_npz_schema(args.load_data)
    real = data["_real"]
    ratings = data["_ratings"]
    vals = tuple(data.get("_rating_vals", ())) or ()

    rng = np.random.default_rng(args.seed)
    query_on, test_on = split_query_test(real, ratings, args.test_set, rng)
    if "_test_on" in data:
        test_on = data["_test_on"]
        # held-out test cells must not be queryable (reference:
        # stan-bpmf/bpmf.py:915, mn_active_pmf.py:1091-1093)
        query_on = query_on & ~np.asarray(test_on, dtype=bool)
    if args.query_new_only:
        if "_is_new_item" not in data:
            sys.stderr.write("--query-new-only needs _is_new_item in the "
                             "data file\n")
            sys.exit(1)
        # zero out queries to old-item columns (stan-bpmf/bpmf.py:917-919)
        new_item = np.asarray(data["_is_new_item"], dtype=bool)
        query_on = query_on & new_item[None, :]

    problem = types.problem_from_ratings(
        ratings, real=real, test=test_on, dtype=dtype, device=device)
    problem = dataclasses.replace(
        problem, queryable=torch.as_tensor(query_on, device=device))
    binary_acc = set(vals) in ({-1.0, 1.0}, {0.0, 1.0})

    loop_kw = dict(
        latent_d=args.latent_d,
        rating_values=vals,
        subtract_mean=args.subtract_mean,
        cfg=bpmf_hmc.HMCConfig(
            latent_d=args.latent_d, subtract_mean=args.subtract_mean,
            model=MODEL_BY_FILE[args.model_filename]),
        num_samps=args.samps,
        warmup=args.warmup,
        chains=args.chains,
        lookahead_samps=args.lookahead_samps,
        lookahead_warmup=args.lookahead_warmup,
        lookahead_tile=args.lookahead_tile,
        seed=args.seed,
        model_init_map=args.model_init,
        binary_acc=binary_acc,
        warm_adapt=args.warm_adapt,
        warm_warmup=args.warm_warmup,
        dtype=dtype,
        device=device,
        verbose=args.verbose,
    )
    if args.scan:
        from amf_tpu_torch.active import scan_loop

        problem, family, state0 = stan_family(problem, real, **loop_kw)
        results = {"_real": np.asarray(real),
                   "_ratings": types.ratings_array(problem),
                   "_rating_vals": tuple(sorted(vals)) or None}
        results.update(scan_loop.sweep_records(
            problem, real, key_names, args.steps, family, state0, args.seed,
            lambda kname: KEYS[kname].choose_max,
            record_evals=args.scan_evals, verbose=args.verbose))
    else:
        results = run_active_stan(
            problem, real, key_names, steps=args.steps,
            checkpoint_path=args.checkpoint, mesh=mesh, **loop_kw)

    if args.save_results and is_lead(mesh):
        print(f"\nsaving results in '{args.save_results}'")
        results = dict(results)
        results["_kind"] = "stan"
        results["_args"] = vars(args)
        # the engine era that recorded the run (analysis/parity digests)
        results["_sampler_era"] = SAMPLER_ERA
        with open(args.save_results, "wb") as f:
            pickle.dump(results, f)
    return results


if __name__ == "__main__":
    main()
