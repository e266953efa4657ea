"""CLI for the Gibbs Bayesian PMF active loop on PyTorch
(mirrors ``amf_tpu/run/bayes_pmf.py``).

Same flags as the JAX package's CLI and the reference's
``python-pmf/bayes_pmf.py main()`` (:828-938), same criterion keys, data
schema and results pickle, plus ``--device``. ``--checkpoint`` writes a
partial-results pickle and resumes from one. ``--scan`` runs each
criterion's sweep with its step logic on the device
(``active/scan_loop.run_gibbs_scan``) and writes the host path's layout;
``--shard-candidates N`` runs N ranks (``parallel/mesh.launch``), each
scoring a shard of the ``exp-variance`` candidates; rank 0 prints and
writes. With ``--scan`` the sweep runs unsharded.

    python -m amf_tpu_torch.run.bayes_pmf --load-data data.npz exp-variance
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys

import numpy as np

def main(argv=None):
    from amf_tpu_torch.active.gibbs_loop import KEYS

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--latent-d", "-D", type=int, default=5,
                        help="factor width, any d on the card and on the CPU: "
                             "the CUDA kernels take d <= 32 from libraries "
                             "built at first use, and a wider d builds a "
                             "library of its own at its first use")
    parser.add_argument("--steps", "-s", type=int, default=None)
    parser.add_argument("--discrete", action="store_true", default=None)
    parser.add_argument("--no-discrete", action="store_false", dest="discrete")
    parser.add_argument("--subtract-mean", action="store_true", default=True)
    parser.add_argument(
        "--no-subtract-mean", action="store_false", dest="subtract_mean"
    )
    parser.add_argument("--fit", default="batch")
    parser.add_argument("--samps", "-S", type=int, default=128)
    parser.add_argument("--lookahead-samps", type=int, default=30)
    parser.add_argument("--lookahead-tile", type=int, default=256,
                        help="candidates per lookahead batch (memory bound)")
    parser.add_argument("--lookahead-host-tiles", action="store_true",
                        default=False,
                        help="accepted for compatibility: lookahead tiles "
                             "are always dispatched from the host here")
    parser.add_argument("--shard-candidates", type=int, default=0,
                        metavar="N_DEVICES",
                        help="score the lookahead candidates on N ranks, "
                             "one a card (gloo processes with --device cpu)")
    parser.add_argument("--scan-evals", action="store_true", default=False,
                        help="with --scan: also record per-step criterion "
                             "maps in the results (steps*n*m memory)")
    parser.add_argument("--scan", action="store_true", default=False,
                        help="run each sweep with its step logic on the "
                             "device (active/scan_loop.py; use --scan-evals "
                             "to also record per-step criterion maps)")
    parser.add_argument("--test-set", default="all")
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
    from amf_tpu_torch.parallel.mesh import launch_cli

    return launch_cli(_run, args, key_names)


def _run(mesh, args, key_names):
    import torch

    from amf_tpu_torch import types
    from amf_tpu_torch.active.gibbs_loop import (KEYS, gibbs_family,
                                                 run_active_gibbs,
                                                 split_query_test)
    from amf_tpu_torch.data.loaders import load_npz_schema
    from amf_tpu_torch.models.pmf import parse_fit_type
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
    if args.discrete is None:
        args.discrete = bool(vals)
    if not args.discrete:
        vals = ()

    rng = np.random.default_rng(args.seed)
    query_on, test_on = split_query_test(real, ratings, args.test_set, rng)
    if "_test_on" in data:
        test_on = data["_test_on"]
        # held-out test cells must not be queryable (reference:
        # stan-bpmf/bpmf.py:915, mn_active_pmf.py:1091-1093)
        query_on = query_on & ~np.asarray(test_on, dtype=bool)

    problem = types.problem_from_ratings(
        ratings, real=real, test=test_on, dtype=dtype, device=device)
    problem = dataclasses.replace(
        problem, queryable=torch.as_tensor(query_on, device=device))

    # reference's DrugBank behavior: binary data switches the recorded
    # metric to misclassification (stan-bpmf/bpmf.py:53-54,932-942)
    binary_acc = set(vals) in ({-1.0, 1.0}, {0.0, 1.0})
    loop_kw = dict(
        latent_d=args.latent_d,
        rating_values=vals,
        binary_acc=binary_acc,
        subtract_mean=args.subtract_mean,
        num_samps=args.samps,
        lookahead_samps=args.lookahead_samps,
        lookahead_tile=args.lookahead_tile,
        fit_type=parse_fit_type(args.fit),
        dtype=dtype,
        device=device,
    )
    if args.scan:
        from amf_tpu_torch.active import scan_loop

        problem, family, state0 = gibbs_family(problem, real, seed=args.seed,
                                               **loop_kw)
        results = {"_real": np.asarray(real),
                   "_ratings": types.ratings_array(problem),
                   "_rating_vals": tuple(sorted(vals)) or None}
        results.update(scan_loop.sweep_records(
            problem, real, key_names, args.steps, family, state0, args.seed,
            lambda kname: KEYS[kname].choose_max,
            record_evals=args.scan_evals, verbose=args.verbose))
    else:
        results = run_active_gibbs(
            problem, real, key_names, steps=args.steps, seed=args.seed,
            verbose=args.verbose, checkpoint_path=args.checkpoint, mesh=mesh,
            **loop_kw)

    if args.save_results and is_lead(mesh):
        print(f"\nsaving results in '{args.save_results}'")
        results = dict(results)
        results["_kind"] = "bayes"
        results["_args"] = vars(args)
        with open(args.save_results, "wb") as f:
            pickle.dump(results, f)
    return results


if __name__ == "__main__":
    main()
