"""CLI for the MMMF active loop on PyTorch
(mirrors ``amf_tpu/run/active_mmmf.py``).

Mirrors the reference bridge ``mmmf/active_mmmf.py main()`` (:155-245) minus
the MATLAB subprocess machinery: same flags (--cutoff to binarize, -C slack
penalty, --steps), selector keys, and 'mmmf_<key>' result prefixes so results
merge into the shared analysis tooling like the reference does (:240-245),
plus ``--device`` (``cuda`` by default; ``cpu`` only when named).
``--checkpoint`` writes a partial-results pickle and resumes from one.

    python -m amf_tpu_torch.run.active_mmmf --load-data data.npz -s 50
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np


def main(argv=None):
    from amf_tpu_torch.models.mmmf import MMMF_KEYS

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--cutoff", type=float, default=None,
                        help="binarize: >= cutoff -> +1, else -1")
    parser.add_argument("-C", "--slack", type=float, default=1.0, dest="C")
    parser.add_argument("--steps", "-s", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--float32", action="store_true")
    parser.add_argument("--admm-iters", type=int, default=2000)
    parser.add_argument("--admm-tol", type=float, default=None,
                        help="ADMM residual tolerance (default 1e-6 f64, "
                             "1e-5 f32 — near the f32 residual floor)")
    parser.add_argument("--mode", choices=("avg", "max"), default="avg",
                        help="solveD maxoravg mode: 'avg' nuclear norm, "
                             "'max' max-norm (solveD.m:37-45)")
    parser.add_argument("--keep-predictions", action="store_true",
                        help="store the learned X per step like the reference")
    parser.add_argument("--checkpoint", default=None, metavar="FILE",
                        help="partial-results checkpoint for exact resume "
                             "(reference: partial_results.mat every 20 steps, "
                             "mmmf/evaluate_active.m:84-86)")
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
    parser.add_argument("keys", nargs="*",
                        help="Choices: {}.".format(", ".join(sorted(MMMF_KEYS))))
    args = parser.parse_args(argv)

    key_names = args.keys or sorted(MMMF_KEYS)
    for k in key_names:
        if k not in MMMF_KEYS:
            sys.stderr.write(
                f"Invalid key name {k}; options are {', '.join(sorted(MMMF_KEYS))}.\n"
            )
            sys.exit(1)

    from amf_tpu_torch import types
    from amf_tpu_torch.active.mmmf_loop import binarize, run_active_mmmf
    from amf_tpu_torch.data.loaders import load_npz_schema
    from amf_tpu_torch.models.mmmf import SOLVER_ERA, MMMFConfig
    from amf_tpu_torch.utils.platform import setup as platform_setup

    device, dtype = platform_setup(use_x64=not args.float32, device=args.device)

    if args.save_results is True:
        args.save_results = "results.pkl"
    if args.save_results:
        dirname = os.path.dirname(args.save_results)
        if dirname:
            os.makedirs(dirname, exist_ok=True)

    data = load_npz_schema(args.load_data)
    y = binarize(data["_real"], args.cutoff)
    ratings = data["_ratings"]

    known = np.zeros(y.shape, dtype=bool)
    known[ratings[:, 0].astype(int), ratings[:, 1].astype(int)] = True
    problem = types.problem_from_dense(
        y, known, test=data.get("_test_on"), dtype=dtype, device=device)

    results = run_active_mmmf(
        problem, y, key_names,
        C=args.C, steps=args.steps, seed=args.seed,
        cfg=MMMFConfig(
            C=args.C, max_iters=args.admm_iters,
            tol=args.admm_tol or (1e-5 if args.float32 else 1e-6),
        ),
        mode=args.mode,
        dtype=dtype, device=device, keep_predictions=args.keep_predictions,
        verbose=args.verbose,
        checkpoint_path=args.checkpoint,
    )

    if args.save_results:
        print(f"\nsaving results in '{args.save_results}'")
        out = {("mmmf_" + k if not k.startswith("_") else k): v
               for k, v in results.items()}
        out["_kind"] = "mmmf"
        out["_args"] = vars(args)
        # run-time engine-era stamp: which solver produced these records
        out["_solver_era"] = SOLVER_ERA
        with open(args.save_results, "wb") as f:
            pickle.dump(out, f)
    return results


if __name__ == "__main__":
    main()
