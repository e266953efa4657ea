"""CLI for the RatingConcentration active loop on PyTorch
(mirrors ``amf_tpu/run/active_rc.py``).

Mirrors the reference bridge ``ratingconcentration/active_rc.py main()``
(:128-201) minus the MATLAB subprocess machinery: same flags (--delta,
--pred-mode, --steps), selector keys, 'rc_<key>' result prefixes, and the
reference's "+.01 if zeros present" data shift (active_rc.py:52-54), plus
``--device`` (``cuda`` by default; ``cpu`` only when named).
``--checkpoint`` writes a partial-results pickle and resumes from one.
``--shard-candidates N`` runs N ranks (``parallel/mesh.launch``), each
refitting a shard of the ``entropy`` candidates; rank 0 prints and
writes.

    python -m amf_tpu_torch.run.active_rc --load-data data.npz -s 10 entropy
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np

def main(argv=None):
    from amf_tpu_torch.models.ratingconc import RC_KEYS

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--delta", type=float, default=1.5)
    parser.add_argument("--steps", "-s", type=int, default=None)
    parser.add_argument("--pred-mode", action="store_true", default=False,
                        help="evaluate argmax-P predictions instead of E")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--float32", action="store_true")
    parser.add_argument("--max-iters", type=int, default=500)
    parser.add_argument("--lookahead-iters", type=int, default=60)
    parser.add_argument("--lookahead-tile", type=int, default=256,
                        help="candidates per lockstep lookahead batch "
                             "(memory bound)")
    parser.add_argument("--shard-candidates", type=int, default=0,
                        metavar="N_DEVICES",
                        help="refit the entropy candidates on N ranks, one "
                             "a card (gloo processes with --device cpu)")
    parser.add_argument("--checkpoint", default=None, metavar="FILE",
                        help="partial-results checkpoint for exact resume")
    parser.add_argument("--any-vals", action="store_true", default=False,
                        help="allow value sets beyond the reference's 1:5/1:2")
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
                        help="Choices: {}.".format(", ".join(sorted(RC_KEYS))))
    args = parser.parse_args(argv)

    key_names = args.keys or sorted(RC_KEYS)
    for k in key_names:
        if k not in RC_KEYS:
            sys.stderr.write(
                f"Invalid key name {k}; options are {', '.join(sorted(RC_KEYS))}.\n"
            )
            sys.exit(1)
    from amf_tpu_torch.parallel.mesh import launch_cli

    return launch_cli(_run, args, key_names)


def _run(mesh, args, key_names):
    from amf_tpu_torch import types
    from amf_tpu_torch.active.rc_loop import run_active_rc
    from amf_tpu_torch.data.loaders import load_npz_schema
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
    real = np.asarray(data["_real"], dtype=np.float64)
    if (real == 0).any():
        # the maxent model cannot represent 0 (= unknown); reference shifts
        real = real + 0.01
        if (real == 0).any():
            raise ValueError("ratings of -0.01 cannot be shifted off zero")
    ratings = data["_ratings"]

    known = np.zeros(real.shape, dtype=bool)
    known[ratings[:, 0].astype(int), ratings[:, 1].astype(int)] = True
    problem = types.problem_from_dense(
        real, known, test=data.get("_test_on"), dtype=dtype, device=device)

    vals = data.get("_rating_vals")
    # 0 marks 'unknowable' in the schema, never a rating value
    eff_vals = (sorted(float(v) for v in vals if v != 0) if vals is not None
                else sorted(set(real[np.isfinite(real) & (real != 0)].ravel())))
    if not args.any_vals and eff_vals not in (
        [1.0, 2.0, 3.0, 4.0, 5.0], [1.0, 2.0],
    ):
        # the reference hard-errors on any other value set
        # (evaluate_active.m:20-25); the generalized feature map takes any
        # discrete values, but a large value set explodes the lookahead
        # fan-out, so it needs an explicit opt-in
        sys.stderr.write(
            f"rating values {eff_vals[:8]}{'...' if len(eff_vals) > 8 else ''} "
            "are not 1:5 or 1:2 (the only sets the reference supports, "
            "evaluate_active.m:20-25); pass --any-vals to run anyway\n"
        )
        sys.exit(1)

    results = run_active_rc(
        problem, real, key_names,
        delta=args.delta,
        rating_values=tuple(vals) if vals is not None else None,
        steps=args.steps, seed=args.seed,
        pred_mode=args.pred_mode,
        lookahead_iters=args.lookahead_iters,
        lookahead_tile=args.lookahead_tile,
        max_iters=args.max_iters,
        dtype=dtype, device=device, verbose=args.verbose,
        checkpoint_path=args.checkpoint, mesh=mesh,
    )

    if args.save_results and is_lead(mesh):
        print(f"\nsaving results in '{args.save_results}'")
        out = {("rc_" + k if not k.startswith("_") else k): v
               for k, v in results.items()}
        out["_kind"] = "rc"
        out["_args"] = vars(args)
        with open(args.save_results, "wb") as f:
            pickle.dump(out, f)
    return results


if __name__ == "__main__":
    main()
