"""CLI for the variational active-PMF models on PyTorch
(mirrors ``amf_tpu/run/active_pmf.py``).

Same flags as the JAX package's CLI and the reference entry points
``python-pmf/active_pmf.py main()`` (:1100-1257) and ``mn_active_pmf.py
main()`` (:1011-1128): criterion keys, data schema and results pickle, plus
``--device`` (``cuda`` by default; ``cpu`` only when named). ``--model mn``
selects the matrix-normal approximation. ``--checkpoint`` writes a
partial-results pickle and resumes from one. ``--scan`` runs each
criterion's sweep with its step logic on the device
(``active/scan_loop.run_active_scan``) and writes the host path's layout;
it refuses ``--fit-sigmas``, as the JAX package's does.
``--shard-candidates N`` runs N ranks (``parallel/mesh.launch``), each
scoring a shard of a lookahead criterion's candidates; rank 0 prints and
writes. With ``--scan`` the sweep runs unsharded.

    python -m amf_tpu_torch.run.active_pmf --device cuda -N 24 -M 24 -D 2 \\
        --mask .2 total-variance
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np

def add_bool_opt(parser, name, default=False):
    parser.add_argument("--" + name, action="store_true", default=default)
    parser.add_argument(
        "--no-" + name, action="store_false", dest=name.replace("-", "_"))


def build_parser():
    from amf_tpu_torch.active.criteria import KEY_FUNCS

    parser = argparse.ArgumentParser(description=__doc__)
    model = parser.add_argument_group("Model Options")
    model.add_argument("--model", choices=("vn", "mn"), default="vn")
    model.add_argument("--latent-d", "-D", type=int, default=5)
    model.add_argument(
        "--discrete-integration", nargs="?", const=True, default=False)
    model.add_argument("--continuous-integration", action="store_false",
                       dest="discrete_integration")
    add_bool_opt(model, "fit-sigmas", default=False)
    add_bool_opt(model, "refit-lookahead", default=False)
    model.add_argument("--lookahead-budget", type=int, default=300,
                       help="max inner-fit iterations of each lookahead lane")
    model.add_argument("--cov-param", choices=("psd-project", "chol"),
                       default="psd-project",
                       help="vn covariance descent parameterization: "
                            "psd-project = the reference's eigh-projected "
                            "descent (parity default); chol = Cholesky-"
                            "factor descent (PSD by construction, no "
                            "per-step eigh; same KL objective, different "
                            "trajectory)")
    model.add_argument("keys", nargs="*",
                       help="Choices: {}.".format(", ".join(sorted(KEY_FUNCS))))

    problem_def = parser.add_argument_group("Problem Definition")
    problem_def.add_argument("--load-data", default=None, metavar="FILE")
    problem_def.add_argument("--load-model", default=None, metavar="FILE",
                             help="reuse the fitted initial model/approx "
                                  "snapshot (_initial_state) of a previous "
                                  "results pickle of this CLI")
    problem_def.add_argument("--gen-rank", "-R", type=int, default=5)
    problem_def.add_argument("--type", default="float")
    problem_def.add_argument("--u-mean", type=float, default=0)
    problem_def.add_argument("--u-std", type=float, default=2)
    problem_def.add_argument("--v-mean", type=float, default=0)
    problem_def.add_argument("--v-std", type=float, default=2)
    problem_def.add_argument("--noise", "-n", type=float, default=0.25)
    problem_def.add_argument("--num-users", "-N", type=int, default=10)
    problem_def.add_argument("--num-items", "-M", type=int, default=10)
    problem_def.add_argument("--mask", "-m", default=0.0)

    running = parser.add_argument_group("Running")
    running.add_argument("--steps", "-s", type=int, default=None)
    running.add_argument("--seed", type=int, default=0)
    running.add_argument("--scan", action="store_true", default=False,
                         help="run each sweep with its step logic on the "
                              "device (active/scan_loop.py)")
    running.add_argument("--scan-evals", action="store_true", default=False,
                         help="with --scan: also record per-step criterion "
                              "maps in the results (steps*n*m memory)")
    running.add_argument("--shard-candidates", type=int, default=0,
                         metavar="N_DEVICES",
                         help="score the lookahead candidates on N ranks, "
                              "one a card (gloo processes with --device "
                              "cpu)")
    running.add_argument("--lookahead-tile", type=int, default=0,
                         help="candidates a tile of lookahead lanes (memory "
                              "bound; 0 = the whole pool)")
    running.add_argument("--lookahead-host-tiles", action="store_true",
                         default=False,
                         help="accepted for compatibility: lookahead tiles "
                              "are always dispatched from the host here")
    running.add_argument("--float32", action="store_true",
                         help="run in float32")
    running.add_argument("--device", default="cuda",
                         help="cuda (default) or cpu; there is no fallback")
    add_bool_opt(running, "verbose", default=True)

    results = parser.add_argument_group("Results")
    results.add_argument("--save-results", nargs="?", default=None, const=True,
                         metavar="FILE")
    results.add_argument("--no-save-results", action="store_false",
                         dest="save_results")
    results.add_argument("--note", action="append",
                         help="Saved into the results file; otherwise unused.")
    results.add_argument("--checkpoint", default=None, metavar="FILE",
                         help="partial-results file for mid-run checkpoints "
                              "and exact resume")
    return parser


def _load_initial_state(path, model):
    """(pmf state, approximation or None) from a results pickle's
    ``_initial_state`` (two dicts of numpy arrays) on the CPU."""
    from amf_tpu_torch import convert

    with open(path, "rb") as f:
        prev = pickle.load(f)
    snap = prev.get("_initial_state")
    if snap is None:
        sys.exit(f"{path} has no _initial_state snapshot")
    pst, ast = snap
    approx = convert.mn_state if model == "mn" else convert.vn_state
    return (convert.pmf_state(pst, device="cpu"),
            None if ast is None else approx(ast, device="cpu"))


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    from amf_tpu_torch.active.criteria import KEY_FUNCS, MN_KEY_FUNCS

    registry = KEY_FUNCS if args.model == "vn" else MN_KEY_FUNCS
    key_names = args.keys or sorted(registry)
    for k in key_names:
        if k not in registry:
            sys.stderr.write(f"Invalid key name {k}; options are "
                             f"{', '.join(sorted(registry))}.\n")
            sys.exit(1)
    if args.scan and args.fit_sigmas:
        sys.stderr.write("--scan does not support --fit-sigmas\n")
        sys.exit(1)
    from amf_tpu_torch.parallel.mesh import launch_cli

    return launch_cli(_run, args, key_names)


def _run(mesh, args, key_names):
    from amf_tpu_torch import convert, types
    from amf_tpu_torch.active import loop
    from amf_tpu_torch.active.criteria import KEY_FUNCS, MN_KEY_FUNCS
    from amf_tpu_torch.data.loaders import load_npz_schema
    from amf_tpu_torch.data.synthetic import make_fake_data
    from amf_tpu_torch.parallel.mesh import is_lead
    from amf_tpu_torch.utils.platform import setup as platform_setup

    registry = KEY_FUNCS if args.model == "vn" else MN_KEY_FUNCS
    lead = is_lead(mesh)
    device, dtype = platform_setup(use_x64=not args.float32, device=args.device)
    if args.verbose and lead:
        print(f"device: {device}, {dtype}")

    try:
        args.mask = float(args.mask)
    except ValueError:
        pass
    try:
        args.type = int(args.type)
    except ValueError:
        pass

    if args.save_results is True:
        args.save_results = "results.pkl"
    if args.save_results and lead:
        dirname = os.path.dirname(args.save_results)
        if dirname:
            os.makedirs(dirname, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    if args.load_data:
        data = load_npz_schema(args.load_data)
        real = data["_real"]
        vals = tuple(data.get("_rating_vals", ())) or ()
        problem = types.problem_from_ratings(
            data["_ratings"], real=real, test=data.get("_test_on"),
            dtype=dtype, device=device)
    else:
        real, known, vals = make_fake_data(
            noise=args.noise, num_users=args.num_users,
            num_items=args.num_items, mask_type=args.mask,
            data_type=args.type, rank=args.gen_rank, u_mean=args.u_mean,
            u_std=args.u_std, v_mean=args.v_mean, v_std=args.v_std, rng=rng)
        vals = tuple(vals) if vals else ()
        # synthetic data: every cell is knowable (the reference applies the
        # 0-means-unknowable rule only to --load-data, active_pmf.py:1216-1219)
        problem = types.problem_from_dense(real, known, dtype=dtype,
                                           zeros_unknowable=False,
                                           device=device)

    initial_state = None
    if args.load_model:
        initial_state = _load_initial_state(args.load_model, args.model)
        if lead:
            print(f"reusing initial model from {args.load_model}")

    loop_kw = dict(
        latent_d=args.latent_d,
        rating_values=vals,
        discrete_exp=args.discrete_integration,
        refit_lookahead=args.refit_lookahead,
        fit_sigmas=args.fit_sigmas,
        seed=args.seed,
        model=args.model,
        lookahead_budget=args.lookahead_budget,
        lookahead_tile=args.lookahead_tile,
        cov_param=args.cov_param,
        dtype=dtype,
        device=device,
        initial_state=initial_state,
    )
    if args.scan:
        from amf_tpu_torch.active import scan_loop

        problem, family, state0 = loop.active_pmf_family(
            problem, real, key_names, **loop_kw)
        results = {"_real": np.asarray(real),
                   "_ratings": types.ratings_array(problem),
                   "_rating_vals": tuple(vals) if vals else None,
                   "_initial_state": state0}
        results.update(scan_loop.sweep_records(
            problem, real, key_names, args.steps, family, state0, args.seed,
            lambda kname: registry[kname].maximize,
            record_evals=args.scan_evals, verbose=args.verbose))
    else:
        results = loop.run_active_pmf(
            problem, real, key_names, steps=args.steps, verbose=args.verbose,
            checkpoint_path=args.checkpoint, mesh=mesh, **loop_kw)

    if args.save_results and lead:
        print(f"saving results in '{args.save_results}'")
        results = dict(results)
        # the initial snapshot as numpy arrays, for --load-model
        pst, ast = results["_initial_state"]
        results["_initial_state"] = (
            convert.to_numpy(pst), None if ast is None else convert.to_numpy(ast))
        results["_kind"] = "mnpmf" if args.model == "mn" else "apmf"
        results["_args"] = vars(args)
        with open(args.save_results, "wb") as f:
            pickle.dump(results, f)
    return results


if __name__ == "__main__":
    main()
