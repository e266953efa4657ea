"""CLI for the cold-start (new items) BPMF active loop on PyTorch
(mirrors ``amf_tpu/run/bpmf_newitems.py``).

Mirrors ``stan-bpmf/bpmf_newitems.py`` (:12-138): two-phase fit — a full
BPMF fit on old items (cacheable via --initial-fit-file) then an active loop
sampling only the new-item columns' factors. The cold-start MainProgram
inherits the FULL criterion registry of the stan path, including the
sampling lookaheads (bpmf_newitems.py:48 reusing bpmf.py:544-556). Same
flags as the JAX package's CLI plus ``--device`` (``cuda`` by default;
``cpu`` only when named). ``--checkpoint`` writes a partial-results pickle
stamped with the sampler era and resumes from one. ``--shard-candidates
N`` runs N ranks (``parallel/mesh.launch``), each scoring a shard of a
lookahead criterion's candidates; rank 0 prints and writes.

    python -m amf_tpu_torch.run.bpmf_newitems --load-data split.npz -D 20 \\
        --initial-fit-file fit.npz exp-variance
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np

KEY_CHOICES = (
    "random", "pred-variance", "exp-variance", "exp-entropy-est", "pred",
    "prob-ge-3.5", "prob-ge-.5", "prob-ge-0",
)
_MINIMIZE = ("exp-variance", "exp-entropy-est")
_CUTOFFS = (3.5, 0.5, 0.0)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--latent-d", "-D", type=int, default=5)
    parser.add_argument("--steps", "-s", type=int, default=None)
    parser.add_argument("--samps", "-S", type=int, default=100)
    parser.add_argument("--warmup", "-W", type=int, default=None)
    parser.add_argument("--lookahead-samps", type=int, default=100)
    parser.add_argument("--lookahead-warmup", type=int, default=50)
    parser.add_argument("--lookahead-tile", type=int, default=256,
                        help="candidates per lockstep lookahead batch")
    parser.add_argument("--shard-candidates", type=int, default=0,
                        metavar="N_DEVICES",
                        help="score the lookahead candidates on N ranks, "
                             "one a card (gloo processes with --device cpu)")
    parser.add_argument("--initial-fit-samps", type=int, default=200)
    parser.add_argument("--initial-fit-file", default=None,
                        help="cache the phase-1 posterior means here (.npz)")
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
                        help="partial-results checkpoint for exact resume "
                             "(picks stored in new-item submatrix indices)")
    parser.add_argument("keys", nargs="*",
                        help="Choices: {}.".format(", ".join(KEY_CHOICES)))
    args = parser.parse_args(argv)

    key_names = args.keys or list(KEY_CHOICES)
    for k in key_names:
        if k not in KEY_CHOICES:
            sys.stderr.write(
                f"Invalid key name {k}; options are {', '.join(KEY_CHOICES)}.\n"
            )
            sys.exit(1)
    from amf_tpu_torch.parallel.mesh import launch_cli

    return launch_cli(_run, args, key_names)


def _run(mesh, args, key_names):
    import torch

    from amf_tpu_torch import types
    from amf_tpu_torch.active.driver import Family, drive_active
    from amf_tpu_torch.analysis import metrics
    from amf_tpu_torch.data.loaders import load_npz_schema
    from amf_tpu_torch.mcmc.nuts import SAMPLER_ERA
    from amf_tpu_torch.models import bpmf_hmc, newitems, sample_stats
    from amf_tpu_torch.parallel.mesh import is_lead
    from amf_tpu_torch.parallel.sharding import sharded_candidate_scores
    from amf_tpu_torch.types import rating_bounds
    from amf_tpu_torch.utils.checkpoint import LoopCheckpointer
    from amf_tpu_torch.utils.platform import setup as platform_setup
    from amf_tpu_torch.utils.rng import fold_in_name, generator

    device, dtype = platform_setup(use_x64=not args.float32, device=args.device)
    lead = is_lead(mesh)

    if args.save_results is True:
        args.save_results = "results.pkl"
    if args.save_results and lead:
        dirname = os.path.dirname(args.save_results)
        if dirname:
            os.makedirs(dirname, exist_ok=True)

    data = load_npz_schema(args.load_data)
    real = data["_real"]
    if "_is_new_item" not in data:
        sys.stderr.write("data file has no _is_new_item array\n")
        sys.exit(1)
    is_new = data["_is_new_item"]
    vals = tuple(data.get("_rating_vals", ())) or ()
    lookahead_keys = [k for k in key_names if k in _MINIMIZE]
    if lookahead_keys and not vals:
        sys.stderr.write(
            f"{lookahead_keys} need _rating_vals in the data file\n"
        )
        sys.exit(1)

    problem = types.problem_from_ratings(
        data["_ratings"], real=real, test=data.get("_test_on"), dtype=dtype,
        device=device)
    cfg = bpmf_hmc.HMCConfig(latent_d=args.latent_d)

    # ---- phase 1 (cacheable; reference: bpmf_newitems.py:79-101)
    cached_fit = bool(args.initial_fit_file
                      and os.path.exists(args.initial_fit_file))
    if mesh is not None:  # every rank decides before rank 0 may write it
        mesh.check_same(cached_fit, "whether the initial fit file exists")
    if cached_fit:
        cached = np.load(args.initial_fit_file)

        def load(name):
            return torch.as_tensor(cached[name], device=device).to(dtype)

        U_mean, V_fixed, mr = load("U"), load("V_fixed"), load("mean_rating")
        if lead:
            print(f"loaded initial fit from {args.initial_fit_file}")
    else:
        if lead:
            print("running initial full fit on old items...")
        U_mean, V_fixed, mr = newitems.initial_full_fit(
            fold_in_name(args.seed, "initial-fit"), problem, is_new, cfg,
            num_samps=args.initial_fit_samps, dtype=dtype)
        if args.initial_fit_file and lead:
            np.savez(args.initial_fit_file, U=U_mean.cpu().numpy(),
                     V_fixed=V_fixed.cpu().numpy(),
                     mean_rating=mr.cpu().numpy())

    new_cols = np.nonzero(np.asarray(is_new, bool))[0]
    prob_new0 = newitems.new_item_problem(problem, is_new)
    real_new = real[:, new_cols]
    real_t = torch.as_tensor(real_new, device=device).to(dtype)
    n, m_new = prob_new0.shape
    bounds = tuple(rating_bounds(vals)) if vals else None

    def sample(k, st, prob):
        return newitems.samples(k, st, prob, cfg, args.samps, args.warmup)

    def stats_of(samps):
        return sample_stats.prediction_stats(
            samps["U"], samps["V"], mr, cfg.subtract_mean,
            cutoffs=_CUTOFFS, value_bounds=bounds)

    def score(kname, st_pair, prob, k):
        st, stats = st_pair
        if kname == "random":
            ev = torch.rand((n, m_new), generator=generator(k, device),
                            dtype=dtype, device=device)
        elif kname == "pred-variance":
            ev = stats.var
        elif kname == "pred":
            ev = stats.mean
        elif kname.startswith("prob-ge"):
            cutoff = {"prob-ge-3.5": 3.5, "prob-ge-.5": 0.5,
                      "prob-ge-0": 0.0}[kname]
            ev = stats.prob_ge[_CUTOFFS.index(cutoff)]
        else:  # exp-variance / exp-entropy-est
            stat = ("total-variance" if kname == "exp-variance"
                    else "entropy-est")
            cand = torch.nonzero(prob.queryable.flatten())[:, 0]

            def score_flat(c, kk):
                return newitems.lookahead_scores(
                    kk, st, prob, cfg, stats, vals, stat=stat,
                    num_samps=args.lookahead_samps,
                    warmup=args.lookahead_warmup, n_base_samples=args.samps,
                    cand=c, candidate_tile=args.lookahead_tile)

            ev = sharded_candidate_scores(score_flat, n * m_new, mesh,
                                          cand)(k).reshape(n, m_new)
        return (torch.where(prob.queryable, ev, torch.nan),
                kname not in _MINIMIZE)

    def refit(st_pair, prob, k):
        st, _ = st_pair
        st, samps = sample(k, newitems.invalidate_mode(st), prob)
        return st, stats_of(samps)

    st0 = newitems.init_state(prob_new0, U_mean, V_fixed, cfg, mr,
                              dtype=dtype)
    st0, samps0 = sample(fold_in_name(args.seed, "chain"), st0, prob_new0)
    stats0 = stats_of(samps0)

    ckpt = LoopCheckpointer.for_problem(
        args.checkpoint, prob_new0, real_new, every=20, era=SAMPLER_ERA,
        write=lead)
    family = Family(
        nice_name=lambda kname: kname,
        score=score,
        refit=refit,
        err=lambda st_pair, prob: metrics.rmse_on(st_pair[1].mean, real_t,
                                                  prob.test),
    )
    per_key = drive_active(prob_new0, real_new, key_names, family,
                           (st0, stats0), args.seed, steps=args.steps,
                           ckpt=ckpt, verbose=args.verbose and lead,
                           mesh=mesh)

    results = {
        "_real": real,
        "_ratings": data["_ratings"],
        "_rating_vals": vals or None,
        "_is_new_item": np.asarray(is_new),
    }
    # picks are made in the new-item submatrix; report original column ids
    # like the reference (jigger_ratings inverse, bpmf_newitems.py:41-45)
    for kname, recs in per_key.items():
        results[kname] = [
            rec if rec[2] is None
            else rec[:2] + ((rec[2][0], int(new_cols[rec[2][1]])),) + rec[3:]
            for rec in recs
        ]

    if args.save_results and lead:
        print(f"\nsaving results in '{args.save_results}'")
        results["_kind"] = "stan"
        results["_args"] = vars(args)
        results["_sampler_era"] = SAMPLER_ERA
        with open(args.save_results, "wb") as f:
            pickle.dump(results, f)
    return results


if __name__ == "__main__":
    main()
