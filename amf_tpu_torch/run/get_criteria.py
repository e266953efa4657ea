"""CLI: one-shot criterion-map harness on PyTorch
(mirrors ``amf_tpu/run/get_criteria.py``).

Mirrors the reference ``get_criteria.py`` (:67-110): make (or load) a small
dataset, run the variational active-PMF and the Gibbs BPMF for a couple of
steps, write both results pickles and print the pairwise Kendall-tau of
their first-step criterion maps. Same flags as the JAX package's CLI, plus
``--device``; float64 throughout, as there. On the card the Gibbs chains
draw their rows through the Cholesky kernel.

    python -m amf_tpu_torch.run.get_criteria --outdir criteria_out
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--load-data", default=None)
    parser.add_argument("--num-users", "-N", type=int, default=10)
    parser.add_argument("--num-items", "-M", type=int, default=10)
    parser.add_argument("--rank", "-R", type=int, default=2)
    parser.add_argument("--latent-d", "-D", type=int, default=2)
    parser.add_argument("--steps", "-s", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--apmf-keys", nargs="*",
                        default=["pred-variance", "total-variance"])
    parser.add_argument("--bayes-keys", nargs="*",
                        default=["pred-variance", "prob-ge-3.5"])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; there is no fallback")
    parser.add_argument("--outdir", default="criteria_out")
    args = parser.parse_args(argv)

    from amf_tpu_torch import convert, types
    from amf_tpu_torch.active import gibbs_loop, loop
    from amf_tpu_torch.analysis import results as R
    from amf_tpu_torch.data.loaders import load_npz_schema
    from amf_tpu_torch.data.synthetic import make_fake_data
    from amf_tpu_torch.utils.platform import setup as platform_setup

    device, dtype = platform_setup(use_x64=True, device=args.device)

    os.makedirs(args.outdir, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    if args.load_data:
        data = load_npz_schema(args.load_data)
        real = data["_real"]
        vals = tuple(data.get("_rating_vals", ())) or ()
        prob = types.problem_from_ratings(
            data["_ratings"], real=real, dtype=dtype, device=device)
    else:
        real, known, vals = make_fake_data(
            num_users=args.num_users, num_items=args.num_items,
            rank=args.rank, data_type=5, mask_type="diag", rng=rng,
        )
        prob = types.problem_from_dense(real, known, dtype=dtype,
                                        device=device)

    res_apmf = loop.run_active_pmf(
        prob, real, args.apmf_keys, latent_d=args.latent_d,
        rating_values=vals, discrete_exp=True, steps=args.steps,
        seed=args.seed, dtype=dtype, device=device,
    )
    # the initial snapshot as numpy arrays, as the active_pmf CLI saves it
    pst, ast = res_apmf["_initial_state"]
    res_apmf["_initial_state"] = (
        convert.to_numpy(pst), None if ast is None else convert.to_numpy(ast))
    res_apmf["_kind"] = "apmf"
    res_bayes = gibbs_loop.run_active_gibbs(
        prob, real, args.bayes_keys, latent_d=args.latent_d,
        rating_values=vals, num_samps=64, steps=args.steps, seed=args.seed,
        dtype=dtype, device=device,
    )
    res_bayes["_kind"] = "bayes"

    for name, res in [("apmf", res_apmf), ("bayes", res_bayes)]:
        path = os.path.join(args.outdir, f"results_{name}.pkl")
        with open(path, "wb") as f:
            pickle.dump(res, f)
        print(f"wrote {path}")

    # print pairwise first-step agreement (compare_firsts methodology)
    loaded = [R.load_results(os.path.join(args.outdir, f"results_{n}.pkl"))
              for n in ("apmf", "bayes")]
    keys = [k for res in loaded for k in res if not k.startswith("_")]
    taus = R.compare_first_steps(loaded, keys)
    for (a, b), tau in sorted(taus.items()):
        print(f"kendall-tau {a} vs {b}: {tau:.4f}")


if __name__ == "__main__":
    main()
