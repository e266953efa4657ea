"""CLI: aggregate area-under-learning-curve comparisons across many runs.
(the port's copy of ``amf_tpu/run/plot_aucs.py``; host code, no device).

Mirrors the reference ``plot_aucs.py`` (:19-130, 382 LoC): loads many results
files, computes per-criterion RMSE traces, areas under the learning curves,
and the rmse-vs-random normalization; prints a table and optionally writes
aggregate plots.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np

from amf_tpu_torch.analysis import results as R
from amf_tpu_torch.analysis.metrics import area_under_curve


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("results_files", nargs="+")
    parser.add_argument("--kind", choices=R.KINDS, default=None)
    parser.add_argument("--outdir", default=None, help="write aggregate plots")
    parser.add_argument("--vs-random", action="store_true",
                        help="normalize AUCs by each run's random-criterion AUC")
    args = parser.parse_args(argv)

    per_key = defaultdict(list)  # key -> [auc per run]
    per_key_final = defaultdict(list)  # key -> [final rmse per run]
    curves = defaultdict(list)

    for path in args.results_files:
        res = R.load_results(path, args.kind)
        aucs = R.aucs(res)
        # per-kind random AUCs: 'bayes_random' normalizes 'bayes_*' etc.
        rand_by_prefix = {
            k[: -len("random")]: v for k, v in aucs.items()
            if k == "random" or k.endswith("_random")
        }
        for k, v in aucs.items():
            if args.vs_random:
                prefix = k.rsplit("_", 1)[0] + "_" if "_" in k else ""
                rand_auc = rand_by_prefix.get(prefix) or rand_by_prefix.get("")
                if rand_auc:
                    v = v / rand_auc
            per_key[k].append(v)
            ns, errs = R.rmse_curve(res[k])
            per_key_final[k].append(errs[-1])
            curves[k].append((ns, errs))

    unit = "auc/random-auc" if args.vs_random else "auc"
    print(f"{'criterion':<36} {'runs':>5} {unit + ' mean':>14} "
          f"{'std':>9} {'final rmse':>11}")
    for k in sorted(per_key, key=lambda k: np.mean(per_key[k])):
        v = np.asarray(per_key[k])
        fr = np.asarray(per_key_final[k])
        print(f"{R.KEY_NAMES.get(k, k):<36} {len(v):>5} {v.mean():>14.4f} "
              f"{v.std():>9.4f} {fr.mean():>11.5f}")

    if args.outdir:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(args.outdir, exist_ok=True)
        fig, ax = plt.subplots(figsize=(8, 5))
        for k, runs in sorted(curves.items()):
            # align on the shortest run
            L = min(len(ns) for ns, _ in runs)
            errs = np.mean([e[:L] for _, e in runs], axis=0)
            ax.plot(runs[0][0][:L], errs, label=R.KEY_NAMES.get(k, k))
        ax.set_xlabel("# rated")
        ax.set_ylabel("mean RMSE across runs")
        ax.legend(fontsize=7)
        path = os.path.join(args.outdir, "aucs_mean_curves.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        print(f"\nwrote {path}")


if __name__ == "__main__":
    main()
