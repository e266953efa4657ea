"""CLI: criterion-agreement analysis across model families.
(the port's copy of ``amf_tpu/run/compare_firsts.py``; host code, no device).

Mirrors the reference ``compare_firsts.py`` (:133-170): pairwise Kendall-tau
rank agreement (and RMS distance) between the first-step criterion maps of
independent implementations on the same data — the reference's strongest
cross-implementation correctness signal, reused here to validate this
framework against reference outputs or across our own model families.
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np

from amf_tpu_torch.analysis import results as R


def _load_arm(dirname, name):
    """First-step eval source for one family in one replicate dir: the raw
    results pickle if present, else the committed digest."""
    import gzip
    import json
    import os

    pkl = os.path.join(dirname, f"results_{name}.pkl")
    if os.path.exists(pkl):
        return R.load_results(pkl)
    dg = os.path.join(dirname, f"digest_{name}.json.gz")
    if os.path.exists(dg):
        with gzip.open(dg, "rt") as f:
            return R.results_from_digest(json.load(f))
    return None


def _first_map(res, key):
    for k in (key, *(p + key for p in
                     ("stan_", "bayes_", "mmmf_", "rc_", "apmf_", "mnpmf_"))):
        if k in res and isinstance(res[k], list):
            ev = R.first_step_evals(res[k])
            if ev is not None:
                return np.asarray(ev, float)
    return None


def _violin_grid(vals, names, title, path):
    """Distribution grid over replicates for each family pair (reference
    compare_firsts.beanplot_grid :64-92; statsmodels beanplot -> matplotlib
    violinplot). Upper triangle; degenerate distributions drawn as a line."""

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = vals.shape[1]
    fig, axes = plt.subplots(n, n, figsize=(2.2 * n, 2.2 * n),
                             sharex=True, sharey=True, squeeze=False)
    fig.suptitle(title)
    for i in range(n):
        for j in range(n):
            axes[i][j].set_visible(False)
    for i, j in itertools.combinations_with_replacement(range(n), 2):
        ax = axes[i][j]
        ax.set_visible(True)
        data = vals[:, i, j]
        data = data[np.isfinite(data)]
        if data.size == 0:
            continue
        if np.ptp(data) == 0:
            ax.hlines(data[0], 0.85, 1.15, lw=0.8, color="k")
        else:
            ax.violinplot([data], showmedians=True)
        ax.set_xticks(())
        if i == 0:
            ax.set_title(names[j], fontsize=7)
        if j == i:
            ax.set_ylabel(names[i], fontsize=7)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {path}")


def _grid_mode(args):
    """Reference multi-dir mode (compare_firsts.py:155-165): per replicate
    dir, pairwise Kendall tau / z-normalized RMS between the named families'
    first-step maps of one criterion; violin grids over replicates."""
    import os

    from scipy import stats

    names = args.names
    taus, rmses, used = [], [], []
    for d in args.results_files:
        maps = {}
        for name in names:
            res = _load_arm(d, name)
            if res is None:
                break
            ev = _first_map(res, args.grid_key)
            if ev is None:
                break
            maps[name] = ev
        if len(maps) < len(names):
            print(f"skipping {d}: missing an arm/map")
            continue
        nn = len(names)
        tau = np.full((nn, nn), np.nan)
        rms = np.full((nn, nn), np.nan)
        # upper triangle only — the grid is symmetric and the plot only
        # reads i<=j, so the full nn x nn loop would double the
        # O(n log n)-per-pair tau work
        for i, j in itertools.combinations_with_replacement(range(nn), 2):
            ea, eb = maps[names[i]], maps[names[j]]
            if ea.shape != eb.shape:
                continue
            ok = np.isfinite(ea) & np.isfinite(eb)
            if ok.sum() < 8:
                continue
            tau[i, j] = tau[j, i] = stats.kendalltau(
                ea[ok], eb[ok])[0]
            za = (ea[ok] - ea[ok].mean()) / (ea[ok].std() + 1e-12)
            zb = (eb[ok] - eb[ok].mean()) / (eb[ok].std() + 1e-12)
            rms[i, j] = rms[j, i] = np.sqrt(np.mean((za - zb) ** 2))
        taus.append(tau)
        rmses.append(rms)
        used.append(d)
    if not taus:
        print("no replicate dir had all requested arms")
        return
    os.makedirs(args.outdir, exist_ok=True)
    key = args.grid_key.replace("/", "_")
    _violin_grid(np.asarray(taus), names,
                 f"Kendall's tau ({args.grid_key}, {len(used)} replicates)",
                 os.path.join(args.outdir, f"tau_grid_{key}.png"))
    _violin_grid(np.asarray(rmses), names,
                 f"RMS distance ({args.grid_key}, {len(used)} replicates)",
                 os.path.join(args.outdir, f"rms_grid_{key}.png"))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("results_files", nargs="+",
                        help="results pickles; or replicate DIRS with "
                             "--grid-key")
    parser.add_argument("--keys", nargs="*", default=None,
                        help="criterion keys to compare (default: all shared)")
    parser.add_argument("--grid-key", default=None, metavar="KEY",
                        help="violin-grid mode over replicate dirs "
                             "(reference beanplot_grid, :64-92): one "
                             "criterion, --names families, each positional "
                             "arg a replicate dir")
    parser.add_argument("--names", nargs="*",
                        default=("bayes", "stan"),
                        help="family stems for --grid-key mode")
    parser.add_argument("--outdir", default="plots")
    args = parser.parse_args(argv)

    if args.grid_key:
        _grid_mode(args)
        return

    loaded = [R.load_results(p) for p in args.results_files]
    all_keys = set()
    for res in loaded:
        all_keys |= {
            k for k, v in res.items()
            if not k.startswith("_") and isinstance(v, list)
        }
    keys = args.keys or sorted(all_keys)

    taus = R.compare_first_steps(loaded, keys)
    if not taus:
        print("no comparable first-step criterion maps found")
        return

    print(f"{'pair':<60} {'kendall_tau':>12} {'rms_dist':>10}")
    maps = {}
    for res in loaded:
        for key in keys:
            if key in res:
                ev = R.first_step_evals(res[key])
                if ev is not None:
                    maps[key] = ev
    for (a, b), tau in sorted(taus.items()):
        ea, eb = maps[a], maps[b]
        ok = np.isfinite(ea) & np.isfinite(eb)
        # normalize scales before RMS distance (criteria have different units)
        za = (ea[ok] - ea[ok].mean()) / (ea[ok].std() + 1e-12)
        zb = (eb[ok] - eb[ok].mean()) / (eb[ok].std() + 1e-12)
        rms = float(np.sqrt(np.mean((za - zb) ** 2)))
        print(f"{a + ' vs ' + b:<60} {tau:>12.4f} {rms:>10.4f}")


if __name__ == "__main__":
    main()
