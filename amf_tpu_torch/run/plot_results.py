"""CLI: results plotting/reporting (headless).
(the port's copy of ``amf_tpu/run/plot_results.py``; host code, no device).

Mirrors the reference ``plot_results.py`` (:374-523): RMSE curves, per-step
criterion heatmaps, first-step criterion grids, count->=cutoff discovery
curves, plus a text summary mode. Writes files (Agg backend) instead of
opening windows.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from amf_tpu_torch.analysis import results as R


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("results_file", nargs="+")
    parser.add_argument("--kind", choices=R.KINDS, default=None)
    parser.add_argument("--outdir", default="plots")
    parser.add_argument("--rmses", action="store_true", help="plot RMSE curves")
    parser.add_argument("--criteria-firsts", action="store_true",
                        help="grid of first-step criterion maps")
    parser.add_argument("--criteria-over-time", action="store_true",
                        help="per-criterion grid of per-step eval heatmaps "
                             "with the picked cell marked (reference "
                             "plot_results.py:222-283)")
    parser.add_argument("--max-steps-plotted", type=int, default=64,
                        help="with --criteria-over-time: cap the grid size "
                             "(the reference plots every step; long sweeps "
                             "subsample evenly)")
    parser.add_argument("--ge-cutoff", type=float, default=None,
                        help="discovery curves of values >= cutoff")
    parser.add_argument("--aucs", action="store_true",
                        help="print area-under-RMSE-curve table")
    parser.add_argument("--summary", action="store_true", default=True)
    args = parser.parse_args(argv)

    loaded = [R.load_results(p, args.kind) for p in args.results_file]
    merged = loaded[0]
    for extra in loaded[1:]:
        merged = R.merge_results(merged, extra)

    crit_keys = sorted(
        k for k, v in merged.items() if not k.startswith("_") and isinstance(v, list)
    )

    if args.summary:
        print(f"{'criterion':<36} {'steps':>6} {'rmse0':>9} {'rmse_end':>9}")
        for k in crit_keys:
            ns, errs = R.rmse_curve(merged[k])
            name = R.KEY_NAMES.get(k, k)
            print(f"{name:<36} {len(ns) - 1:>6} {errs[0]:>9.5f} {errs[-1]:>9.5f}")

    if args.aucs:
        print("\narea under RMSE curve (lower is better):")
        for k, v in sorted(R.aucs(merged).items(), key=lambda kv: kv[1]):
            print(f"  {R.KEY_NAMES.get(k, k):<36} {v:.4f}")

    needs_plots = (args.rmses or args.criteria_firsts
                   or args.criteria_over_time or args.ge_cutoff is not None)
    if not needs_plots:
        return

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(args.outdir, exist_ok=True)

    if args.rmses:
        fig, ax = plt.subplots(figsize=(8, 5))
        for k in crit_keys:
            ns, errs = R.rmse_curve(merged[k])
            ax.plot(ns, errs, label=R.KEY_NAMES.get(k, k))
        ax.set_xlabel("# rated")
        ax.set_ylabel("RMSE")
        ax.legend(fontsize=7)
        path = os.path.join(args.outdir, "rmses.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        print(f"wrote {path}")

    if args.criteria_firsts:
        maps = {k: R.first_step_evals(merged[k]) for k in crit_keys}
        maps = {k: v for k, v in maps.items() if v is not None}
        if maps:
            cols = min(len(maps), 4)
            rows = (len(maps) + cols - 1) // cols
            fig, axes = plt.subplots(
                rows, cols, figsize=(3 * cols, 3 * rows), squeeze=False
            )
            for ax, (k, ev) in zip(axes.ravel(), sorted(maps.items())):
                im = ax.imshow(ev, interpolation="nearest")
                ax.set_title(R.KEY_NAMES.get(k, k), fontsize=7)
                ax.axis("off")
                fig.colorbar(im, ax=ax, fraction=0.046)
            for ax in axes.ravel()[len(maps):]:
                ax.axis("off")
            path = os.path.join(args.outdir, "criteria_firsts.png")
            fig.savefig(path, dpi=120, bbox_inches="tight")
            print(f"wrote {path}")

    if args.criteria_over_time:
        # reference plot_criteria_over_time (plot_results.py:222-283): one
        # panel per active step showing that step's criterion map with the
        # chosen cell marked; shared color scale across steps
        for k in crit_keys:
            recs = merged[k]
            steps = [(r[0], r[2], np.asarray(r[3], float))
                     for r in recs
                     if r[2] is not None and len(r) > 3 and r[3] is not None
                     and np.isfinite(np.asarray(r[3], float)).any()]
            if not steps:
                continue
            if len(steps) > args.max_steps_plotted:
                idx = np.linspace(0, len(steps) - 1,
                                  args.max_steps_plotted).astype(int)
                steps = [steps[i] for i in idx]
            cols = int(np.ceil(np.sqrt(len(steps))))
            rows = (len(steps) + cols - 1) // cols
            finite = np.concatenate(
                [ev[np.isfinite(ev)].ravel() for _, _, ev in steps])
            vmin, vmax = float(finite.min()), float(finite.max())
            fig, axes = plt.subplots(
                rows, cols, figsize=(2.2 * cols, 2.2 * rows), squeeze=False)
            im = None
            for ax, (n, ij, ev) in zip(axes.ravel(), steps):
                im = ax.imshow(ev, interpolation="nearest",
                               vmin=vmin, vmax=vmax)
                # mark the selected point (imshow x=col, y=row)
                ax.scatter(ij[1], ij[0], marker="s", facecolors="none",
                           edgecolors="white", s=40, linewidths=1.2)
                ax.set_title(f"n={n}", fontsize=6)
                ax.set_xticks(())
                ax.set_yticks(())
            for ax in axes.ravel()[len(steps):]:
                ax.axis("off")
            if im is not None:
                fig.colorbar(im, ax=axes, fraction=0.02)
            safe = k.replace("/", "_")
            path = os.path.join(args.outdir, f"criteria_over_time_{safe}.png")
            fig.savefig(path, dpi=120, bbox_inches="tight")
            plt.close(fig)
            print(f"wrote {path}")

    if args.ge_cutoff is not None:
        fig, ax = plt.subplots(figsize=(8, 5))
        for k in crit_keys:
            ns, counts = R.count_ge_cutoff_curve(merged, k, args.ge_cutoff)
            ax.plot(ns, counts, label=R.KEY_NAMES.get(k, k))
        ax.set_xlabel("# rated")
        ax.set_ylabel(f"# found >= {args.ge_cutoff}")
        ax.legend(fontsize=7)
        path = os.path.join(args.outdir, "ge_cutoff.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
