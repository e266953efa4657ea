"""CLI: experiment split builder (reference: choose_training.py main :159-259).
(the port's copy of ``amf_tpu/run/choose_training.py``; numpy on the host).

Reads a dense matrix (.npy / gzipped .npy / .npz with _real), picks the
initially-known set, optional test set and new-item split, and writes the
reference npz schema.
"""

from __future__ import annotations

import argparse
import ast

import numpy as np

from amf_tpu_torch.data.loaders import load_dense_matrix, save_npz_schema
from amf_tpu_torch.data.splits import make_new_items_split, make_split
from amf_tpu_torch.run.generate import _DEVICE_HELP
from amf_tpu_torch.utils.platform import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("file")
    parser.add_argument("outfile")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--drugbank", action="store_true")
    parser.add_argument("--device", default="cuda", help=_DEVICE_HELP)

    new = parser.add_argument_group("New item options")
    new.add_argument("--know-all-old", action="store_true", default=False)
    g = new.add_mutually_exclusive_group()
    g.add_argument("--n-new-item", type=int, metavar="N")
    g.add_argument("--new-item-frac", type=float, metavar="FRAC")

    initial = parser.add_argument_group("Initially known set options")
    g = initial.add_mutually_exclusive_group()
    g.add_argument("--pick-no-extras", action="store_true")
    g.add_argument("--n-pick", type=int, metavar="N")
    g.add_argument("--pick-known-frac", type=float, metavar="FRAC", default=0.05)

    test = parser.add_argument_group("Test set options")
    g = test.add_mutually_exclusive_group()
    g.add_argument("--test-one-per-row-col", action="store_true", default=False)
    g.add_argument("--test-at-random", action="store_true", default=True)
    g.add_argument("--test-equal-classes", action="store_true", default=False)
    g.add_argument("--test-class-ratios", type=ast.literal_eval, default=None)
    g2 = test.add_mutually_exclusive_group()
    g2.add_argument("--n-test", type=int, metavar="N")
    g2.add_argument("--test-known-frac", type=float, metavar="FRAC")

    args = parser.parse_args(argv)
    resolve_device(args.device)
    rng = np.random.default_rng(args.seed)

    real = load_dense_matrix(args.file)
    if args.drugbank:
        real = real.astype(np.int8).astype(np.float64)
        real[real == 0] = -1

    n_new = args.n_new_item
    if not n_new and args.new_item_frac:
        n_new = int(np.round(real.shape[1] * args.new_item_frac))

    test_mode = "random"
    class_ratios = None
    if args.test_equal_classes:
        test_mode = "equal-classes"
    elif args.test_class_ratios:
        test_mode = "class-ratios"
        class_ratios = args.test_class_ratios
    elif args.test_one_per_row_col:
        test_mode = "one-per-row-col"

    if n_new:
        split = make_new_items_split(
            real, n_new=n_new, know_all_old=args.know_all_old,
            pick_no_extras=args.pick_no_extras,
            pick_known_frac=args.pick_known_frac,
            n_test=args.n_test, test_known_frac=args.test_known_frac, rng=rng,
        )
    else:
        split = make_split(
            real, pick_known_frac=args.pick_known_frac, n_pick=args.n_pick,
            pick_no_extras=args.pick_no_extras, drugbank=args.drugbank,
            n_test=args.n_test, test_known_frac=args.test_known_frac,
            test_mode=test_mode, class_ratios=class_ratios, rng=rng,
        )

    save_npz_schema(args.outfile, split)


if __name__ == "__main__":
    main()
