"""CLI: synthetic discrete low-rank dataset generator.
(the port's copy of ``amf_tpu/run/generate.py``; numpy on the host).

Mirrors the reference ``generate.py main()`` (:105-146): diag-known mask,
exact positive counts in known/unknown partitions, pickled reference schema.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from amf_tpu_torch.data.synthetic import DEF_VALS, gen_known_diag_counts, known_diag
from amf_tpu_torch.utils.platform import resolve_device

_DEVICE_HELP = ("cuda (default) or cpu, as in every port entry point: the "
                "data are drawn with numpy on the host either way, and "
                "without a card 'cuda' stops the run here")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--rows", "-m", type=int, required=True)
    parser.add_argument("--cols", "-n", type=int, required=True)
    parser.add_argument("--rank", "-r", type=int, required=True)
    parser.add_argument("--known-pos", "-k", type=int, required=True)
    parser.add_argument("--unknown-pos", "-K", type=int, required=True)
    parser.add_argument("--cutoff", "-c", type=float, default=4)
    parser.add_argument("--prob", "-p", type=float, nargs="+", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    parser.add_argument("outfile")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    dirname = os.path.dirname(args.outfile)
    if dirname:
        os.makedirs(dirname, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    real = gen_known_diag_counts(
        m=args.rows, n=args.cols, rank=args.rank,
        known_pos=args.known_pos, unknown_pos=args.unknown_pos,
        vals=DEF_VALS, probs=args.prob, cutoff=args.cutoff, rng=rng,
    )
    known = known_diag(args.rows, args.cols)
    ii, jj = np.nonzero(known)
    ratings = np.stack([ii, jj, real[ii, jj]], axis=1).astype(np.float64)

    data = {"_real": real, "_ratings": ratings, "_rating_vals": DEF_VALS}
    with open(args.outfile, "wb") as f:
        pickle.dump(data, f)


if __name__ == "__main__":
    main()
