"""CLI: per-cell RMSE improvement from adding each candidate rating
(mirrors ``amf_tpu/run/add_rmse_boosts.py``).

For every queryable cell: add its TRUE rating, refit the MAP factors, and
record the change in test RMSE. The candidates are refit in tiles of lanes
by ``models/pmf.fit_lookahead_batch`` (on the card, the value+gradient CUDA
kernel). Same flags and results pickle as the JAX package's CLI, plus
``--device``:

    python -m amf_tpu_torch.run.add_rmse_boosts --load-data data.npz -D 10 --tile 128
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

from amf_tpu_torch.models import pmf
from amf_tpu_torch.types import Problem

# lanes whose (n, m) prediction is formed at once when scoring a tile
RMSE_CHUNK = 8


def masked_rmse(pred: torch.Tensor, real: torch.Tensor, test: torch.Tensor
                ) -> torch.Tensor:
    """RMSE of ``pred`` (..., n, m) against ``real`` on the ``test`` cells."""
    err = torch.where(test, pred - real, 0.0)
    return torch.sqrt((err * err).sum(dim=(-2, -1))
                      / test.sum().clamp(min=1))


def tile_rmses(
    state: pmf.PMFState, problem: Problem, cfg: pmf.PMFConfig,
    real: torch.Tensor, di: torch.Tensor, dj: torch.Tensor, dv: torch.Tensor,
    max_steps: int, use_pallas: bool = True,
) -> torch.Tensor:
    """(L,) test RMSE after refitting each lane with its rating added.

    The prediction U_l V_l^T of each lane is formed ``RMSE_CHUNK`` lanes at
    a time, so the (L, n, m) tensor of a whole tile is never held.
    """
    U, V, _ = pmf.fit_lookahead_batch(
        state, problem, di, dj, dv, cfg, max_steps=max_steps,
        use_pallas=use_pallas)
    return torch.cat([
        masked_rmse(U[s:s + RMSE_CHUNK] @ V[s:s + RMSE_CHUNK].mT, real,
                    problem.test)
        for s in range(0, U.shape[0], RMSE_CHUNK)])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--load-data", required=True)
    parser.add_argument("--latent-d", "-D", type=int, default=5,
                        help="factor width; on the card the CUDA kernels take "
                             "d <= 32 and a wider d raises (--device cpu "
                             "runs any width)")
    parser.add_argument("--refit-steps", type=int, default=200)
    parser.add_argument("--tile", type=int, default=128)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-pallas", action="store_false", dest="use_pallas",
                        default=True,
                        help="refit with the plain PyTorch version instead of "
                             "the CUDA kernel")
    parser.add_argument("--out", default="rmse_boosts.pkl")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; there is no fallback")
    args = parser.parse_args(argv)

    from amf_tpu_torch import types
    from amf_tpu_torch.data.loaders import load_npz_schema
    from amf_tpu_torch.utils.platform import resolve_device
    from amf_tpu_torch.utils.rng import generator

    device = resolve_device(args.device)
    print(f"device: {device}")

    data = load_npz_schema(args.load_data)
    real = data["_real"]
    prob = types.problem_from_ratings(
        data["_ratings"], real=real, test=data.get("_test_on"),
        dtype=torch.float32, device=device)
    n, m = prob.shape
    cfg = pmf.PMFConfig(latent_d=args.latent_d)
    st = pmf.init_state(generator(args.seed, device), n, m, cfg, prob,
                        dtype=torch.float32, device=device)
    st, _ = pmf.fit(st, prob, cfg)

    real_t = torch.as_tensor(real, dtype=torch.float32, device=device)
    r0 = float(masked_rmse(pmf.predicted_matrix(st, cfg), real_t, prob.test))

    # pad the candidate list to a whole number of tiles
    qq = np.nonzero(prob.queryable.cpu().numpy().ravel())[0]
    pad = (-len(qq)) % args.tile
    cand = np.concatenate([qq, np.zeros(pad, qq.dtype)])
    valid = np.concatenate([np.ones(len(qq), bool), np.zeros(pad, bool)])
    print(f"base test RMSE: {r0:.5f}; scoring {len(qq)} candidates "
          f"in tiles of {args.tile}")

    boosts = np.full((n, m), np.nan)
    for t in range(len(cand) // args.tile):
        s = slice(t * args.tile, (t + 1) * args.tile)
        di = torch.as_tensor(cand[s] // m, device=device)
        dj = torch.as_tensor(cand[s] % m, device=device)
        dv = real_t[di, dj]  # the TRUE value of each candidate cell
        rmses = tile_rmses(st, prob, cfg, real_t, di, dj, dv,
                           args.refit_steps, args.use_pallas).cpu().numpy()
        for c, ok, r in zip(cand[s], valid[s], rmses):
            if ok:
                boosts[c // m, c % m] = r0 - r

    with open(args.out, "wb") as f:
        pickle.dump({"_real": real, "base_rmse": r0, "boosts": boosts}, f)
    finite = boosts[np.isfinite(boosts)]
    if finite.size:
        print(f"wrote {args.out}; boost mean {finite.mean():.5f}, "
              f"max {finite.max():.5f}")
    else:
        print(f"wrote {args.out}; no queryable cells")


if __name__ == "__main__":
    main()
