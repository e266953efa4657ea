"""CLI: dump Gibbs factor samples after a MAP fit, on PyTorch
(mirrors ``amf_tpu/run/get_samples.py``).

Mirrors the reference ``get_samples.py`` (:45-63): fit the MAP estimate
(optionally by minibatch SGD) then run the Gibbs chain, saving the sampled
U, V factors for offline analysis. Same flags and ``npz`` keys as the JAX
package's CLI, plus ``--device``; on the card every row draw goes through
the Cholesky kernel (``ops/chol_kernel.chol_gram_solve_sample``).

    python -m amf_tpu_torch.run.get_samples --load-data data.npz -S 128
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--load-data", required=True)
    parser.add_argument("--latent-d", "-D", type=int, default=5)
    parser.add_argument("--samps", "-S", type=int, default=2000)
    parser.add_argument("--fit", default="batch",
                        help="fit type, e.g. 'batch' or 'mini-valid,100,50'")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--float32", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; there is no fallback")
    parser.add_argument("--out", default="samples.npz")
    args = parser.parse_args(argv)

    from amf_tpu_torch import types
    from amf_tpu_torch.data.loaders import load_npz_schema
    from amf_tpu_torch.models import bpmf_gibbs, pmf
    from amf_tpu_torch.utils.platform import setup as platform_setup
    from amf_tpu_torch.utils.rng import fold_in, generator

    device, dtype = platform_setup(use_x64=not args.float32, device=args.device)

    data = load_npz_schema(args.load_data)
    real = data["_real"]
    prob = types.problem_from_ratings(data["_ratings"], real=real, dtype=dtype,
                                      device=device)
    n, m = prob.shape

    cfg = pmf.PMFConfig(latent_d=args.latent_d, subtract_mean=True)
    st = pmf.init_state(generator(args.seed, device), n, m, cfg, prob,
                        dtype=dtype, device=device)
    st = pmf.do_fit(st, prob, cfg, fit_type=pmf.parse_fit_type(args.fit),
                    generator=generator(args.seed, device))
    print(f"MAP fit done; ll = {float(pmf.log_likelihood(st, prob, cfg)):.2f}")

    gcfg = bpmf_gibbs.GibbsConfig(latent_d=args.latent_d, subtract_mean=True)
    chain = bpmf_gibbs.init_chain(st)
    _, _, (U, V) = bpmf_gibbs.run_chain(
        chain, prob, gcfg, args.samps,
        generator=generator(fold_in(args.seed, 1), device), keep_samples=True)
    np.savez_compressed(
        args.out, U=U.cpu().numpy(), V=V.cpu().numpy(),
        mean_rating=float(chain.mean_rating),
    )
    print(f"wrote {args.out}: U {tuple(U.shape)}, V {tuple(V.shape)}")


if __name__ == "__main__":
    main()
