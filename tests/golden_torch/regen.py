"""Regenerate the port's golden CLI records (tests/golden_torch/*.json).

Run from the repo root after an INTENTIONAL behavior change of the port:
    python tests/golden_torch/regen.py
then review the diff. The port's five family CLIs run with the arguments
of ``tests/golden/regen.py`` on ``tests/golden/golden_data.npz``, on the
CPU in float64, and each trace is digested as there: (n_rated, err, pick)
per step.

Which family is held to which file, and why:
  * mmmf: the JAX package's ``tests/golden/golden_mmmf.json``. The ADMM
    solves are deterministic and the port reproduces JAX's trace exactly.
  * apmf, bayes, stan: ``tests/golden_torch/golden_<family>.json``. Their
    traces rest on random draws (the MAP fit's uniform initial factors,
    the variational normal's initial noise, the Gibbs and NUTS chains) that
    the port takes from ``torch.Generator``s, which cannot replay JAX's
    keys: the initial errors already differ.
  * rc: ``tests/golden_torch/golden_rc.json``. The run is deterministic,
    but at step 1 cells (3, 5) and (5, 3) of this symmetric 6 x 6 problem
    tie (38.237835679806 in both packages, to 4e-14), so the pick follows
    the last bit of the score: JAX takes (5, 3) and the port (3, 5), and
    the traces part after it.
"""

import json
import os
import pickle
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "..", "golden", "golden_data.npz")
OWN = ("apmf", "bayes", "stan", "rc")  # the families with a file here


def records_digest(res, keys):
    out = {}
    for k in keys:
        out[k] = [
            {
                "n_rated": int(r[0]),
                "err": round(float(r[1]), 6),
                "pick": None if r[2] is None else [int(r[2][0]), int(r[2][1])],
            }
            for r in res[k]
        ]
    return out


def run_all(data, outdir):
    """Returns {family: digest}; shared by regen and the test."""
    from amf_tpu_torch.run import (active_mmmf, active_pmf, active_rc,
                                   bayes_pmf, bpmf)

    o = lambda name: os.path.join(outdir, name + ".pkl")
    cpu = ["--device", "cpu"]
    runs = {}

    active_pmf.main(cpu + [
        "--load-data", data, "-D", "2", "-s", "3", "--seed", "0",
        "--discrete-integration", "--no-verbose",
        "--save-results", o("apmf"), "pred-variance", "total-variance",
    ])
    runs["apmf"] = (o("apmf"), ["pred-variance", "total-variance"])

    bayes_pmf.main(cpu + [
        "--load-data", data, "-D", "2", "-s", "3", "-S", "16", "--seed", "0",
        "--lookahead-samps", "4", "--no-verbose",
        "--save-results", o("bayes"), "pred-variance", "exp-variance",
    ])
    runs["bayes"] = (o("bayes"), ["pred-variance", "exp-variance"])

    bpmf.main(cpu + [
        "--load-data", data, "-D", "2", "-s", "3", "-S", "12", "--seed", "0",
        "--warmup", "6", "--lookahead-samps", "4", "--lookahead-warmup", "2",
        "--no-verbose", "--save-results", o("stan"), "pred-variance",
    ])
    runs["stan"] = (o("stan"), ["pred-variance"])

    active_mmmf.main(cpu + [
        "--load-data", data, "--cutoff", "3.5", "-C", "1", "-s", "3",
        "--seed", "0", "--no-verbose", "--save-results", o("mmmf"),
        "min-margin",
    ])
    runs["mmmf"] = (o("mmmf"), ["mmmf_min-margin"])

    active_rc.main(cpu + [
        "--load-data", data, "--delta", "1.5", "-s", "3", "--seed", "0",
        "--no-verbose", "--save-results", o("rc"), "entropy",
    ])
    runs["rc"] = (o("rc"), ["rc_entropy"])

    digests = {}
    for fam, (path, keys) in runs.items():
        with open(path, "rb") as f:
            digests[fam] = records_digest(pickle.load(f), keys)
    return digests


def main():
    sys.path.insert(0, os.path.join(HERE, "..", ".."))
    import torch

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        digests = run_all(DATA, tmp)
    for fam in OWN:
        with open(os.path.join(HERE, f"golden_{fam}.json"), "w") as f:
            json.dump(digests[fam], f, indent=1, sort_keys=True)
        print(f"wrote golden_{fam}.json")


if __name__ == "__main__":
    main()
