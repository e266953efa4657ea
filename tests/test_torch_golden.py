"""Golden-file CLI regression tests of the port (one per model family).

A fixed-seed tiny run of each of the port's five family CLIs
(``tests/golden_torch/regen.py``: the arguments of ``tests/golden/regen.py``
on ``tests/golden/golden_data.npz``, CPU, float64) must reproduce its
committed (n_rated, err, pick) trace exactly (errors to 2e-6, as in
``tests/test_golden.py``). Which family is held to which file, and why:

  * mmmf -> ``tests/golden/golden_mmmf.json``, the JAX package's own file:
    the ADMM trace is deterministic and the port reproduces it;
  * apmf, bayes, stan -> ``tests/golden_torch/golden_<family>.json``: their
    traces rest on random draws (the MAP fit's initial factors, the
    variational noise, the chains) that the port takes from
    ``torch.Generator``s, which cannot replay JAX's keys;
  * rc -> ``tests/golden_torch/golden_rc.json``: deterministic, but cells
    (3, 5) and (5, 3) tie at step 1 to the last bit, so the pick (and the
    trace after it) follows rounding; JAX's file records the other cell.
"""

import importlib.util
import json
import os

import pytest

import torch_threads  # noqa: F401  (one torch thread a worker)

HERE = os.path.dirname(os.path.abspath(__file__))
FILES = {
    "apmf": os.path.join(HERE, "golden_torch", "golden_apmf.json"),
    "bayes": os.path.join(HERE, "golden_torch", "golden_bayes.json"),
    "stan": os.path.join(HERE, "golden_torch", "golden_stan.json"),
    "mmmf": os.path.join(HERE, "golden", "golden_mmmf.json"),
    "rc": os.path.join(HERE, "golden_torch", "golden_rc.json"),
}


@pytest.fixture(scope="module")
def fresh_digests(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "golden_torch_regen", os.path.join(HERE, "golden_torch", "regen.py"))
    regen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(regen)
    assert set(regen.OWN) | {"mmmf"} == set(FILES)
    return regen.run_all(regen.DATA, str(tmp_path_factory.mktemp("golden")))


@pytest.mark.parametrize("family", sorted(FILES))
def test_golden_records(fresh_digests, family):
    with open(FILES[family]) as f:
        want = json.load(f)
    got = fresh_digests[family]
    assert set(got) == set(want), (set(got), set(want))
    for k in want:
        assert len(got[k]) == len(want[k]), (family, k)
        for step, (g, w) in enumerate(zip(got[k], want[k])):
            assert g["n_rated"] == w["n_rated"], (family, k, step)
            assert g["pick"] == w["pick"], (family, k, step, g, w)
            assert g["err"] == pytest.approx(w["err"], abs=2e-6), (
                family, k, step)


def test_rc_golden_parts_from_jax_only_at_the_tie(fresh_digests):
    """The port's RC trace equals JAX's up to the tied step-1 pick, which
    is the mirror cell of JAX's."""
    with open(os.path.join(HERE, "golden", "golden_rc.json")) as f:
        want = json.load(f)["rc_entropy"]
    got = fresh_digests["rc"]["rc_entropy"]
    assert got[0] == want[0]
    assert got[1]["n_rated"] == want[1]["n_rated"]
    assert got[1]["pick"] == want[1]["pick"][::-1] != want[1]["pick"]
