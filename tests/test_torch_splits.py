"""The port's numpy-only data helpers (amf_tpu_torch/data/splits.py,
extractors.py, loaders.load_dense_matrix, synthetic.known_diag and
gen_known_diag_counts) against the JAX package's: the same seeded inputs
give equal outputs. The extractors run on tiny synthetic files; no
reference data is read.
"""

import bz2
import gzip

import numpy as np
import pytest

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu.data import extractors as jext
from amf_tpu.data import loaders as jload
from amf_tpu.data import splits as jsplits
from amf_tpu.data import synthetic as jsyn
from amf_tpu_torch.data import extractors as text
from amf_tpu_torch.data import loaders as tload
from amf_tpu_torch.data import splits as tsplits
from amf_tpu_torch.data import synthetic as tsyn


def _real(seed=0, n=12, m=10, zeros=0.2):
    rng = np.random.default_rng(seed)
    real = rng.integers(1, 6, size=(n, m)).astype(float)
    real[rng.random((n, m)) < zeros] = 0.0
    return real


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


SPLIT_CALLS = {
    "pick_ratings": lambda mod, real: mod.pick_ratings(
        real != 0, 30, rng=1),
    "pick_ratings_no_extras": lambda mod, real: mod.pick_ratings(
        real != 0, None, rng=2),
    "pick_ratings_drugbank": lambda mod, real: mod.pick_ratings_drugbank(
        np.where(real > 3, 1.0, -1.0), 40, rng=3),
    "choose_test_set": lambda mod, real: mod.choose_test_set(
        real, np.eye(*real.shape, dtype=bool), 20, rng=4),
    "choose_test_set_one_per_row_col": lambda mod, real: mod.choose_test_set(
        real, np.eye(*real.shape, dtype=bool), 20, "one-per-row-col", rng=5),
    "choose_test_set_equal_classes": lambda mod, real: mod.choose_test_set(
        real, np.eye(*real.shape, dtype=bool), 20, "equal-classes", rng=6),
    "choose_test_set_class_ratios": lambda mod, real: mod.choose_test_set(
        real, np.eye(*real.shape, dtype=bool), 20, "class-ratios",
        class_ratios={1.0: .1, 2.0: .2, 3.0: .3, 4.0: .2, 5.0: .2}, rng=7),
    "make_split": lambda mod, real: mod.make_split(
        real, pick_known_frac=0.3, test_known_frac=0.2, rng=8),
    "make_split_drugbank": lambda mod, real: mod.make_split(
        np.where(real > 3, 1.0, -1.0), n_pick=40, drugbank=True, n_test=10,
        rng=9),
    "make_split_no_extras": lambda mod, real: mod.make_split(
        real, pick_no_extras=True, n_test=15, test_mode="equal-classes",
        rng=10),
    "make_new_items_split": lambda mod, real: mod.make_new_items_split(
        real, 3, test_known_frac=0.3, rng=11),
    "make_new_items_split_know_old": lambda mod, real: mod.make_new_items_split(
        real, 4, know_all_old=True, pick_no_extras=False,
        pick_known_frac=0.5, n_test=5, rng=12),
    "make_split_header": lambda mod, real: mod.make_split_header(
        real, real != 0),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CALLS))
def test_splits_equal_jax(name):
    real = _real()
    _equal(SPLIT_CALLS[name](tsplits, real), SPLIT_CALLS[name](jsplits, real))


def test_split_errors_equal_jax():
    real = _real()
    for mod in (tsplits, jsplits):
        with pytest.raises(ValueError, match="larger than testable"):
            mod.choose_test_set(real, real != 0, 10_000, rng=0)
        with pytest.raises(ValueError, match="exceeds num_to_pick"):
            mod.pick_ratings(real != 0, 1, rng=0)


def test_known_diag_and_counts_equal_jax():
    for m, n in ((4, 6), (6, 4), (5, 5)):
        _equal(tsyn.known_diag(m, n), jsyn.known_diag(m, n))
    kw = dict(m=6, n=6, rank=2, known_pos=2, unknown_pos=12, rng=3)
    want = jsyn.gen_known_diag_counts(**kw)
    _equal(tsyn.gen_known_diag_counts(**kw), want)
    assert (want[jsyn.known_diag(6, 6)] >= 4).sum() == 2


def test_load_dense_matrix_equals_jax(tmp_path):
    a = _real(seed=1)
    plain, packed = tmp_path / "a.npy", tmp_path / "a.npy.gz"
    np.save(plain, a)
    with gzip.GzipFile(packed, "wb") as f:
        np.save(f, a)
    for path in (plain, packed):
        _equal(tload.load_dense_matrix(str(path)),
               jload.load_dense_matrix(str(path)))
        _equal(tload.load_dense_matrix(str(path)), a)


def test_find_reference_dataset(tmp_path, monkeypatch):
    rel = tmp_path / "movielens-100k" / "ratings_matrix.npy.gz"
    rel.parent.mkdir()
    rel.write_bytes(b"")
    assert tload.find_reference_dataset("movielens-100k", str(tmp_path)) == \
        jload.find_reference_dataset("movielens-100k", str(tmp_path)) == \
        str(rel)
    assert tload.find_reference_dataset("movielens-75k", str(tmp_path)) is None
    assert tload.find_reference_dataset("nope", str(tmp_path)) is None
    monkeypatch.setenv("AMF_REFERENCE_ROOT", str(tmp_path))
    assert tload.find_reference_dataset("movielens-100k") == str(rel)
    monkeypatch.delenv("AMF_REFERENCE_ROOT")
    assert tload.find_reference_dataset("movielens-100k") is None


DRUGBANK_XML = """<?xml version="1.0"?>
<drugs xmlns="http://drugbank.ca">
  <drug><name>a</name><targets>
    <target partner="1"/><target partner="3"/></targets></drug>
  <drug><name>b</name><targets><target partner="2"/></targets></drug>
  <drug><name>c</name></drug>
  <partners>
    <partner id="1"/><partner id="2"/><partner id="3"/><partner id="4"/>
  </partners>
</drugs>
"""


def test_extractors_equal_jax(tmp_path):
    xml = tmp_path / "drugbank.xml"
    xml.write_text(DRUGBANK_XML)
    got, want = (mod.drugbank_interactions(str(xml)) for mod in (text, jext))
    for g, w in zip(got, want):
        _equal(g, w)
    assert got[0].shape == (2, 3)

    rows = ["client,server,size,x,elapsed"]
    rng = np.random.default_rng(0)
    for k in range(60):
        rows.append(f"c{k % 4},s{k % 3},{int(rng.integers(1, 9)) * 100},0,"
                    f"{int(rng.integers(1, 9))}")
    trace = tmp_path / "trace.csv.bz2"
    with bz2.open(trace, "wt") as f:
        f.write("\n".join(rows) + "\n")
    for min_obs in (1, 5):
        got, want = (mod.planetlab_bandwidths(str(trace), min_obs)
                     for mod in (text, jext))
        for g, w in zip(got, want):
            _equal(g, w)

    ratings = _real(seed=2, n=20, m=15, zeros=0.6)
    _equal(text.movielens_subset(ratings), jext.movielens_subset(ratings))
    _equal(text.movielens_subset(ratings, 0.3, 0.5),
           jext.movielens_subset(ratings, 0.3, 0.5))
