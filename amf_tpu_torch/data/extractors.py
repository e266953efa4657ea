"""Dataset extractors for the reference's raw corpora (numpy and the
standard library only).

A copy of ``amf_tpu/data/extractors.py``: importing the JAX package would
import JAX. Host-side equivalents of drugbank/drugbank_to_interactions.py:5-26
(DrugBank XML -> boolean drug-target interaction matrix) and
planetlab/make_dataset.py (PlanetLab traces -> bandwidth matrix with a
>=10-observations filter), plus the MovieLens subset builder
(movielens-100k/get_subset.py:23-43).
"""

from __future__ import annotations

import bz2
from collections import defaultdict
from typing import Tuple

import numpy as np


def drugbank_interactions(xml_path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """DrugBank XML -> (interactions bool (drugs, targets), drug_names,
    target_ids), with all-zero rows/columns dropped
    (reference: drugbank_to_interactions.get_interactions :5-26).

    Uses the stdlib ElementTree (the reference uses lxml.objectify, which is
    not in this image); namespace-agnostic tag matching.
    """
    import xml.etree.ElementTree as ET

    def local(tag):
        return tag.rsplit("}", 1)[-1]

    tree = ET.parse(xml_path)
    root = tree.getroot()

    partners = []
    drugs = []
    for el in root:
        if local(el.tag) == "drug":
            drugs.append(el)
        elif local(el.tag) == "partners":
            partners.extend(p for p in el if local(p.tag) == "partner")

    pid_to_idx = {p.attrib["id"]: i for i, p in enumerate(partners)}
    target_ids = np.array([int(p.attrib["id"]) for p in partners])

    def find_child(el, name):
        for c in el:
            if local(c.tag) == name:
                return c
        return None

    interactions = np.zeros((len(drugs), len(pid_to_idx)), dtype=bool)
    drug_names = []
    for i, drug in enumerate(drugs):
        name_el = find_child(drug, "name")
        drug_names.append("" if name_el is None else str(name_el.text))
        targets = find_child(drug, "targets")
        if targets is None:
            continue
        for t in targets:
            if local(t.tag) == "target" and t.get("partner") in pid_to_idx:
                interactions[i, pid_to_idx[t.get("partner")]] = True

    good_drug = interactions.any(axis=1)
    good_partner = interactions.any(axis=0)
    good = interactions[np.ix_(good_drug, good_partner)]
    return good, np.array(drug_names)[good_drug], target_ids[good_partner]


def planetlab_bandwidths(
    trace_path: str, min_obs: int = 10
) -> Tuple[np.ndarray, np.ndarray]:
    """PlanetLab trace -> (full bandwidth matrix with NaNs, >=min_obs-filtered
    submatrix) (reference: planetlab/make_dataset.py)."""
    server_ids: dict = {}
    client_ids: dict = {}
    bandwidths = defaultdict(list)

    opener = bz2.open if trace_path.endswith(".bz2") else open
    with opener(trace_path, "rt") as f:
        next(f)  # header
        for line in f:
            client, server, data_size, _, elapsed = line.split(",")
            sid = server_ids.setdefault(server, len(server_ids))
            cid = client_ids.setdefault(client, len(client_ids))
            bandwidths[sid, cid].append(int(data_size) / int(elapsed) * 1000)

    matrix = np.full((len(server_ids), len(client_ids)), np.nan)
    for (i, j), b in bandwidths.items():
        matrix[i, j] = np.mean(b)

    known = np.isfinite(matrix)
    good_rows = known.sum(axis=1) >= min_obs
    good_cols = known.sum(axis=0) >= min_obs
    return matrix, matrix[good_rows, :][:, good_cols]


def movielens_subset(
    ratings: np.ndarray, user_frac: float = 0.5, coverage: float = 0.9
) -> np.ndarray:
    """Top-half most-active users, then the movies covering ``coverage`` of
    their ratings (reference: movielens-100k/get_subset.py:23-43)."""
    known = ratings != 0
    user_counts = known.sum(axis=1)
    order = np.argsort(-user_counts, kind="stable")
    top_users = np.sort(order[: int(np.round(len(order) * user_frac))])
    sub = ratings[top_users]

    movie_counts = (sub != 0).sum(axis=0)
    morder = np.argsort(-movie_counts, kind="stable")
    cum = np.cumsum(movie_counts[morder])
    total = cum[-1]
    keep = morder[: int(np.searchsorted(cum, coverage * total) + 1)]
    return sub[:, np.sort(keep)]
