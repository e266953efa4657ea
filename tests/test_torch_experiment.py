"""The port's experiment runner (``amf_tpu_torch/run/experiment.py``) held
to the JAX package's: the same catalog (every command naming the port's
CLI in place of the JAX package's), every command line parsing in the
port CLI it names, the same commands run with ``--device`` passed on, the
skip rules, the entries that need a reference checkout failing only when
run, and one real run of the MMMF arm of ``10x10_discrete2_d2`` on the CPU
whose results pickle has the JAX CLI's layout and records, read back by
``--check``. Also ``generate`` and ``choose_training``: the same files as
the JAX CLIs for the same arguments and seed, array for array.
"""

import argparse
import importlib
import json
import os
import pickle

import numpy as np
import pytest

import torch_threads  # noqa: F401  (one torch thread a worker)
from amf_tpu.run import experiment as jexp
from amf_tpu_torch.run import experiment as texp

JAX_PREFIX, PORT_PREFIX = "amf_tpu.run.", "amf_tpu_torch.run."


def _ported(cmd):
    return [PORT_PREFIX + t[len(JAX_PREFIX):]
            if isinstance(t, str) and t.startswith(JAX_PREFIX) else t
            for t in cmd]


def test_catalog_is_jax_catalog_on_the_port():
    jcat, tcat = jexp.catalog(), texp.catalog()
    assert list(tcat) == list(jcat) and len(tcat) == 12
    for name, je in jcat.items():
        te = tcat[name]
        assert (te.name, te.source) == (je.name, je.source)
        assert te.data_cmd == _ported(je.data_cmd)
        assert list(te.runs) == list(je.runs)
        for kind, argv in je.runs.items():
            assert te.runs[kind] == _ported(argv), (name, kind)
            assert argv[0].startswith(JAX_PREFIX)


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("name", sorted(texp.catalog()))
def test_every_catalog_command_parses_in_its_port_cli(monkeypatch, name):
    """Each command of the entry, filled as the runner fills it and given
    --seed, --device and --note as the runner gives them, parses in the
    port CLI it names (argparse exits on an unknown flag)."""
    real_parse = argparse.ArgumentParser.parse_args

    def parse_then_stop(self, args=None, namespace=None):
        raise _Parsed(real_parse(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        parse_then_stop)
    exp = texp.catalog()[name]
    tail = ["--seed", "1", "--device", "cpu"]
    cmds = [] if exp.data_cmd[0] == "COPY" else [exp.data_cmd + tail]
    cmds += [argv + tail + ["--note", "git-rev:x", "--note", "e"]
             for argv in exp.runs.values()]
    for cmd in cmds:
        filled = ["ref.npy" if isinstance(t, tuple) else
                  t.replace("{data}", "d.npz").replace("{out}", "o")
                  for t in cmd]
        assert filled[0].startswith(PORT_PREFIX)
        cli = importlib.import_module(filled[0])
        with pytest.raises(_Parsed) as parsed:
            cli.main(filled[1:])
        ns = parsed.value.args[0]
        assert ns.device == "cpu" and ns.seed == 1, filled


def _stub_processes(monkeypatch, runner, issued):
    """Record each ``python -m`` command the runner module issues (module
    and arguments) instead of running it."""
    def run(argv, check=False, **kw):
        issued.append(argv[2:])
        return argparse.Namespace(returncode=0)

    monkeypatch.setattr(runner, "subprocess", argparse.Namespace(run=run))
    monkeypatch.setattr(runner, "_git_rev", lambda: "rev")


def test_runner_passes_the_device_to_every_command(monkeypatch, tmp_path):
    """With the processes stubbed out, the port's runner issues the JAX
    runner's commands on the port's CLIs, each with --device added."""
    got, want = [], []
    _stub_processes(monkeypatch, texp, got)
    _stub_processes(monkeypatch, jexp, want)
    for mod, outdir, extra in ((texp, "t", ["--device", "cpu"]),
                               (jexp, "t", [])):
        mod.main(["10x10_discrete2_d2", "--outdir", str(tmp_path / outdir),
                  "--steps", "2", "--seeds", "2", *extra])
    assert len(got) == len(want) == 2 * (1 + 10)
    for g, w in zip(got, want):
        w = _ported(w)
        at = w.index("--note") if "--note" in w else len(w)
        assert g == w[:at] + ["--device", "cpu"] + w[at:]
    # an output directory whose path holds "results": every arm still runs
    # (the JAX runner would take the data file for the arms' results file)
    got.clear()
    texp.main(["10x10_discrete2_d2", "--outdir", str(tmp_path / "results"),
               "--device", "cpu"])
    assert len(got) == 1 + 10


def test_set_overrides_a_flag_in_every_run_that_passes_it(monkeypatch,
                                                          tmp_path):
    """--set NAME=VALUE (the port's; a depth cut) replaces the value of
    --NAME where a run passes it and leaves every other token; a NAME that
    no run to be run passes exits with an error."""
    got = []
    _stub_processes(monkeypatch, texp, got)
    base = ["10x10_discrete2_d2", "--device", "cpu", "--only", "stan",
            "bayes", "mmmf"]
    texp.main(base + ["--outdir", str(tmp_path / "a")])
    plain = got[1:]
    got.clear()
    texp.main(base + ["--outdir", str(tmp_path / "a"), "--force", "--set",
                      "samps=20", "--set", "lookahead-warmup=5"])
    cut = got[1:]
    assert [c[0] for c in cut] == [c[0] for c in plain] == [
        "amf_tpu_torch.run.bpmf", "amf_tpu_torch.run.bayes_pmf",
        "amf_tpu_torch.run.active_mmmf"]
    for a, b in zip(plain, cut):
        want = list(a)
        for flag, value in (("--samps", "20"), ("--lookahead-warmup", "5")):
            if flag in want:
                want[want.index(flag) + 1] = value
        assert b == want
    assert cut[0][cut[0].index("--samps") + 1] == "20"
    assert cut[2] == plain[2]
    for bad in ("admm-iters=5", "samps"):
        with pytest.raises(SystemExit) as done:
            texp.main(base + ["--outdir", str(tmp_path / "a"), "--set", bad])
        assert done.value.code == 1


def test_skip_reasons_and_digest_paths(tmp_path):
    """Digest-level skip semantics, as test_clis.py holds JAX's."""
    res = str(tmp_path / "results_stan.pkl")
    for mod in (texp, jexp):
        assert mod._skip_reason(res, force=False, redo=False) is None
        with open(res, "wb") as f:
            f.write(b"x")
        assert "exists" in mod._skip_reason(res, force=False, redo=False)
        assert mod._skip_reason(res, force=True, redo=False) is None
        os.remove(res)
        dpath = mod.digest_path_for(res)
        assert dpath == str(tmp_path / "digest_stan.json.gz")
        with open(dpath, "wb") as f:
            f.write(b"x")
        assert "digest exists" in mod._skip_reason(res, force=False,
                                                   redo=False)
        assert mod._skip_reason(res, force=False, redo=True) is None
        assert mod._skip_reason(res, force=True, redo=False) is None
        os.remove(dpath)


@pytest.mark.parametrize("name", ["movielens-100k-from5pct-test5pct",
                                  "criteria_10x10_r1"])
def test_reference_data_entries_fail_only_when_run(monkeypatch, tmp_path,
                                                   capsys, name):
    monkeypatch.delenv("AMF_REFERENCE_ROOT", raising=False)
    texp.main(["--list"])
    assert name in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="AMF_REFERENCE_ROOT"):
        texp.main([name, "--outdir", str(tmp_path), "--device", "cpu"])
    monkeypatch.setenv("AMF_REFERENCE_ROOT", str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError, match="not found"):
        texp.main([name, "--outdir", str(tmp_path), "--device", "cpu"])


def test_runner_defaults_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        texp.main(["10x10_discrete2_d2", "--outdir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "10x10_discrete2_d2" / "data.pkl")


def test_mmmf_arm_runs_and_checks_on_the_cpu(monkeypatch, tmp_path, capsys):
    """One real run (two processes: generate, active_mmmf; two records a
    selector, the initial one and one query), then --check; the pickle
    holds the JAX CLI's records for the same data and argv (the random
    selector's pick aside: its scores come from the port's generator)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    texp.main(["10x10_discrete2_d2", "--outdir", str(tmp_path), "--only",
               "mmmf", "--steps", "2", "--device", "cpu"])
    out = tmp_path / "10x10_discrete2_d2"
    with open(out / "results_mmmf.pkl", "rb") as f:
        got = pickle.load(f)
    assert got["_kind"] == "mmmf" and got["_args"]["device"] == "cpu"
    assert got["_args"]["note"][1] == "experiment:10x10_discrete2_d2"

    from amf_tpu.run import active_mmmf as jmmmf

    argv = [t.replace("{data}", str(out / "data.pkl"))
            .replace("{out}", str(tmp_path / "jax"))
            for t in jexp.catalog()["10x10_discrete2_d2"].runs["mmmf"]][1:]
    jmmmf.main(argv + ["--steps", "2"])
    with open(tmp_path / "jax" / "results_mmmf.pkl", "rb") as f:
        want = pickle.load(f)
    assert sorted(got) == sorted(want)
    for k in want:
        if k.startswith("_"):
            continue
        assert len(got[k]) == len(want[k]) == 2, k
        for g, w in zip(got[k], want[k]):
            assert len(g) == len(w) and g[0] == w[0], k
            if k != "mmmf_random":
                assert g[2] == w[2], k
                assert g[1] == pytest.approx(w[1], abs=1e-9), k
    np.testing.assert_array_equal(got["_real"], want["_real"])
    assert got["_rating_vals"] == want["_rating_vals"]

    capsys.readouterr()
    with pytest.raises(SystemExit) as done:
        texp.main(["10x10_discrete2_d2", "--outdir", str(tmp_path),
                   "--check"])
    assert done.value.code == 0
    text = capsys.readouterr().out
    assert "hard_ok=True" in text and "structural" in text
    assert (out / "digest_mmmf.json.gz").exists()
    assert (out / "parity_report.json").exists()


def test_generate_and_choose_training_match_jax(tmp_path):
    """test_clis.py's cases and more: the same files, array for array."""
    from amf_tpu.data.loaders import load_npz_schema
    from amf_tpu.run import choose_training as jchoose
    from amf_tpu.run import generate as jgen
    from amf_tpu_torch.run import choose_training as tchoose
    from amf_tpu_torch.run import generate as tgen

    rng = np.random.default_rng(2)
    dense = rng.integers(1, 6, size=(8, 8)).astype(float)
    src = str(tmp_path / "dense.npy")
    np.save(src, dense)
    labels = np.where(rng.random((12, 14)) < 0.3, 1.0, 0.0)
    db_src = str(tmp_path / "labels.npy")
    np.save(db_src, labels)
    gens = [
        ["--rows", "8", "--cols", "8", "--rank", "2", "--known-pos", "3",
         "--unknown-pos", "22"],
        ["--rows", "10", "--cols", "10", "--rank", "2", "--known-pos", "10",
         "--unknown-pos", "90", "--cutoff", "0", "--seed", "3"],
    ]
    splits = [
        [src, "--n-pick", "12", "--n-test", "10"],
        [src, "--pick-known-frac", "0.2", "--test-known-frac", "0.1",
         "--seed", "4"],
        [src, "--new-item-frac", "0.25", "--pick-no-extras",
         "--test-known-frac", "0.1"],
        [src, "--n-pick", "20", "--test-one-per-row-col"],
        [db_src, "--drugbank", "--n-pick", "40", "--test-equal-classes",
         "--n-test", "20"],
        [db_src, "--drugbank", "--n-pick", "40", "--test-class-ratios",
         "{-1: .6666, 1: .3333}", "--n-test", "30"],
    ]
    for i, argv in enumerate(gens):
        paths = [str(tmp_path / f"gen{i}_{p}.pkl") for p in ("t", "j")]
        tgen.main(argv + ["--device", "cpu", paths[0]])
        jgen.main(argv + [paths[1]])
        got, want = (pickle.load(open(p, "rb")) for p in paths)
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got["_real"], want["_real"])
        assert got["_rating_vals"] == want["_rating_vals"]
        assert got["_rating_vals"] == want["_rating_vals"]
    for i, argv in enumerate(splits):
        paths = [str(tmp_path / f"split{i}_{p}.npz") for p in ("t", "j")]
        tchoose.main([argv[0], paths[0], *argv[1:], "--device", "cpu"])
        jchoose.main([argv[0], paths[1], *argv[1:]])
        got, want = (load_npz_schema(p) for p in paths)
        assert sorted(got) == sorted(want), i
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{i} {k}")
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tgen.main(gens[0] + [str(tmp_path / "never.pkl")])
        with pytest.raises(RuntimeError, match="CUDA"):
            tchoose.main([src, str(tmp_path / "never.npz")])


def test_cli_processes_report_their_cholesky_counts(tmp_path):
    """A process of the port that imports the Cholesky module appends its
    counts to the file AMF_TORCH_CHOL_COUNTS names when it exits; the
    runner's arms inherit the variable (the chip smoke reads the bayes
    arm's kernel launches so)."""
    import subprocess
    import sys

    from amf_tpu_torch.ops import chol_kernel

    path = tmp_path / "counts.jsonl"
    code = ("import torch\n"
            "from amf_tpu_torch.ops import chol_kernel as ck\n"
            "S = torch.eye(3, dtype=torch.float64).expand(4, 3, 3)\n"
            "b = torch.ones(4, 3, dtype=torch.float64)\n"
            "ck.chol_solve_sample(S, b, torch.zeros_like(b))\n"
            "ck.chol_solve_sample(S, b, torch.zeros_like(b))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1",
               **{chol_kernel.COUNTS_FILE_ENV: str(path)})
    for _ in range(2):
        subprocess.run([sys.executable, "-c", code], env=env, check=True,
                       timeout=120)
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [{k: v for k, v in ln.items() if k != "argv"} for ln in lines] \
        == [{"gram_fed": 0, "s_given": 0, "plain": 2}] * 2
