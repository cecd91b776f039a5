"""The port's training CLI (``train/cli.py``) and parity check
(``data/parity.py``) against the JAX package's, on the CPU
(``--platform cpu``).

* ``vars(parse([]))`` equals JAX's: the same flags, destinations and
  defaults.
* ``load_problem`` gives the same graph, features and labels as JAX's,
  bitwise, for ``random``, ``powerlaw``, ``homophilic`` and a fixture.
* A zoo run writes a CSV row whose fields other than the two times equal
  JAX's row for the same arguments.
* ``--validate-parity`` gives JAX's statuses on all 13 fixtures and exits
  0; a load or oracle failure is a FAIL line and exits 1.
* ``--shards 2 --dist-backend gloo`` trains over two CPU ranks and prints
  JAX's distributed lines, and so does ``--feature-shards 2`` over a
  2 x 2 grid of four; a ``--minibatch-edges`` run writes JAX's CSV row (its inference time
  NaN), and an ``--export`` run writes an artifact that loads and answers
  as the run's trainer does.
* ``--tune``, ``--plan-cache`` and ``--profile`` run; a cached plan trains
  to the same losses, bitwise.
* JAX's accuracy bands (``tests/test_e2e_datasets.py:64-79``) hold for the
  port on its five representative fixtures and three models.

Datasets load from copies under ``tmp_path``: the CLI caches what it
loads next to the raw files.
"""

import importlib.util
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu.data import parity as jparity
from hypergef_tpu.data.datasets import EXISTING_DATASETS
from hypergef_tpu.sparse import planner as jplanner
from hypergef_tpu.train import cli as jcli

from hypergef_tpu_torch.data import parity
from hypergef_tpu_torch.data.datasets import load_dataset
from hypergef_tpu_torch.ops import fused
from hypergef_tpu_torch.sparse import autotune, planner
from hypergef_tpu_torch.train import TrainConfig, Trainer, cli, rand_train_test_idx

REPO = Path(__file__).resolve().parents[1]
FIXTURE_ROOT = os.path.join(os.path.dirname(__file__), "fixtures", "data")
SMALL = ["--n", "200", "--e", "120", "--feat", "8", "--classes", "3", "--nhid", "8",
         "--epochs", "4", "--platform", "cpu"]
# tests/test_e2e_datasets.py's representatives, one a loader family
TRAIN_REPRESENTATIVES = ["zoo", "cora", "coauthor_dblp", "walmart-trips", "yelp"]


def _copy(root, names):
    for name in names:
        shutil.copytree(os.path.join(FIXTURE_ROOT, name, "raw"), root / name / "raw")
        shutil.copy(os.path.join(FIXTURE_ROOT, name, "FIXTURE"), root / name / "FIXTURE")
    return str(root)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return _copy(tmp_path_factory.mktemp("data"), EXISTING_DATASETS)


def _jax_flags(ns):
    """The parsed flags without the port's own ``--dist-backend`` (the
    distributed ranks' backend, which JAX's single controller has no use
    for), whose default is nccl."""
    flags = vars(ns)
    assert flags.pop("dist_backend") == "nccl"
    return flags


def test_parse_defaults_equal_jax():
    assert _jax_flags(cli.parse([])) == vars(jcli.parse([]))
    argv = ["--dname", "cora", "--plan-cache", "--tune", "--first-aggr", "max", "--n", "7",
            "--synthetic", "powerlaw", "--feature_noise", "0.5", "--platform", "cpu"]
    assert _jax_flags(cli.parse(argv)) == vars(jcli.parse(argv))


@pytest.mark.parametrize("argv", [
    ["--synthetic", "random"], ["--synthetic", "powerlaw"],
    ["--synthetic", "homophilic", "--seed", "3"],
    ["--dname", "zoo"], ["--dname", "zoo", "--add-self-loop"],
    ["--dname", "walmart-trips", "--feature_noise", "0.5"],
])
def test_load_problem_bit_equal(fixture_root, argv):
    args = cli.parse(argv + ["--n", "300", "--e", "200", "--feat", "6",
                             "--data-path", fixture_root])
    hg, x, y = cli.load_problem(args)
    jhg, jx, jy = jcli.load_problem(jcli.parse(argv + ["--n", "300", "--e", "200", "--feat",
                                                       "6", "--data-path", fixture_root]))
    assert (hg.num_nodes, hg.num_edges, hg.name) == (jhg.num_nodes, jhg.num_edges, jhg.name)
    for f in ("h_indptr", "h_indices", "ht_indptr", "ht_indices"):
        np.testing.assert_array_equal(getattr(hg, f), getattr(jhg, f))
    for a, b in ((x, jx), (y, jy)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_zoo_csv_row_equals_jax(tmp_path):
    rows = []
    for main, sub in ((cli.main, "port"), (jcli.main, "jax")):
        root = _copy(tmp_path / sub, ["zoo"])
        out = str(tmp_path / f"{sub}.csv")
        res = main(["--dname", "zoo", "--data-path", root, "--model", "HGNN", "--epochs", "20",
                    "--nhid", "16", "--seed", "1", "--output", out, "--platform", "cpu"])
        assert "test_acc" in res and np.isfinite(res["final_loss"])
        (row,) = open(out).read().splitlines()
        rows.append(row.split(","))
    port, jax_row = rows
    assert len(port) == len(jax_row) == 9
    assert port[:7] == jax_row[:7]
    assert all(float(v) > 0 for v in port[7:])


def test_validate_parity_statuses_equal_jax(fixture_root):
    for name in sorted(EXISTING_DATASETS):
        got = [(r.name, r.status) for r in parity.validate(name, root=fixture_root,
                                                            device="cpu")]
        want = [(r.name, r.status) for r in jparity.validate(name, root=fixture_root)]
        assert got == want, name
        assert got == [("format", "PASS"), ("shape", "SKIP"), ("oracle", "PASS"),
                       ("accuracy", "SKIP")], name
    assert parity.EXPECTED_REAL == jparity.EXPECTED_REAL
    assert parity.EXPECTED_ACC_BAND == jparity.EXPECTED_ACC_BAND


def test_validate_parity_exit_codes(tmp_path, capsys, monkeypatch):
    root = _copy(tmp_path, ["zoo", "cora"])
    record = str(tmp_path / "rec.json")
    with pytest.raises(SystemExit) as ok:
        cli.main(["--dname", "zoo", "--data-path", root, "--validate-parity", "--platform",
                  "cpu", "--parity-record", record])
    assert ok.value.code == 0 and "parity[zoo]: PASS" in capsys.readouterr().out
    assert os.path.exists(record)
    # a load failure is a FAIL line
    open(os.path.join(root, "cora", "raw", "labels.pickle"), "wb").write(b"broken")
    with pytest.raises(SystemExit) as bad:
        cli.main(["--dname", "cora", "--data-path", root, "--validate-parity", "--platform",
                  "cpu"])
    assert bad.value.code == 1 and "[FAIL] format" in capsys.readouterr().out

    # an oracle failure is a FAIL line, never a PASS or SKIP
    def broken(*a, **k):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(fused, "hgnn_aggregate", broken)
    by = {r.name: r for r in parity.validate("zoo", root=root, device="cpu")}
    assert by["oracle"].status == "FAIL" and "kernel failed" in by["oracle"].detail


def test_validate_real_shaped_data_checks_shape_and_accuracy(tmp_path, monkeypatch):
    root = _copy(tmp_path, ["zoo"])
    os.unlink(os.path.join(root, "zoo", "FIXTURE"))
    by = {r.name: r for r in parity.validate("zoo", root=root, device="cpu")}
    assert by["shape"].status == "FAIL" and "expected" in by["shape"].detail
    ds = load_dataset("zoo", root=root, cache=False)
    monkeypatch.setitem(parity.EXPECTED_REAL, "zoo", dict(
        num_nodes=ds.hg.num_nodes, num_edges=ds.hg.num_edges, features=ds.num_features,
        classes=ds.num_classes))
    by = {r.name: r for r in parity.validate("zoo", root=root, device="cpu", train_epochs=30)}
    assert by["shape"].status == "PASS"
    assert by["accuracy"].status in ("PASS", "FAIL") and "HGNN test acc" in by[
        "accuracy"].detail


def test_shards_run(capsys):
    """``--shards 2 --dist-backend gloo --platform cpu``: two CPU ranks train
    the DistTrainer and the CLI prints JAX's lines
    (``hypergef_tpu/train/cli.py:202-217``); both ranks take the same steps."""
    res = cli.main(["--synthetic", "random", "--shards", "2", "--dist-backend", "gloo"]
                   + SMALL)
    out = capsys.readouterr().out.splitlines()
    assert any(line.startswith("distributed (2 shards): avg epoch time ") for line in out)
    for k in ("train_acc", "valid_acc", "test_acc", "final_loss"):
        assert any(line.startswith(f"{k}: ") for line in out), k
    assert res["n_shards"] == 2 and len(res["losses"]) == 4 and np.isfinite(res["final_loss"])
    assert len(res["ranks"]) == 2 and res["timer"] == "host_clock"


def test_feature_shards_run(capsys):
    """``--shards 2 --feature-shards 2``: a 2 x 2 grid of four CPU ranks
    trains the feature-sharded DistTrainer and prints JAX's lines; every
    rank ran its steps."""
    res = cli.main(["--synthetic", "random", "--shards", "2", "--feature-shards", "2",
                    "--dist-backend", "gloo"] + SMALL)
    out = capsys.readouterr().out.splitlines()
    assert any(line.startswith("distributed (2 shards): avg epoch time ") for line in out)
    for k in ("train_acc", "valid_acc", "test_acc", "final_loss"):
        assert any(line.startswith(f"{k}: ") for line in out), k
    assert res["n_shards"] == 2 and len(res["losses"]) == 4 and np.isfinite(res["final_loss"])
    assert len(res["ranks"]) == 4


def test_minibatch_edges_run(tmp_path):
    """``--minibatch-edges``: ``epochs // 10`` epochs of sampled batches, the
    row's train time a batch's and its inference time NaN, as JAX's
    (``hypergef_tpu/train/cli.py:218-227``)."""
    out = str(tmp_path / "mb.csv")
    skipped = tmp_path / "skipped.hgefsrv"
    argv = ["--synthetic", "homophilic", "--minibatch-edges", "32", "--output", out,
            "--export", str(skipped)]
    res = cli.main(argv + SMALL[:-4] + ["--epochs", "20", "--platform", "cpu"])
    assert res["route"] == "cumsum" and res["batches"] == 2 * (120 // 32)
    assert "export_path" not in res and not skipped.exists()
    assert np.isfinite(res["final_loss"]) and "test_acc" in res
    (row,) = open(out).read().splitlines()
    fields = row.split(",")
    assert fields[:3] == ["auto", "HGNN", "walmart-trips"] and len(fields) == 9
    assert float(fields[7]) > 0 and fields[8] == "nan"


def test_export_run_loads(tmp_path):
    """``--export``: the full-batch run's artifact holds the run's graph and
    loads and answers in a server of its own (the minibatch path skips it:
    ``test_minibatch_edges_run``)."""
    from hypergef_tpu_torch import serve

    path = str(tmp_path / "m.hgefsrv")
    res = cli.main(["--synthetic", "random"] + SMALL + ["--export", path])
    assert res["export_path"] == path
    meta, _ = serve.read_artifact(path)
    assert meta["platforms"] == ["cpu"] and meta["input_shape"] == [200, 8]
    hg, x, _ = cli.load_problem(cli.parse(["--synthetic", "random"] + SMALL))
    assert (meta["num_nodes"], meta["nnz"], meta["nclass"]) == (hg.num_nodes, hg.nnz, 3)
    got = serve.ServingModel.load(path, device="cpu").predict(x)
    assert got.shape == (200, 3) and torch.isfinite(got).all()


def test_tune_plan_cache_and_profile(tmp_path, monkeypatch, capsys):
    # the sweep itself is timed in test_torch_port_autotune.py; here its
    # result goes through the CLI and the Trainer
    monkeypatch.setenv("HYPERGEF_TORCH_TUNE_DIR", str(tmp_path / "tune"))
    monkeypatch.setattr(autotune, "sweep",
                        lambda *a, **k: [autotune.TuneResult("tree", {"ngs": 4}, 1e-6)])
    res = cli.main(["--synthetic", "powerlaw", "--tune"] + SMALL)
    assert np.isfinite(res["final_loss"]) and len(os.listdir(tmp_path / "tune")) == 1
    assert res["route"] == "tree"
    runs = [cli.main(["--synthetic", "powerlaw", "--plan-cache", str(tmp_path / "plans")]
                     + SMALL) for _ in range(2)]
    assert len(os.listdir(tmp_path / "plans")) == 1
    np.testing.assert_array_equal(runs[0]["losses"], runs[1]["losses"])
    assert runs[0]["route"] == runs[1]["route"]
    res = cli.main(["--synthetic", "homophilic", "--profile", "1"] + SMALL)
    assert res["epochs"] == 4 and "epoch time:" in capsys.readouterr().out


@pytest.fixture
def one_thread():
    """These graphs are a few hundred nodes: one intra-op thread each keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("model", ["HGNN", "UniGIN", "UniGCNII"])
@pytest.mark.parametrize("name", TRAIN_REPRESENTATIVES)
def test_accuracy_bands(fixture_root, one_thread, name, model):
    """``train_full_batch``'s training and evaluation (its inference timing
    left out)."""
    ds = load_dataset(name, root=fixture_root, cache=False)
    split = rand_train_test_idx(ds.labels, seed=1)
    cfg = TrainConfig(model=model, nhid=32, epochs=60, lr=0.01, dropout=0.2, input_drop=0.2)
    tr = Trainer(cfg, ds.hg, ds.features, ds.labels, device="cpu")
    tr.fit(split["train"])
    res = tr.evaluate(split)
    chance = 100.0 / ds.num_classes
    if name == "yelp":
        assert res["train_acc"] > chance + 10, (name, model, res)
        assert res["test_acc"] > chance + 5, (name, model, res)
    else:
        assert res["train_acc"] > chance + 25, (name, model, res)
        assert res["test_acc"] > chance + 10, (name, model, res)


def test_chip_smoke_cli_constants_are_jax_picks():
    """chip_smoke.py's phase 27 holds the CLI's route on the card against
    constants: each is JAX's ladder pick for its graph at the CLI's seed."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key, argv in (("coauthor_dblp", mod.CLI_DBLP), ("5000x3000", mod.CLI_5K)):
        args = cli.parse(argv)
        assert args.synthetic == "powerlaw" and args.seed == 1
        jhg = jsyn.powerlaw_hypergraph(args.n, args.e, seed=args.seed)
        pick = jplanner.plan_aggregation(jhg, with_multihot=False).preferred_backend
        assert pick == mod.CLI_PICKS[key], key
        hg, _, _ = cli.load_problem(args)
        assert planner.plan_aggregation(hg, "cpu").preferred_backend == pick, key
    assert vars(cli.parse(mod.CLI_DBLP))["feat"] == 1425
    assert len(mod.CLI_ROW) == 9
