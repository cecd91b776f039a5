"""The serving export (``serve.py``) and the kernels' custom ops
(``ops/library.py``) against the JAX package's export, on the CPU.

* Each of the seven ``hypergef_torch`` ops passes ``torch.library.opcheck``
  on the CPU (schema, fake against real, autograd registration, the
  dispatch tracer's dynamic shapes), and its CPU result equals its plain
  twin's, bitwise.
* The port's artifact for HGNN (sum and mean), UniGIN and UniGCNII on
  ``cumsum``, exported on the CPU from weights carried across by
  ``params_from_flax``, answers as JAX's ``serve.export_trainer`` artifact of
  the same weights on the same graph: rtol and atol 1e-3 (the f32 bar of
  ``tests/test_fuzz_backends.py:46``), argmax equal on ≥ 98%
  (``tests/test_torch_parity.py:135``); ``precomp`` (bf16) at 3e-2
  (``:54``). The
  loaded artifact's answer equals the built ``ServingModel``'s bitwise.
* The header: a round trip, and each package's ``read_artifact`` reads the
  other's artifact; the port's ``load`` of a JAX artifact raises. A bad
  magic, a truncated file, a newer format version and a wrong input shape
  raise; ``platforms=["tpu"]`` raises.
* A fresh process loads an artifact and answers without importing the
  models or the trainer.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu import serve as jserve
from hypergef_tpu.train.trainer import TrainConfig as JTrainConfig
from hypergef_tpu.train.trainer import Trainer as JTrainer

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch import serve
from hypergef_tpu_torch.models.convert import params_from_flax
from hypergef_tpu_torch.ops import (
    aligned_band, aligned_max, bitstream, ell_gather, fused_dense, library, segment_sum,
)
from hypergef_tpu_torch.ops.bitstream import BitIncidence
from hypergef_tpu_torch.ops.ell_gather import GatherTable
from hypergef_tpu_torch.sparse.planner import pack_nibbles, plan_aligned
from hypergef_tpu_torch.sparse.reorder import community_reorder
from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer

REPO = Path(__file__).resolve().parents[1]
NCLASS = 3
NFEAT = 12


@functools.lru_cache(maxsize=None)
def _graphs():
    jhg, y = jsyn.homophilic_hypergraph(200, 120, NCLASS, avg_edge_size=5.0, seed=3)
    thg, _ = tsyn.homophilic_hypergraph(200, 120, NCLASS, avg_edge_size=5.0, seed=3)
    x = np.random.default_rng(0).normal(size=(200, NFEAT)).astype(np.float32)
    sbm, _ = community_reorder(tsyn.community_hypergraph(240, 160, 8, 5, 0.02, 3))
    return jhg, thg, x, np.asarray(y), sbm


@functools.lru_cache(maxsize=None)
def _aligned_stage(form: str):
    """The edge stage of a kernel-form aligned plan on the CPU: its
    ``BandTable`` holds the flat tables (no kernel layout off the card)."""
    sbm = _graphs()[4]
    plan = dataclasses.replace(plan_aligned(sbm, form=form), form="pallas_auto")
    return plan.device("cpu")[0], sbm


def _op_cases():
    """(op, args, plain twin's result) of each op on CPU tensors."""
    _, thg, x, _, _ = _graphs()
    rng = np.random.default_rng(7)
    xt = torch.as_tensor(x)
    h = torch.as_tensor((rng.random((200, 120)) < 0.05).astype(np.int8))
    se = torch.as_tensor(rng.random((120, 1)).astype(np.float32))
    sv = torch.as_tensor(rng.random((200, 1)).astype(np.float32))
    gidx = torch.as_tensor(rng.integers(0, 200, size=(50, 8)).astype(np.int32))
    gt = GatherTable(gidx=gidx, gidx_long=gidx.long(),
                     mask=torch.as_tensor((rng.random((50, 8)) > 0.2).astype(np.float32)),
                     num_inputs=200)
    v2e = thg.device_data("cpu").v2e
    pack = BitIncidence.from_hypergraph(thg).device("cpu")[1]  # Hᵀ: [E, N]
    carrier = torch.as_tensor(pack_nibbles(h.numpy()))
    cases = {
        "fused_dense_two_stage": ((h, xt, se, sv),
                                  fused_dense.fused_dense_two_stage_plain(h, xt, se, sv)),
        "fused_dense_two_stage_packed": (
            (carrier, xt, se, sv), fused_dense.fused_dense_two_stage_plain(h, xt, se, sv)),
        "ell_gather_sum": ((xt, gt.gidx, gt.mask, 200),
                           ell_gather.ell_gather_sum_plain(xt, gt.gidx_long, gt.mask)),
        "bitmm": ((xt, pack.words, None, None, None, pack.m, pack.k),
                  bitstream.bitmm_plain(pack.words, xt, pack.m, pack.k)),
        "gather_segment_sum": ((xt, v2e.indptr, v2e.gather, None, 200),
                               segment_sum.gather_segment_sum_plain(xt, v2e)),
    }
    for form in ("bucketed", "uniform"):
        st, sbm = _aligned_stage(form)
        t = st.band
        xs = torch.as_tensor(np.random.default_rng(8).normal(
            size=(sbm.num_nodes, 6)).astype(np.float32))
        cases[f"aligned_band {form}"] = (
            (xs, t.win, t.src, t.groups, None, None, None, t.band, t.spill, 0, t.group_rows,
             t.block_rows, t.num_inputs, t.num_segments),
            aligned_band.aligned_band_plain(xs, st))
        cases[f"aligned_masked_argmax {form}"] = (
            (xs, t.win, t.src, t.groups, None, None, None, None, None, t.band, t.spill,
             t.group_rows, t.block_rows, t.num_inputs, t.num_segments),
            aligned_max.aligned_max_plain(xs, st))
    return cases


OP_CASES = ["fused_dense_two_stage", "fused_dense_two_stage_packed", "ell_gather_sum", "aligned_band bucketed",
            "aligned_band uniform", "aligned_masked_argmax bucketed",
            "aligned_masked_argmax uniform", "bitmm", "gather_segment_sum"]


@functools.lru_cache(maxsize=None)
def _cases():
    return _op_cases()


@pytest.mark.parametrize("case", OP_CASES)
def test_op_cpu_result_is_plain_twin(case):
    args, want = _cases()[case]
    got = library.OPS[case.split()[0]](*args)
    for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("op", ["fused_dense_two_stage", "fused_dense_two_stage_packed",
                                "ell_gather_sum", "aligned_band",
                                "aligned_masked_argmax", "bitmm", "gather_segment_sum"])
def test_opcheck(op):
    case = op if op in _cases() else f"{op} bucketed"
    torch.library.opcheck(library.OPS[op], _cases()[case][0])


# (model, first_aggr, backend, tolerance): the f32 routes at 1e-3, bf16 precomp at 3e-2
EXPORT_CASES = {
    "HGNN sum": ("HGNN", "sum", "cumsum", 1e-3),
    "HGNN mean": ("HGNN", "mean", "cumsum", 1e-3),
    "UniGIN": ("UniGIN", "sum", "cumsum", 1e-3),
    "UniGCNII": ("UniGCNII", "sum", "cumsum", 1e-3),
    "HGNN precomp": ("HGNN", "sum", "precomp", 3e-2),
}


@functools.lru_cache(maxsize=None)
def _artifacts(name, root):
    """JAX's and the port's artifacts of one case, from the same weights:
    (jax path, port path, port Trainer, port meta)."""
    jhg, thg, x, y, _ = _graphs()
    model, first_aggr, backend, _ = EXPORT_CASES[name]
    kw = dict(model=model, nhid=8, first_aggr=first_aggr, backend=backend, seed=4)
    jtr = JTrainer(JTrainConfig(**kw), jhg, x, y, nclass=NCLASS)
    jpath = os.path.join(root, f"{name}.jax.hgefsrv")
    jserve.export_trainer(jtr, jpath)
    tr = Trainer(TrainConfig(**kw), thg, x, y, nclass=NCLASS, device="cpu",
                 params=params_from_flax(jtr.params))
    path = os.path.join(root, f"{name}.hgefsrv")
    meta = serve.export_trainer(tr, path, platforms=["cpu"])
    return jpath, path, tr, meta


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("artifacts"))


@pytest.mark.parametrize("name", list(EXPORT_CASES))
def test_export_matches_jax_and_built_server(name, root):
    jpath, path, tr, meta = _artifacts(name, root)
    x = _graphs()[2]
    want = np.asarray(jserve.ServingModel.load(jpath).predict(x))
    loaded = serve.ServingModel.load(path, device="cpu")
    got = loaded.predict(x)
    tol = EXPORT_CASES[name][3]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    assert (got.argmax(1).numpy() == want.argmax(1)).mean() >= 0.98
    built = serve.ServingModel(tr.cfg, tr.hg, NFEAT, NCLASS, "cpu",
                               params=tr.model.state_dict(), plan=tr.plan)
    assert torch.equal(got, built.predict(x))
    assert loaded.meta["payload_bytes"] == meta["payload_bytes"] > 0
    assert (loaded.predict_labels(x) == got.argmax(1).numpy()).all()


def test_header_round_trip_and_jax_artifacts(root):
    jpath, path, _, meta = _artifacts("HGNN sum", root)
    got, payload = serve.read_artifact(path)
    assert got == {**meta, "format_version": 1} and len(payload) == meta["payload_bytes"]
    assert got["payload_format"] == "torch.export" and got["platforms"] == ["cpu"]
    jmeta, jpayload = jserve.read_artifact(jpath)
    assert serve.read_artifact(jpath) == (jmeta, jpayload)
    assert jserve.read_artifact(path) == (got, payload)
    shared = set(jmeta) - {"platforms", "hypergef_version", "payload_bytes"}
    assert shared < set(got) and all(got[k] == jmeta[k] for k in shared)
    with pytest.raises(ValueError, match="jax.export"):
        serve.ServingModel.load(jpath, device="cpu")


@pytest.mark.parametrize("fault", ["magic", "truncated", "version", "shape"])
def test_bad_artifacts_and_requests_raise(fault, root, tmp_path):
    _, path, _, _ = _artifacts("HGNN sum", root)
    raw = Path(path).read_bytes()
    bad = tmp_path / "bad.hgefsrv"
    if fault == "magic":
        bad.write_bytes(b"NOTHGEF!" + raw[8:])
        match = "bad magic"
    elif fault == "truncated":
        bad.write_bytes(raw[:10])
        match = "truncated"
    elif fault == "version":
        meta, payload = serve.read_artifact(path)
        hdr = json.dumps({**meta, "format_version": 2}).encode()
        bad.write_bytes(serve._MAGIC + len(hdr).to_bytes(4, "little") + hdr + payload)
        match = "newer"
    else:
        with pytest.raises(ValueError, match="serving input shape"):
            serve.ServingModel.load(path, device="cpu").predict(np.zeros((200, 5), np.float32))
        return
    with pytest.raises(ValueError, match=match):
        serve.ServingModel.load(str(bad), device="cpu")


def test_platforms(root):
    _, _, tr, _ = _artifacts("HGNN sum", root)
    with pytest.raises(ValueError, match="tpu"):
        serve.export_trainer(tr, platforms=["tpu"])
    assert serve.export_platforms(["gpu", "cpu", "cuda"], "cpu") == ["cuda", "cpu"]
    assert serve.export_platforms(None, "cpu") == ["cpu"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.export_trainer(tr, platforms=["cuda"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.ServingModel.load(_artifacts("HGNN sum", root)[1])
    _, path, _, _ = _artifacts("HGNN sum", root)
    with pytest.raises(ValueError, match="no cuda program"):
        serve._program(serve.read_artifact(path)[1], "cuda", path)


def test_fresh_process_loads_without_model_code(root):
    path = _artifacts("UniGCNII", root)[1]
    x = _graphs()[2]
    want = serve.ServingModel.load(path, device="cpu").predict(x).numpy()
    np.save(os.path.join(root, "x.npy"), x)
    code = (
        "import sys, numpy as np\n"
        "from hypergef_tpu_torch.serve import ServingModel\n"
        f"m = ServingModel.load({path!r}, device='cpu')\n"
        f"np.save({os.path.join(root, 'got.npy')!r}, "
        f"m.predict(np.load({os.path.join(root, 'x.npy')!r})).numpy())\n"
        "print(sorted(k for k in sys.modules if k.startswith(('hypergef_tpu_torch.models', "
        "'hypergef_tpu_torch.train', 'hypergef_tpu.', 'jax'))))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert np.array_equal(np.load(os.path.join(root, "got.npy")), want)
