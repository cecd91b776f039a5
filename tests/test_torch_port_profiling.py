"""The port's ``utils/profiling.py`` and ``experiments/fig8.py`` against the
JAX package's, on the CPU.

``cost_analysis`` counts eager aten ops as XLA's cost model counts HLO ops:
on a single op it gives XLA's bytes and flops exactly, except that XLA
prices a gather's index clamping (300 flops for 100 ids) and the port counts
an index op as 0 flops. Each hand-written kernel is one op of its declared
count: on the CPU its wrapper runs the plain twin, and none of the twin's
ops is counted. The kernel bounds that ``chip_smoke.py`` imports from the
module keep their values (pinned here on a small stage).
"""

import dataclasses
import glob
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypergef_tpu.utils import profiling as jprofiling

from hypergef_tpu_torch import probes
from hypergef_tpu_torch.data.synthetic import random_features, random_hypergraph
from hypergef_tpu_torch.experiments import fig8
from hypergef_tpu_torch.ops import (
    aligned_band, aligned_max, bitstream, ell_gather, fused_dense, segment_sum,
)
from hypergef_tpu_torch.sparse import planner
from hypergef_tpu_torch.sparse.planner import pack_nibbles
from hypergef_tpu_torch.utils import graphs, profiling

from test_torch_port_cuda import _operands, sorted_community_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"^(\w+),(\w+),bytes=\d+,flops=\d+,ratio=\d+\.\d{3}$")


def _single_ops():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 32)).astype(np.float32)
    b = rng.normal(size=(32, 16)).astype(np.float32)
    i = rng.integers(0, 64, size=100).astype(np.int32)
    return {"matmul": (lambda a, b: a @ b, (a, b)), "add": (lambda a: a + 1.0, (a,)),
            "index": (lambda a, i: a[i], (a, i))}


@pytest.fixture(scope="module")
def jax_single():
    return {name: jprofiling.cost_analysis(fn, *map(jnp.asarray, args))
            for name, (fn, args) in _single_ops().items()}


@pytest.fixture(scope="module")
def jax_fig8(tmp_path_factory):
    """JAX's fig8 on cora, its CSV lines."""
    out = tmp_path_factory.mktemp("jfig8") / "f.csv"
    r = subprocess.run([sys.executable, os.path.join(ROOT, "experiments", "fig8.py"),
                        "--configs", "cora", "--out", str(out)],
                       env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    return out.read_text().splitlines()


@pytest.mark.parametrize("name", ["matmul", "add", "index"])
def test_single_op_counts_equal_xla(jax_single, name):
    fn, args = _single_ops()[name]
    got = profiling.cost_analysis(fn, *map(torch.as_tensor, args), device="cpu")
    want = jax_single[name]
    assert got["bytes accessed"] == want["bytes accessed"]
    # XLA prices the gather's index clamping; an index op is 0 flops here
    assert got["flops"] == (0.0 if name == "index" else want["flops"])
    assert len(got["ops"]) == 1 and got["kernels"] == {} and got["devices"] == ["cpu"]


def test_traffic_report_has_jax_keys_and_ratios():
    _, (a, b) = _single_ops()["matmul"]

    def steps(b):
        return {"mm": lambda a: a @ b, "add": lambda a: a + 1.0, "both": lambda a: a @ b + 1.0}

    want = jprofiling.traffic_report(steps(jnp.asarray(b)), jnp.asarray(a))
    got = profiling.traffic_report(steps(torch.as_tensor(b)), torch.as_tensor(a), device="cpu")
    # keys, ratios and numbers: XLA's are the port's on these three
    assert got == want


def test_the_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.cost_analysis(lambda: torch.ones(3) + 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace("unused"):
            pass
    with pytest.raises(RuntimeError, match="no op"):
        profiling.cost_analysis(lambda: None, device="cpu")


# ------------------------------------------------------------- the kernels
def _aligned_stages():
    """(edge, vertex) stages of a small community graph's kernel-form plan,
    on the CPU."""
    plan = planner.plan_aligned(sorted_community_graph(600, 400, 6, 8, 0.02, 5))
    return dataclasses.replace(plan, form="pallas_auto").device("cpu")


def _x(n, f, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32))


def _nb(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _case_fused(packed):
    h, x, se, sv = _operands(301, 187, 17, 0.05, seed=4, device="cpu")
    n, f, e = 301, 17, 187
    hh = torch.as_tensor(pack_nibbles(h.numpy())) if packed else h
    name = "fused_dense_two_stage_packed" if packed else "fused_dense_two_stage"
    return (lambda: fused_dense.fused_dense_two_stage(hh, x, se, sv, packed=packed), name,
            4 * n * e * f + e * f + n * f, _nb(hh, x, se, sv) + n * f * 4)


def _case_v2e():
    h, x, _, _ = _operands(301, 187, 17, 0.05, seed=4, device="cpu")
    return (lambda: fused_dense._v2e(h, x, 187, False), "fused_dense_v2e",
            2 * 301 * 187 * 17, _nb(h, x) + 187 * 17 * 4)


def _case_ell():
    rng = np.random.default_rng(5)
    gidx = rng.integers(0, 90, size=(40, 8))
    mask = (rng.random((40, 8)) < 0.7).astype(np.float32)
    table = ell_gather.GatherTable(torch.as_tensor(gidx.astype(np.int32)),
                                   torch.as_tensor(gidx), torch.as_tensor(mask), 90)
    x = _x(90, 6, 1)
    return (lambda: ell_gather.ell_gather_sum(x, table), "ell_gather_sum", 2 * 40 * 8 * 6,
            _nb(x, table.gidx, table.mask) + 40 * 6 * 4)


def _csr(seed):
    hg = random_hypergraph(120, 70, avg_edge_size=4.0, seed=seed)
    return hg, hg.device_data("cpu")


def _case_segsum():
    hg, hgd = _csr(3)
    table = segment_sum.SegmentTable.build(hg.ht_indptr, hg.ht_indices, hg.num_nodes, "cpu")
    x = _x(hg.num_nodes, 5, 2)
    return (lambda: segment_sum.gather_segment_sum(x, table), "gather_segment_sum",
            table.nnz * 5, _nb(x, table.indptr, table.gather) + hg.num_edges * 5 * 4)


def _case_record():
    hg, hgd = _csr(4)
    record = hgd.record
    e2v = record.e2v
    g = _x(hg.num_edges, 5, 3)
    arg = torch.as_tensor(np.random.default_rng(4).integers(
        0, hg.num_nodes, size=(hg.num_edges, 5)).astype(np.int32))
    return (lambda: segment_sum.record_routed_dx(g, arg, record), "record_routed_dx",
            3 * e2v.nnz * 5, _nb(g, arg, e2v.indptr, e2v.gather) + hg.num_nodes * 5 * 4)


def _stage_case(which):
    st = _aligned_stages()[0]
    t = st.band
    tables = _nb(t.band, t.win, t.spill, t.src, t.groups)
    entries = t.band.numel() + t.spill.numel()
    s, f = st.num_segments, 7
    x = _x(st.num_inputs, f, 6)
    if which == "band":
        return (lambda: aligned_band.aligned_band(x, st), "aligned_band", 2 * entries * f,
                tables + _nb(x) + s * f * 4)
    if which == "argmax":
        return (lambda: aligned_max.aligned_masked_argmax(x, st), "aligned_masked_argmax",
                entries * f, tables + _nb(x) + 2 * s * f * 4)
    arg = torch.as_tensor(np.random.default_rng(7).integers(
        0, s, size=(st.num_inputs, f)).astype(np.int32))
    return (lambda: aligned_max.aligned_masked_argsum(x, arg, st), "aligned_masked_argsum",
            3 * entries * f, tables + _nb(x, arg) + s * f * 4)


def _case_bitmm():
    hg, _ = _csr(5)
    pack = bitstream.BitIncidence.from_hypergraph(hg).device("cpu")[0]
    pack = bitstream.BitPack(torch.as_tensor(pack.words), pack.m, pack.k)
    x = _x(pack.k, 4, 8)
    return (lambda: bitstream.bitmm(pack, x), "bitmm", 2 * pack.m * pack.k * 4,
            _nb(pack.words, x) + pack.m * 4 * 4)


def _case_probe(which):
    x = _x(90, 8, 9)
    rng = np.random.default_rng(10)
    idx = torch.as_tensor(rng.integers(0, 90, size=33).astype(np.int32))
    if which == "row_gather":
        return lambda: probes.row_gather(x, idx), "row_gather", 0, _nb(x, idx) + 33 * 8 * 4
    if which == "scaled_copy":
        return lambda: probes.scaled_copy(x, 0.5), "scaled_copy", x.numel(), 2 * _nb(x)
    gidx = torch.as_tensor(rng.integers(0, 90, size=(12, 5)).astype(np.int32))
    mask = torch.as_tensor((rng.random((12, 5)) < 0.6).astype(np.float32))
    if which == "chunk_masked_sum":
        g = _x(12 * 5, 8, 11).view(12, 5, 8)
        return (lambda: probes.chunk_masked_sum(g, mask), "chunk_masked_sum",
                2 * g.numel(), _nb(g, mask) + 12 * 8 * 4)
    return (lambda: probes.chunk_masked_sum_ring(x, gidx, mask, 4), "chunk_masked_sum_ring",
            2 * 12 * 5 * 8, _nb(x, gidx, mask) + 12 * 8 * 4)


KERNEL_CASES = {
    "fused_dense_two_stage": lambda: _case_fused(False),
    "fused_dense_two_stage_packed": lambda: _case_fused(True),
    "fused_dense_v2e": _case_v2e,
    "ell_gather_sum": _case_ell,
    "gather_segment_sum": _case_segsum,
    "record_routed_dx": _case_record,
    "aligned_band": lambda: _stage_case("band"),
    "aligned_masked_argmax": lambda: _stage_case("argmax"),
    "aligned_masked_argsum": lambda: _stage_case("argsum"),
    "bitmm": _case_bitmm,
    "row_gather": lambda: _case_probe("row_gather"),
    "chunk_masked_sum": lambda: _case_probe("chunk_masked_sum"),
    "chunk_masked_sum_ring": lambda: _case_probe("ring"),
    "scaled_copy": lambda: _case_probe("scaled_copy"),
}


@pytest.mark.parametrize("kernel", list(KERNEL_CASES))
def test_a_kernel_counts_as_its_declared_op(kernel):
    """On the CPU the wrapper runs its plain twin, and the count holds the
    kernel's declared count alone: no aten op of the twin."""
    call, name, flops, moved = KERNEL_CASES[kernel]()
    got = profiling.cost_analysis(call, device="cpu")
    assert got["ops"] == {}, got["ops"]
    assert got["kernels"] == {name: {"count": 1, "flops": flops, "bytes": moved}}
    assert (got["kernel_ops"], got["flops"], got["bytes accessed"]) == (1, flops, moved)


# the kernel ops of one eager training step (2 layers, HGNN sum): a layer's
# aggregation is two products forward and their adjoints backward
STEP_KERNELS = {"pallas": {"fused_dense_two_stage": 4},
                "cumsum": {"gather_segment_sum": 8},
                "aligned": {"aligned_band": 8},
                "bitstream": {"bitmm": 8}}


@pytest.mark.parametrize("route", list(STEP_KERNELS))
def test_a_training_step_counts_its_kernel_launches(route):
    """An eager step's kernel ops are the launches chip_smoke counts on the
    card for the same step; every other op is an aten op."""
    from hypergef_tpu_torch.train.splits import rand_train_test_idx
    from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer

    hg = sorted_community_graph(600, 400, 6, 8, 0.02, 5)
    x, y = random_features(hg.num_nodes, 12, 3, seed=1)
    plan = None
    if route == "aligned":
        plan = planner.AggregationPlan(
            aligned=dataclasses.replace(planner.plan_aligned(hg), form="pallas_auto"))
    cfg = TrainConfig(model="HGNN", nhid=8, nlayer=2, backend=route)
    tr = Trainer(cfg, hg, x, y, plan=plan, device="cpu")
    idx = tr._index(rand_train_test_idx(y, seed=2)["train"])
    got = profiling.cost_analysis(tr.step, idx, device="cpu")
    assert {k: v["count"] for k, v in got["kernels"].items()} == STEP_KERNELS[route]
    assert got["kernel_ops"] == sum(STEP_KERNELS[route].values())
    assert any(name.startswith("aten.mm") or name.startswith("aten.addmm")
               for name in got["ops"])
    assert not any(name.startswith("hypergef_torch") for name in got["ops"])


def test_a_graph_recording_or_replay_is_refused_in_a_count():
    with pytest.raises(RuntimeError, match="compiled=False"):
        profiling.cost_analysis(lambda: graphs.Captured(lambda: None, "cpu"), device="cpu")
    fake = types.SimpleNamespace(graph=None, replays=0, out=None)
    with pytest.raises(RuntimeError, match="replay"):
        profiling.cost_analysis(lambda: graphs.Captured.replay(fake), device="cpu")
    assert profiling._open is None


def test_three_cpu_traces_in_one_process(tmp_path):
    x = _x(50, 8, 0)
    for i in range(3):
        with profiling.trace(str(tmp_path / str(i)), device="cpu"):
            torch.mm(x, x.t()).sum()
        (path,) = glob.glob(str(tmp_path / str(i) / "trace-*.json"))
        events = json.load(open(path))["traceEvents"]
        assert any("aten::mm" in str(e.get("name")) for e in events), i


@pytest.mark.parametrize("before", [None, "0"])
def test_a_session_sets_cuptis_teardown_only_while_it_runs(monkeypatch, before):
    """A session asks libkineto to detach CUPTI at its stop, lazily
    re-attached (``TEARDOWN_CUPTI=1``, ``DISABLE_CUPTI_LAZY_REINIT`` unset),
    and puts back the process's own values after it."""
    for key in ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT"):
        if before is None:
            monkeypatch.delenv(key, raising=False)
        else:
            monkeypatch.setenv(key, before)
    seen = {}
    with profiling.profiler(cuda=False):
        seen = {k: os.environ.get(k) for k in ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT")}
        torch.ones(3).sum()
    assert seen == {"TEARDOWN_CUPTI": "1", "DISABLE_CUPTI_LAZY_REINIT": None}
    for key in ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT"):
        assert os.environ.get(key) == before, key


# ----------------------------------------------------------------- the bounds
def test_bounds_keep_their_values():
    """``bound`` and ``band_bound`` (moved from chip_smoke.py, which imports
    them) give the numbers they gave: data-sheet rates, bytes once."""
    import chip_smoke

    assert chip_smoke.bound is profiling.bound and chip_smoke.band_bound is profiling.band_bound
    assert profiling.bound(3_350_000, 67_000) == {
        "bound_ms": 0.001, "bound_by": "bytes", "bytes": 3_350_000, "ops": 67_000}
    assert profiling.bound(10, 6_700_000_000)["bound_ms"] == pytest.approx(0.1, rel=1e-12)
    st = _aligned_stages()[0]
    st = dataclasses.replace(st, band=st.band.with_kernel_layout())
    t = st.band
    got = profiling.band_bound(st, 32)
    moved = _nb(t.band, t.win, t.spill, t.src, t.groups) + (st.num_inputs + st.num_segments) * 128
    assert got["bytes"] == moved and got["ops"] == 2 * t.tiles.numel() * 32
    assert got["bound_ms"] == max(moved / 3.35e12, got["ops"] / 989e12) * 1e3
    assert planner.H100_STREAM_BPS == 3.35e12 and planner.H100_BF16_TC_OPS_PER_S == 989e12


# ------------------------------------------------------------------- fig8
def test_fig8_has_jax_routes_and_line_format(tmp_path, jax_fig8):
    rows = fig8.main(["--configs", "cora", "--device", "cpu", "--out", str(tmp_path / "f.csv")])
    lines = (tmp_path / "f.csv").read_text().splitlines()
    assert lines[0] == "# host clock, cpu"
    body = [ln for ln in jax_fig8 if not ln.startswith("#")]
    assert all(LINE.match(ln) for ln in body + lines[1:]), lines
    routes = [ln.split(",")[1] for ln in body]
    assert [ln.split(",")[1] for ln in lines[1:]] == routes == ["xla", "cumsum", "tree", "dense"]
    assert [r["route"] for r in rows] == routes and rows[0]["ratio"] == 1.0
    # the xla route's eager ops do the flops XLA counts for it, and the
    # cumsum route's kernel declares the same sums
    assert lines[1].split(",")[3] == body[0].split(",")[3] == lines[2].split(",")[3]


def test_fig8_runs_on_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fig8.main(["--configs", "cora", "--out", str(tmp_path / "x.csv")])
    assert not (tmp_path / "x.csv").exists()
