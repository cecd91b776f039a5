"""The probe ports (``hypergef_tpu_torch.probes``) against the scripts' own
oracles, on the CPU.

Each probe of ``scripts/`` runs on the plain versions of its kernels at the
script's shapes (``probe_r2_gather.py`` at its tiny and pubmed scales; the
big one, 2M rows, runs on the card in ``chip_smoke.py``), and each case is
held against the script's NumPy oracle: bitwise for gathers and copies,
rtol 1e-5 and atol 1e-5·max for sums. ``probe_r2_gather.py``'s two Pallas
stages run on the CPU in interpret mode without editing the script
(``PROBE_INTERPRET=1``, the script loaded with importlib), so the port is
held against them as well.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergef_tpu_torch import probes
from hypergef_tpu_torch.ops import ell_gather

REPO = Path(__file__).resolve().parents[1]

# the case names each script's port must hold, one for each Pallas kernel
# (and, for probe_r2_gather, its XLA gather)
CASES = {
    "probe_r2_gather": {f"{s} {c}" for s in ("tiny", "pubmed") for c in (
        "pallas_vmem", "pallas_dma n_buf=4", "pallas_dma n_buf=8", "pallas_dma n_buf=16",
        "xla_gather direct", "xla_gather ring n_buf=4", "xla_gather ring n_buf=8",
        "xla_gather ring n_buf=16")},
    "probe_r2b_bisect": {
        "k0 x*2", "k1 one-row broadcast direct", "k1b one-row broadcast direct",
        "k2 static 8 rows ring n_buf=4", "k3 8 rows at a dynamic offset ring n_buf=4",
        "k4 single-row copy ring n_buf=4", "k5 two buffers n_buf=4",
        "k6 one copy a chunk ring n_buf=4", "k7 serial masked sum",
        "k7b concatenated masked sum", "k8_t128_mv0", "k8_t128_mv1", "k8_t256_mv0",
        "k8_t256_mv1", "k8_t512_mv0", "k8_t512_mv1", "k9_g4", "k9_g16_t128", "k11_g4_t512",
        "k11_g4_t256", "k10_n19968", "k10_n8192"},
    "pallas_probe": {"K1 take in kernel direct", "K2 fori dynamic-slice direct",
                     "K3 one-hot segment sum", "K4 DMA row pipeline ring n_buf=8",
                     "K6 ELL einsum partials"},
    "pallas_probe2": {"B take_along_axis direct", "C serial slice direct",
                      "D DMA pipeline ring n_buf=16", "E chunk masked sum",
                      "G one-hot segment sum"},
    "pallas_probe3": {"take F=32 nnz=85k direct", "take F=32 nnz=85k ring n_buf=4",
                      "take F=32 nnz=85k ring n_buf=8", "take F=32 nnz=85k ring n_buf=16",
                      "e_call chunk-sum", "oh_call one-hot TS=8 R=64"},
}


@pytest.mark.parametrize("name", list(probes.PROBES))
def test_probe_holds_against_the_script_oracle(name):
    kw = ({"scales": {s: probes.R2_SCALES[s] for s in ("tiny", "pubmed")}}
          if name == "probe_r2_gather" else {})
    before = (probes.row_gather_launches, probes.chunk_sum_launches,
              probes.scaled_copy_launches, ell_gather.launches)
    rows = probes.PROBES[name]("cpu", **kw)
    assert {r["case"] for r in rows} == CASES[name]
    bad = [(r["case"], r["max_abs_err"]) for r in rows if not r["ok"]]
    assert not bad
    # nothing launches and nothing is timed on the CPU
    assert all(r["launches"] == 0 and r["ms"] is None and r["library_ms"] is None
               for r in rows)
    assert before == (probes.row_gather_launches, probes.chunk_sum_launches,
                      probes.scaled_copy_launches, ell_gather.launches)


def test_broken_probe_is_noted():
    """pallas_probe2's e_call passes no mask; the port passes it and says so."""
    (row,) = [r for r in probes.pallas_probe2("cpu") if r["case"].startswith("E ")]
    assert "no mask" in row["note"]


@pytest.fixture(scope="module")
def r2_script():
    """scripts/probe_r2_gather.py in interpret mode, loaded as it stands."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PROBE_INTERPRET", "1")
    mp.setenv("JAX_COMPILATION_CACHE_DIR", str(REPO / "build" / "jax_cache_unused"))
    spec = importlib.util.spec_from_file_location("probe_r2_gather",
                                                  REPO / "scripts" / "probe_r2_gather.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    yield mod
    mp.undo()


def test_r2_gather_stages_match_the_pallas_stages_in_interpret_mode(r2_script):
    """The script's own verify (``:293-306``): tiny scale, 512-chunk blocks,
    four buffers for the DMA stage."""
    n, nnz, f = probes.R2_SCALES["tiny"]
    x, gidx, gmask = r2_script.build_case(n, nnz, f, seed=0)
    xj, gj, mj = jnp.asarray(x), jnp.asarray(gidx), jnp.asarray(gmask)
    vmem = np.asarray(r2_script.pallas_vmem_stage(xj, gj, mj, block_chunks=512))
    dma = np.asarray(r2_script.pallas_dma_stage(xj, gj, mj, block_chunks=512, n_buf=4))
    xt, gt, mt = torch.as_tensor(x), torch.as_tensor(gidx), torch.as_tensor(gmask)
    table = ell_gather.GatherTable(gidx=gt, gidx_long=gt.long(), mask=mt, num_inputs=n)
    got_vmem = ell_gather.ell_gather_sum(xt, table).numpy()
    got_dma = probes.chunk_masked_sum_ring(xt, gt, mt, 4).numpy()
    for got, want in ((got_vmem, vmem), (got_dma, dma)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_plain_versions_compute_the_constructs():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(50, 8)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, 50, size=70).astype(np.int32))
    assert torch.equal(probes.row_gather(x, idx, 4), x[idx.long()])
    g = torch.as_tensor(rng.normal(size=(9, 3, 8)).astype(np.float32))
    m = torch.as_tensor((rng.random((9, 3)) > 0.5).astype(np.float32))
    np.testing.assert_allclose(probes.chunk_masked_sum(g, m).numpy(),
                               np.einsum("cgf,cg->cf", g.numpy(), m.numpy()), rtol=1e-6,
                               atol=1e-6)
    gi = torch.as_tensor(rng.integers(0, 50, size=(9, 3)).astype(np.int32))
    assert torch.equal(probes.chunk_masked_sum_ring(x, gi, m, 8),
                       probes.chunk_masked_sum_plain(x[gi.long()], m))
    assert torch.equal(probes.scaled_copy(x, 2.0), x * 2)


def test_every_pallas_call_has_a_counterpart():
    """chip_smoke.py's kernels line names every ``pallas_call`` of the repo
    (file:line) in one kernel's ``replaces`` or ``also_replaces``."""
    import re

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sites = set()
    for root in ("hypergef_tpu", "scripts", "experiments"):
        for path in sorted((REPO / root).rglob("*.py")):
            for i, line in enumerate(path.read_text().splitlines(), 1):
                if re.search(r"\bpl\.pallas_call\(", line):
                    sites.add(f"{path.relative_to(REPO)}:{i}")
    named = [s for v in mod.KERNEL_SITES.values() for s in v]
    assert len(named) == len(set(named)) == 34
    assert set(named) == sites
