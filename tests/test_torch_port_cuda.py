"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA Hopper card and skips without one. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances:

* fused dense op, forward and backward: rtol 1e-2 and atol 1e-2·max|plain|.
  Kernel and plain version round the same operands to bf16, but sum in
  different orders, so Xe can round to a neighbouring bf16 value (2^-8
  relative) before the second stage.
* gather kernel: bitwise equal to the sequential plain loop, which rounds
  each product and each sum in the same order.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from hypergef_tpu_torch.ops import ell_gather, fused_dense

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(n, e, f, density, seed, device):
    rng = np.random.default_rng(seed)
    h = (rng.random((n, e)) < density).astype(np.int8)
    h[rng.random((n, e)) < density / 8] = 3  # repeated incidences count too
    x = rng.normal(size=(n, f)).astype(np.float32)
    se = rng.uniform(0.1, 1.0, size=(e, 1)).astype(np.float32)
    sv = rng.uniform(0.1, 1.0, size=(n, 1)).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (h, x, se, sv)]


@pytest.mark.parametrize(
    "n,e,f,density",
    [
        (5, 3, 1, 0.5),
        (120, 80, 8, 0.06),
        (301, 187, 17, 0.03),
        (1000, 500, 4, 0.01),
        (2048, 300, 40, 0.02),
        (16242, 100, 32, 0.04),
    ],
)
def test_kernel_matches_plain(cuda, n, e, f, density):
    h, x, se, sv = _operands(n, e, f, density, seed=n + e + f, device=cuda)
    before = fused_dense.launches
    got = fused_dense.fused_dense_two_stage(h, x, se, sv)
    again = fused_dense.fused_dense_two_stage(h, x, se, sv)
    torch.cuda.synchronize()
    assert fused_dense.launches == before + 2
    want = fused_dense.fused_dense_two_stage_plain(h, x, se, sv)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2 * scale)
    assert torch.equal(got, again), "two runs differ"


@pytest.mark.parametrize("n,e,f,density", [(301, 187, 17, 0.03), (16242, 100, 4, 0.04)])
def test_backward_matches_plain_formula(cuda, n, e, f, density):
    h, x, se, sv = _operands(n, e, f, density, seed=n + f, device=cuda)
    g = torch.as_tensor(np.random.default_rng(f).normal(size=(n, f)).astype(np.float32),
                        device=cuda)
    ts = [t.clone().requires_grad_(True) for t in (x, se, sv)]
    out = fused_dense.fused_dense_two_stage(h, *ts)
    before = (fused_dense.launches, fused_dense.v2e_launches)
    out.backward(g)
    torch.cuda.synchronize()
    # dx and d scale_v run the op once each, d scale_e its first phase twice
    assert (fused_dense.launches, fused_dense.v2e_launches) == (before[0] + 2, before[1] + 2)
    for name, t, want in zip(("dx", "d_scale_e", "d_scale_v"), ts,
                             fused_dense.fused_dense_backward_plain(h, x, se, sv, g)):
        scale = float(want.abs().max())
        torch.testing.assert_close(t.grad, want, rtol=1e-2, atol=1e-2 * scale, msg=name)


def _gather_operands(n, c, ngs, f, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(n, f)).astype(np.float32), device=device)
    gidx = torch.as_tensor(rng.integers(0, n, size=(c, ngs)).astype(np.int32), device=device)
    mask = torch.as_tensor((rng.random((c, ngs)) > 0.2).astype(np.float32), device=device)
    table = ell_gather.GatherTable(gidx=gidx, gidx_long=gidx.long(), mask=mask, num_inputs=n)
    return x, table


@pytest.mark.parametrize(
    "n,c,ngs,f",
    [(300, 700, 8, 16), (50, 3, 1, 1), (1000, 777, 5, 3), (2000, 1500, 37, 32),
     (500, 300, 12, 33), (19717, 9000, 12, 4), (7963, 20000, 4, 32)],
)
def test_gather_kernel_is_bitwise_plain(cuda, n, c, ngs, f):
    x, table = _gather_operands(n, c, ngs, f, seed=n + c + f, device=cuda)
    before = ell_gather.launches
    got = ell_gather.ell_gather_sum(x, table)
    again = ell_gather.ell_gather_sum(x, table)
    torch.cuda.synchronize()
    assert ell_gather.launches == before + 2
    want = ell_gather.ell_gather_sum_plain(x, table.gidx_long, table.mask)
    assert got.shape == want.shape == (c, f)
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(got, again), "two runs differ"


def test_gather_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, table = _gather_operands(64, 32, 4, 8, seed=1, device=cuda)
    with pytest.raises(TypeError):
        ell_gather.ell_gather_sum(x.double(), table)
    with pytest.raises(TypeError):
        ell_gather.ell_gather_sum(x[:10], table)
    with pytest.raises(ValueError, match="contiguous"):
        ell_gather.ell_gather_sum(x.t().contiguous().t(), table)
    with pytest.raises(ValueError):
        ell_gather.ell_gather_sum(x.cpu(), table)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    h, x, se, sv = _operands(64, 32, 8, 0.1, seed=1, device=cuda)
    with pytest.raises(TypeError):
        fused_dense.fused_dense_two_stage(h.float(), x, se, sv)
    with pytest.raises(ValueError, match="contiguous"):
        fused_dense.fused_dense_two_stage(h, x.t().contiguous().t(), se, sv)
    with pytest.raises(ValueError):
        fused_dense.fused_dense_two_stage(h.cpu(), x, se, sv)


def test_chip_smoke_imports_and_reads_the_card():
    """Imported everywhere, so its helpers are import-checked on the CPU
    too; the card-reading part skips without a card."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main) and set(mod.GRAPHS) == {"20news", "pubmed_real"}
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert mod.card_line().split(",")[0].strip() == torch.cuda.get_device_name(0)
