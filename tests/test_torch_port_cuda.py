"""The port's CUDA kernel against its plain version, on the card.

Every test here needs an NVIDIA Hopper card and skips without one. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: rtol 1e-2 and atol 1e-2·max|plain|. Kernel and plain version
round the same operands to bf16, but sum in different orders, so Xe can
round to a neighbouring bf16 value (2^-8 relative) before the second stage.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from hypergef_tpu_torch.ops import fused_dense

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


def test_backward_raises(cuda):
    h, x, se, sv = _operands(64, 32, 8, 0.1, seed=0, device=cuda)
    x.requires_grad_(True)
    out = fused_dense.fused_dense_two_stage(h, x, se, sv)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out.sum().backward()


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
