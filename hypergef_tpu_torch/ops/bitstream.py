"""The bitstream route: the bit-packed incidence product, CUDA kernel, twin.

Counterpart of ``hypergef_tpu/ops/bitstream.py``. The incidence matrix H is
0/1, so it is stored one bit per entry, in both orientations, and each
stage of the aggregation is one product

    out[r, f] = Σ_{c : A[r, c] = 1} bf16(x[c, f])      (f32 sums)

with A = Hᵀ (V→E) or A = H (E→V). The host half (:func:`pack_bits_csr`,
:class:`BitPack`, :class:`BitIncidence`, ``:45-141``) builds the packs as
NumPy, bit-equal to the JAX package's. The product comes in two forms:

* :func:`bitmm` runs the hand-written CUDA kernel (``csrc/bitstream.cu``,
  the counterpart of the Pallas kernel ``_bitmm_call``, ``:180-209``) on a
  CUDA tensor and the plain twin on a CPU tensor. On a CUDA tensor it
  launches the kernel or raises; it never falls back.
* :func:`bitmm_plain` unpacks the pack in row blocks into f32 0/1 and runs
  an f32 matmul against the bf16-rounded x: the products are exact and the
  sums f32, in the matmul's order. It never unpacks more than
  ``_PLAIN_BLOCK_ELEMS`` entries at once.

The kernel does not read the pack's words: it reads the pack's
:class:`BitLayout` (:func:`bit_layout`), its nonzero words only, with the
set bits before each row and the warp runs. A pack put on a CUDA device
(:meth:`BitIncidence.device`, :meth:`BitPack.to`) carries its layout beside
the words, which the twin keeps reading. The JAX package has no such table:
it is the kernel's layout of the same A.

:func:`bit_matvec` is the autograd op (``:226-244``): its backward is the
same product with the packs swapped, on the bf16-rounded cotangent.
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from hypergef_tpu_torch.ops import library
from hypergef_tpu_torch.ops.fused_dense import bf16_round
from hypergef_tpu_torch.ops.segment_sum import warp_runs
from hypergef_tpu_torch.utils import profiling

launches = 0

_LANE = 128
_PLANES = 32
KTILE = _PLANES * _LANE  # 4096 bits per packed lane-row block
_DEF_TM = 256  # the JAX kernel's output rows per grid step: the packs' row padding
_INT32_MAX = 2**31 - 1
# entries of A unpacked at once by the plain twin: 128 MB of f32 (and as much
# of int32 planes), so a stage of a 10^5 x 10^5 graph stays under 1 GB
_PLAIN_BLOCK_ELEMS = 1 << 25
# the kernel's warp runs (csrc/bitstream.cu): a run of several rows costs
# (set bits + rows) about a share, the largest of RUN_SHARES that still cuts
# the pack into RUN_FILL warps an SM (a large pack runs fewer, fuller warps;
# a small one still fills the card); a row costing more than RUN_ALONE has a
# run of its own. A run of several rows so holds at most max(RUN_SHARES) +
# RUN_ALONE - 3 set bits and max(RUN_SHARES) rows, within the kernel's kCols
# (128) and kMaxRows (96)
RUN_SHARES = (32, 64, 96)
RUN_ALONE = 32
RUN_FILL = 64  # warps an SM: about twice those the kernel keeps resident


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_bits_csr(indptr: np.ndarray, indices: np.ndarray, m: int, k: int) -> np.ndarray:
    """Pack a 0/1 CSR matrix [m, k] into the per-K-tile bit-plane layout
    (``:55-72``): int32 [m, (kp // KTILE) * 128] with
    ``word[r, kt*128 + j]`` bit b == ``A[r, kt*4096 + b*128 + j]``. Works
    straight off the CSR arrays; never densifies."""
    kp = _round_up(max(k, 1), KTILE)
    kt = kp // KTILE
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    cols = np.asarray(indices, dtype=np.int64)
    ktile = cols >> 12  # / 4096
    r = cols & (KTILE - 1)
    b = (r >> 7).astype(np.uint32)  # / 128 -> plane
    j = r & (_LANE - 1)
    words = np.zeros((m, kt * _LANE), dtype=np.uint32)
    np.bitwise_or.at(words, (rows, ktile * _LANE + j), np.uint32(1) << b)
    return words.view(np.int32)


def _popcount(words: np.ndarray) -> np.ndarray:
    """Set bits of each uint32 word (the SWAR count)."""
    v = words - ((words >> 1) & np.uint32(0x55555555))
    v = (v & np.uint32(0x33333333)) + ((v >> 2) & np.uint32(0x33333333))
    v = (v + (v >> 4)) & np.uint32(0x0F0F0F0F)
    return ((v * np.uint32(0x01010101)) >> 24).astype(np.int64)


def run_share(cost: int, sms: Optional[int]) -> int:
    """The share of a pack whose rows cost ``cost`` (set bits + rows) on a
    card of ``sms`` SMs: the largest of RUN_SHARES that cuts it into at
    least RUN_FILL warps an SM, else the smallest (with no card, ``None``:
    the smallest)."""
    if sms is None:
        return RUN_SHARES[0]
    return next((s for s in sorted(RUN_SHARES, reverse=True) if cost // s >= RUN_FILL * sms),
                RUN_SHARES[0])


@dataclasses.dataclass(frozen=True)
class BitLayout:
    """The kernel's layout of one pack (``csrc/bitstream.cu``): its nonzero
    words only. NumPy on the host, tensors on a device (:meth:`to`)."""

    pairs: Any  # int32 [nw, 2]: (index of the word in its row, word), row by row, index ascending
    bit_ptr: Any  # int32 [m+1]: the set bits of the rows before each row
    runs: Any  # int32 [W+1, 4]: each warp run's first row, first set bit, first pair, 0
    share: int  # the runs' share (run_share)
    build_s: float  # host seconds to build it from the pack

    def nbytes(self) -> int:
        return sum(int(a.nbytes) if isinstance(a, np.ndarray) else a.numel() * a.element_size()
                   for a in (self.pairs, self.bit_ptr, self.runs))

    def to(self, device) -> "BitLayout":
        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        return dataclasses.replace(self, pairs=put(self.pairs), bit_ptr=put(self.bit_ptr),
                                   runs=put(self.runs))


def bit_layout(words: np.ndarray, m: int, k: int, sms: Optional[int] = None) -> BitLayout:
    """The kernel's layout of the first ``m`` rows of the pack ``words`` (int32
    [mp, kt*128], NumPy) for a card of ``sms`` SMs: the nonzero words as
    (index, word) pairs, row by row in ascending index, with no bit of a
    column ≥ ``k`` (pack_bits_csr sets none; any such bit is cleared, so the
    kernel never reads past x); ``bit_ptr``; and ``segment_sum.warp_runs``
    over ``bit_ptr`` (a run costs its set bits + rows, about
    :func:`run_share`; a row of more than ``RUN_ALONE`` has a run of its
    own), with each run's first pair."""
    t0 = time.perf_counter()
    w = np.ascontiguousarray(words[:m]).view(np.uint32)
    per_row = w.shape[1]
    slot = np.arange(per_row)
    first_col = (slot // _LANE) * KTILE + slot % _LANE  # the column of bit 0 of each word
    planes = np.clip((k - first_col + _LANE - 1) // _LANE, 0, _PLANES)  # bits below column k
    mask = ((np.int64(1) << planes) - 1).astype(np.uint32)
    flat = np.flatnonzero(w)
    rows, idx = np.divmod(flat, per_row)
    vals = w.reshape(-1)[flat] & mask[idx]
    keep = vals != 0
    rows, idx, vals = rows[keep], idx[keep], vals[keep]
    bits = _popcount(vals)
    if bits.sum() > _INT32_MAX:
        raise ValueError(f"unsupported pack: {int(bits.sum())} set bits")
    bit_ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, weights=bits, minlength=m).astype(np.int64), out=bit_ptr[1:])
    pair_ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=pair_ptr[1:])
    share = run_share(int(bit_ptr[-1]) + m, sms)
    first = warp_runs(bit_ptr, share, RUN_ALONE)
    runs = np.zeros((first.shape[0], 4), dtype=np.int32)
    runs[:, :2] = first
    runs[:, 2] = pair_ptr[first[:, 0]]
    pairs = np.stack([idx.astype(np.int32), vals.view(np.int32)], axis=1)
    return BitLayout(pairs, bit_ptr.astype(np.int32), runs, share, time.perf_counter() - t0)


@dataclasses.dataclass(frozen=True)
class BitPack:
    """One orientation of the packed incidence: A [m, k] as bit words
    (``:75-97``). ``words`` is int32 [mp, (kp // KTILE) * 128]: a NumPy array
    on the host, a tensor in the packs that :meth:`to` and
    :meth:`BitIncidence.device` return, which on a CUDA device also carry
    the kernel's ``layout``."""

    words: Any
    m: int
    k: int
    layout: Optional[BitLayout] = None

    @property
    def mp(self) -> int:
        return int(self.words.shape[0])

    @property
    def kp(self) -> int:
        return (int(self.words.shape[1]) // _LANE) * KTILE

    def to(self, device) -> "BitPack":
        """This host pack on ``device``, checked; on a CUDA device with the
        kernel's layout, built here from the host words."""
        device = torch.device(device)
        words = np.ascontiguousarray(self.words)
        layout = None
        if device.type == "cuda":
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            layout = bit_layout(words, self.m, self.k, sms).to(device)
        pack = BitPack(torch.as_tensor(words, device=device), self.m, self.k, layout)
        _check_pack(pack)
        return pack


def _check_pack(pack: BitPack) -> None:
    """What the kernel and the twin take of a device pack, checked once."""
    w = pack.words
    if w.dtype != torch.int32 or w.dim() != 2 or w.shape[1] % _LANE != 0 or w.shape[1] == 0:
        raise TypeError(f"words must be int32 [mp, kt*128], got {w.dtype} {tuple(w.shape)}")
    if not w.is_contiguous():
        raise ValueError("words must be contiguous")
    if not (0 < pack.m <= pack.mp and 0 < pack.k <= pack.kp) or max(pack.mp, pack.kp) > _INT32_MAX:
        raise ValueError(
            f"unsupported pack: m={pack.m}, k={pack.k}, words {tuple(w.shape)}")


@dataclasses.dataclass
class BitIncidence:
    """Both orientations of H packed as bit tables (the bitstream plan,
    ``:100-141``). ``h_pack`` encodes H [N, E] (the E→V stage), ``ht_pack``
    Hᵀ [E, N] (V→E). The host words are NumPy; :meth:`device` puts both
    packs on a device once and caches them per device."""

    h_pack: BitPack
    ht_pack: BitPack
    num_nodes: int
    num_edges: int
    _device: Dict[torch.device, Tuple[BitPack, BitPack]] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @classmethod
    def from_hypergraph(cls, hg) -> "BitIncidence":
        csr = hg.to_scipy().tocsr()
        if csr.data.size and int(csr.data.max()) > 1:
            raise ValueError(
                "bitstream backend needs a binary incidence matrix "
                "(duplicate (vertex, edge) pairs present)"
            )
        n, e = csr.shape
        csc = csr.T.tocsr()
        h_words = pack_bits_csr(csr.indptr, csr.indices, n, e)
        ht_words = pack_bits_csr(csc.indptr, csc.indices, e, n)

        def _pad_rows(w, m):
            mp = _round_up(m, _DEF_TM)
            if mp != m:
                w = np.pad(w, ((0, mp - m), (0, 0)))
            return w

        return cls(
            h_pack=BitPack(_pad_rows(h_words, n), n, e),
            ht_pack=BitPack(_pad_rows(ht_words, e), e, n),
            num_nodes=n,
            num_edges=e,
        )

    def table_bytes(self) -> int:
        return self.h_pack.words.size * 4 + self.ht_pack.words.size * 4

    def device(self, device) -> Tuple[BitPack, BitPack]:
        """(H pack, Hᵀ pack) with their words on ``device`` (and on a CUDA
        device the kernel's layouts), put there and checked once per
        device."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._device:
            self._device[device] = (self.h_pack.to(device), self.ht_pack.to(device))
        return self._device[device]


def unpack_rows(words: torch.Tensor) -> torch.Tensor:
    """int32 words [R, kt*128] → f32 0/1 [R, kt*4096] (column kt*4096 +
    b*128 + j is bit b of word kt*128 + j)."""
    r, nw = words.shape
    kt = nw // _LANE
    shifts = torch.arange(_PLANES, dtype=torch.int32, device=words.device).view(1, 1, _PLANES, 1)
    planes = (words.view(r, kt, 1, _LANE) >> shifts) & 1  # [R, kt, plane, lane]
    return planes.reshape(r, kt * KTILE).to(torch.float32)


def bitmm_plain(words, x, m: int, k: int, block_elems: int = _PLAIN_BLOCK_ELEMS):
    """The kernel's function in plain torch (any device): rows of the pack
    unpacked a block at a time, each block an f32 matmul against bf16(x)."""
    kp = (words.shape[1] // _LANE) * KTILE
    xb = bf16_round(x)
    rows = max(1, block_elems // kp)
    out = torch.empty((m, x.shape[1]), dtype=torch.float32, device=x.device)
    for r0 in range(0, m, rows):
        r1 = min(m, r0 + rows)
        out[r0:r1] = unpack_rows(words[r0:r1])[:, :k] @ xb
    return out


def launch_kernel(x, pairs, bit_ptr, runs, m: int, k: int):
    """The kernel over a pack's layout (:class:`BitLayout` on the card) of
    A [m, k]: the CUDA implementation of the ``bitmm`` op (:mod:`.library`)."""
    global launches
    from hypergef_tpu_torch.ops import _build
    from hypergef_tpu_torch.ops.aligned_band import raise_on_error
    from hypergef_tpu_torch.ops.segment_sum import layout

    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if runs.device != dev:
        raise ValueError(f"the pack's layout is on {runs.device}, x on {dev}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != k:
        raise TypeError(f"x must be f32 [{k}, F], got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    f = x.shape[1]
    if f <= 0 or f > _INT32_MAX // max(k, m):
        raise ValueError(f"unsupported width F={f}")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(
            f"the kernel is built for sm_90a (Hopper); {torch.cuda.get_device_name(dev)} "
            f"is sm_{''.join(map(str, torch.cuda.get_device_capability(dev)))}"
        )
    lib = _build.load_library()
    out = torch.empty((m, f), dtype=torch.float32, device=dev)
    width, lanes = layout(f, [x, out])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hg_bitmm(pairs.data_ptr(), bit_ptr.data_ptr(), runs.data_ptr(),
                           x.data_ptr(), out.data_ptr(), runs.shape[0] - 1, f, lanes, width,
                           stream)
    raise_on_error(err, lib, "bitmm")
    launches += 1
    return out


def _launch(pack: BitPack, x):
    dev = x.device
    if pack.words.device != dev:
        raise ValueError(f"the pack is on {pack.words.device}, x on {dev}")
    _check_pack(pack)
    lay = pack.layout
    if lay is None:
        raise ValueError("the pack has no kernel layout: put it on the card with "
                         "BitIncidence.device (or BitPack.to)")
    return library.OPS["bitmm"](x, None, lay.pairs, lay.bit_ptr, lay.runs, pack.m, pack.k)


def _cost(pack: BitPack, x):
    """The product of the dense [m, k] matrix the pack holds (its words are
    what both forms read from it)."""
    return "bitmm", (pack.words, x), 2 * pack.m * pack.k * x.shape[1]


@profiling.kernel(_cost)
def bitmm(pack: BitPack, x):
    """``A @ bf16(x)`` for the first ``pack.m`` rows of the pack: x f32
    [k, F] → f32 [m, F].

    On CUDA tensors this launches the kernel over the pack's layout, through
    the ``bitmm`` op (:mod:`.library`; a pack without a layout raises); on
    CPU tensors it runs :func:`bitmm_plain` on the words. It carries no
    autograd rule of its own, so it refuses an ``x`` that requires grad:
    differentiate through :func:`bit_matvec`, whose backward swaps the
    packs.
    """
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            "bitmm has no autograd rule: differentiate through bit_matvec, whose "
            "backward is the product with the other pack")
    if x.device.type == "cpu":
        if pack.words.device.type != "cpu":
            raise ValueError(f"x is on the CPU but the pack is on {pack.words.device}")
        return bitmm_plain(pack.words, x, pack.m, pack.k)
    return _launch(pack, x)


class _BitMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd_pack, bwd_pack):
        ctx.packs = (fwd_pack, bwd_pack)
        return bitmm(fwd_pack, x.contiguous())

    @staticmethod
    def backward(ctx, g):
        fwd_pack, bwd_pack = ctx.packs
        return bit_matvec(g, bwd_pack, fwd_pack), None, None


def bit_matvec(x, fwd_pack: BitPack, bwd_pack: BitPack):
    """``y = A bf16(x)`` with A the 0/1 matrix of ``fwd_pack`` (a device
    pack); ``bwd_pack`` encodes Aᵀ and drives the exact adjoint: the same
    product with the packs swapped, on bf16(g)."""
    return _BitMatvec.apply(x, fwd_pack, bwd_pack)


def hgnn_aggregate_bitstream(hgd, x, wdiag, first_aggr, bi: BitIncidence):
    """``out = degV · H · (degE·Wdiag) · (Hᵀ X)`` through two products
    (``:247-259``); sum or mean first aggregation. Max raises, as in JAX:
    the dispatcher routes it through the record table."""
    if first_aggr not in ("sum", "mean"):
        raise ValueError("bitstream implements first_aggr in {sum, mean}; "
                         "max routes to the argmax tree (ops/fused.py)")
    h_pack, ht_pack = bi.device(x.device)
    xe = bit_matvec(x, ht_pack, h_pack)
    if first_aggr == "mean":
        cnt = (hgd.ht_indptr[1:] - hgd.ht_indptr[:-1]).to(x.dtype)
        xe = xe / cnt.clamp_min(1.0)[:, None]
    xe = xe * hgd.degE
    if wdiag is not None:
        xe = xe * wdiag
    return bit_matvec(xe, h_pack, ht_pack) * hgd.degV


def unignn_aggregate_bitstream(hgd, x, use_deg: bool, bi: BitIncidence):
    """``H Hᵀ X``, or ``degV · H · degE · Hᵀ X`` with ``use_deg``
    (``:262-269``)."""
    h_pack, ht_pack = bi.device(x.device)
    xe = bit_matvec(x, ht_pack, h_pack)
    if use_deg:
        xe = xe * hgd.degE
    xv = bit_matvec(xe, h_pack, ht_pack)
    if use_deg:
        xv = xv * hgd.degV
    return xv
