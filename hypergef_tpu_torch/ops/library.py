"""The forward kernels as ``torch.library`` custom ops.

A kernel wrapper reads its operands' ``data_ptr()`` and calls the kernel
library through ``ctypes``, which ``torch.export`` cannot trace: a fake
tensor has no data. Each forward kernel is therefore also an operator of
the ``hypergef_torch`` namespace, whose arguments are tensors and ints
only (the wrapper unpacks its table into them), with three
implementations, registered with ``torch.library.Library``, so a call
dispatches straight to them, without the Python autograd layer that
``torch.library.custom_op`` puts in front of every call (no op here has a
gradient of its own: the wrappers' autograd functions give it):

* CUDA: the kernel's launch as the wrapper made it before, with its
  checks, its ``launches`` count and its ``raise`` on any error;
* CPU: the kernel's plain twin, on the same arguments;
* fake: the output's shape and dtype only, all that ``torch.export``
  traces.

On a CUDA tensor the wrappers call these ops, so an exported program holds
one node a launch and runs the same kernels when it is loaded; on a CPU
tensor they call their plain twins as before. An op's CPU implementation
is the same function of the op's arguments, bitwise
(``tests/test_torch_port_export.py``).

| op | kernel (``csrc/``) | plain twin |
|---|---|---|
| ``fused_dense_two_stage`` | ``fused_dense.cu`` | ``fused_dense.fused_dense_two_stage_plain`` |
| ``fused_dense_two_stage_packed`` | ``fused_dense.cu`` (packed form) | the same, on ``planner.unpack_nibbles`` |
| ``ell_gather_sum`` | ``ell_gather.cu`` | ``ell_gather.ell_gather_sum_plain`` |
| ``aligned_band`` | ``aligned_band.cu`` | ``aligned_band.flat_band_plain`` |
| ``aligned_masked_argmax`` | ``aligned_max.cu`` | ``aligned_max.flat_max_plain`` |
| ``bitmm`` | ``bitstream.cu`` | ``bitstream.bitmm_plain`` |
| ``gather_segment_sum`` | ``segment_sum.cu`` | ``segment_sum.gather_segment_sum_plain`` |

The backward-only entries (the record-routed sum, the aligned arg-sum, the
dense V→E phase) and the probe kernels stay direct calls: no exported
forward reaches them. Importing this module registers the ops, and imports
no op module: each implementation imports its own lazily, so a serving
process that loads an exported program needs this module and nothing of
the models or the trainer.
"""

from __future__ import annotations

import torch

NAMESPACE = "hypergef_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")
OPS = {}


def _define(schema: str, cpu, cuda, fake) -> None:
    """Define the op of ``schema`` with its CPU, CUDA and fake implementations."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    OPS[name] = getattr(getattr(torch.ops, NAMESPACE), name).default


# ---------------------------------------------------------------- fused dense
# scale_v ⊙ (H @ bf16(scale_e ⊙ (Hᵀ @ bf16(x)))): h int8 [N, E], x f32 [N, F] → f32 [N, F]
def _fused_dense_cpu(h, x, scale_e, scale_v):
    from hypergef_tpu_torch.ops import fused_dense

    return fused_dense.fused_dense_two_stage_plain(h, x, scale_e, scale_v)


def _fused_dense_cuda(h, x, scale_e, scale_v):
    from hypergef_tpu_torch.ops import fused_dense

    return fused_dense._launch(h, x, scale_e, scale_v)


def _fused_dense_fake(h, x, scale_e, scale_v):
    return x.new_empty((h.shape[0], x.shape[1]))


_define("fused_dense_two_stage(Tensor h, Tensor x, Tensor scale_e, Tensor scale_v) -> Tensor",
        _fused_dense_cpu, _fused_dense_cuda, _fused_dense_fake)


# the same over the packed-int4 nibble carrier h [N, ceil(E/2)], E = scale_e's
# rows: an op of its own, since the carrier's shape cannot say it is one (at
# E = 1 it is the int8 table's)
def _fused_dense_packed_cpu(h, x, scale_e, scale_v):
    from hypergef_tpu_torch.ops import fused_dense
    from hypergef_tpu_torch.sparse.planner import unpack_nibbles

    return fused_dense.fused_dense_two_stage_plain(unpack_nibbles(h, scale_e.shape[0]), x,
                                                   scale_e, scale_v)


def _fused_dense_packed_cuda(h, x, scale_e, scale_v):
    from hypergef_tpu_torch.ops import fused_dense

    return fused_dense._launch(h, x, scale_e, scale_v, packed=True)


_define("fused_dense_two_stage_packed(Tensor h, Tensor x, Tensor scale_e, Tensor scale_v) "
        "-> Tensor", _fused_dense_packed_cpu, _fused_dense_packed_cuda, _fused_dense_fake)


# ------------------------------------------------------------------ ELL gather
# out[c] = Σ_k x[gidx[c, k]]·mask[c, k] in k order: gidx int32 [C, ngs],
# x f32 [num_inputs, F] → f32 [C, F]
def _ell_cpu(x, gidx, mask, num_inputs):
    from hypergef_tpu_torch.ops import ell_gather

    return ell_gather.ell_gather_sum_plain(x, gidx.long(), mask)


def _ell_cuda(x, gidx, mask, num_inputs):
    from hypergef_tpu_torch.ops import ell_gather

    return ell_gather._launch(x, gidx, mask, num_inputs)


_define("ell_gather_sum(Tensor x, Tensor gidx, Tensor mask, int num_inputs) -> Tensor",
        _ell_cpu, _ell_cuda,
        lambda x, gidx, mask, num_inputs: x.new_empty((gidx.shape[0], x.shape[1])))


# ------------------------------------------------------------ aligned stages
# one aligned stage over its BandTable's tensors: the kernel reads the tiles
# and work items, the twin the flat band and spill tables
def _band_cpu(x, win, src, groups, tiles, tile_off, work, band, spill, slots, group_rows,
              block_rows, num_inputs, num_segments):
    from hypergef_tpu_torch.ops import aligned_band

    if band is None or spill is None:
        raise ValueError("the plain band apply reads the flat band and spill tables")
    return aligned_band.flat_band_plain(x, band, win, spill, src, groups, group_rows,
                                        block_rows, num_segments)


def _band_cuda(x, win, src, groups, tiles, tile_off, work, band, spill, slots, group_rows,
               block_rows, num_inputs, num_segments):
    from hypergef_tpu_torch.ops import aligned_band

    if tiles is None or tile_off is None or work is None:
        raise ValueError("the band kernel reads the table's tiles and work items: build "
                         "the table on a CUDA device (BandTable.with_kernel_layout)")
    stage = aligned_band.KernelStage(tiles=tiles, tile_off=tile_off, win=win, src=src,
                                     groups=groups, group_rows=group_rows,
                                     block_rows=block_rows, num_inputs=num_inputs,
                                     num_segments=num_segments)
    return aligned_band.launch_kernel(x, stage, work, slots)


_define("aligned_band(Tensor x, Tensor win, Tensor src, Tensor groups, Tensor? tiles, "
        "Tensor? tile_off, Tensor? work, Tensor? band, Tensor? spill, int slots, "
        "int group_rows, int block_rows, int num_inputs, int num_segments) -> Tensor",
        _band_cpu, _band_cuda,
        lambda x, *args: x.new_empty((args[-1], x.shape[1])))


# (val f32 [S, F], arg int32 [S, F]) of the masked argmax over one aligned
# stage: the kernel reads the live layout (slots as an int16 view of its
# uint16 table), the twin the flat band and spill tables
def _argmax_cpu(x, win, src, groups, chunks, group_chunks, row_ptr, slots, items, band, spill,
                group_rows, block_rows, num_inputs, num_segments):
    from hypergef_tpu_torch.ops import aligned_max

    if band is None or spill is None:
        raise ValueError("the plain masked argmax reads the flat band and spill tables")
    return aligned_max.flat_max_plain(x, band, win, spill, src, groups, group_rows,
                                      block_rows, num_inputs, num_segments)


def _argmax_cuda(x, win, src, groups, chunks, group_chunks, row_ptr, slots, items, band, spill,
                 group_rows, block_rows, num_inputs, num_segments):
    from hypergef_tpu_torch.ops import aligned_max

    live = (chunks, group_chunks, row_ptr, slots, items)
    if any(t is None for t in live):
        raise ValueError("the masked argmax kernel reads the stage's live layout: build the "
                         "table on a CUDA device (BandTable.with_kernel_layout)")
    return aligned_max.launch_argmax(x, src, groups, *live, group_rows, num_inputs,
                                     num_segments)


def _argmax_fake(x, *args):
    shape = (args[-1], x.shape[1])
    return x.new_empty(shape), x.new_empty(shape, dtype=torch.int32)


_define("aligned_masked_argmax(Tensor x, Tensor win, Tensor src, Tensor groups, "
        "Tensor? chunks, Tensor? group_chunks, Tensor? row_ptr, Tensor? slots, "
        "Tensor? items, Tensor? band, Tensor? spill, int group_rows, int block_rows, "
        "int num_inputs, int num_segments) -> (Tensor, Tensor)",
        _argmax_cpu, _argmax_cuda, _argmax_fake)


# ---------------------------------------------------------------------- bitmm
# A @ bf16(x) over a bit pack of A [m, k]: the kernel reads the pack's layout
# (pairs, bit_ptr, runs), the twin its words
def _bitmm_cpu(x, words, pairs, bit_ptr, runs, m, k):
    from hypergef_tpu_torch.ops import bitstream

    if words is None:
        raise ValueError("the plain bit product reads the pack's words")
    return bitstream.bitmm_plain(words, x, m, k)


def _bitmm_cuda(x, words, pairs, bit_ptr, runs, m, k):
    from hypergef_tpu_torch.ops import bitstream

    if pairs is None or bit_ptr is None or runs is None:
        raise ValueError("the pack has no kernel layout: put it on the card with "
                         "BitIncidence.device (or BitPack.to)")
    return bitstream.launch_kernel(x, pairs, bit_ptr, runs, m, k)


_define("bitmm(Tensor x, Tensor? words, Tensor? pairs, Tensor? bit_ptr, Tensor? runs, int m, "
        "int k) -> Tensor",
        _bitmm_cpu, _bitmm_cuda,
        lambda x, words, pairs, bit_ptr, runs, m, k: x.new_empty((m, x.shape[1])))


# ---------------------------------------------------------------- segment sum
# out[s] = Σ_{k ∈ seg s} x[gather[k]] (row k itself without a gather): int32
# indptr [S+1], x f32 [num_inputs, F] → f32 [S, F]
def _segsum_cpu(x, indptr, gather, runs, num_inputs):
    from hypergef_tpu_torch.ops import segment_sum

    indptr = indptr.long()
    return segment_sum.segment_sum_plain(x, indptr, None if gather is None else gather.long(),
                                         int(indptr[-1]))


def _segsum_cuda(x, indptr, gather, runs, num_inputs):
    from hypergef_tpu_torch.ops import segment_sum

    return segment_sum._launch(x, indptr, gather, runs, num_inputs)


_define("gather_segment_sum(Tensor x, Tensor indptr, Tensor? gather, Tensor? runs, "
        "int num_inputs) -> Tensor",
        _segsum_cpu, _segsum_cuda,
        lambda x, indptr, gather, runs, num_inputs: x.new_empty((indptr.shape[0] - 1,
                                                                 x.shape[1])))
