"""Build and load the port's CUDA kernels.

The sources in ``hypergef_tpu_torch/csrc/`` are compiled with ``nvcc`` for
Hopper (``sm_90a``), one process per source, all started together, and
linked into one shared library with a plain C interface, which is loaded
with ``ctypes``. The build happens at first use, into
``build/kernels/`` at the root of the checkout, and is keyed by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is reused. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = (
    "fused_dense.cu", "ell_gather.cu", "aligned_band.cu", "aligned_max.cu", "bitstream.cu",
    "segment_sum.cu", "probes.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels are built from source at first use"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this exact build is missing; return the .so path.

    The compiler's ``-Xptxas -v`` report (registers, shared memory, spills)
    is kept beside the library as ``<name>.log``.
    """
    lib = BUILD_DIR / f"libhypergef_torch_kernels_{_digest()}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    objs = [f"{tmp[:-3]}_{Path(name).stem}.o" for name in SOURCES]
    try:
        nvcc = _nvcc()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / name)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for name, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(name, p.returncode, log) for name, p, log in zip(SOURCES, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True,
                              text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        lib.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp, lib)
    finally:
        for path in (tmp, *objs):
            if os.path.exists(path):
                os.unlink(path)
    return lib


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# the argument types of each entry of the library
ENTRIES = {
    # h, x, scale_e, scale_v, out, partial_a, xe, partial_c; n, e, f, splits_a, k_a,
    # ways_a, splits_c, k_c, ways_c, grid, packed; stream
    "hg_fused_dense_two_stage": [_PTR] * 8 + [_INT] * 11 + [_PTR],
    # h, x, partial_a, out; n, e, f, splits_a, k_a, ways_a, grid, packed; stream
    "hg_dense_v2e": [_PTR] * 4 + [_INT] * 8 + [_PTR],
    # out: int[8]
    "hg_fused_dense_layout": [_PTR],
    # x, gidx, mask, out; c, ngs, f, form, lanes, batch; stream
    "hg_ell_gather_sum": [_PTR] * 4 + [_INT] * 6 + [_PTR],
    # x, tiles, tile_off, win, src, groups, work, counters, scratch, out; n_items,
    # slots, g, b, n, s, f; stream
    "hg_aligned_band": [_PTR] * 10 + [_INT] * 7 + [_PTR],
    # out: int[3]
    "hg_aligned_band_layout": [_PTR],
    # x, chunks, group_chunks, row_ptr, slots, items, src, val, arg; n_groups, g, n, s, f;
    # stream
    "hg_aligned_masked_argmax": [_PTR] * 9 + [_INT] * 5 + [_PTR],
    # g, arg, chunks, group_chunks, row_ptr, slots, items, src, out; n_groups, g, n, s, f;
    # stream
    "hg_aligned_masked_argsum": [_PTR] * 9 + [_INT] * 5 + [_PTR],
    # out: int[5]
    "hg_aligned_max_layout": [_PTR],
    # pairs, bit_ptr, runs, x, out; n_runs, f, lanes, width; stream
    "hg_bitmm": [_PTR] * 5 + [_INT] * 4 + [_PTR],
    # x, gather (or null), indptr, runs, out; n_runs, f, lanes, width; stream
    "hg_gather_segment_sum": [_PTR] * 5 + [_INT] * 4 + [_PTR],
    # g, arg; arg_bytes; edge, members, slot; nnz; words, gather, indptr, runs, out; n_runs,
    # f, lanes, width; stream
    "hg_record_routed_dx": [_PTR] * 2 + [_INT] + [_PTR] * 3 + [_INT] + [_PTR] * 5
                           + [_INT] * 4 + [_PTR],
    # x, idx, out; r, f, n_buf (0: direct), blocks, warps, per_warp, tile; stream
    "hg_row_gather": [_PTR] * 3 + [_INT] * 7 + [_PTR],
    # g (gathered [C, ngs, F]), mask, out; c, ngs, f, lanes; stream
    "hg_chunk_masked_sum": [_PTR] * 3 + [_INT] * 4 + [_PTR],
    # x, gidx, mask, out; c, ngs, f, blocks, pairs, slots, per_pair; stream
    "hg_chunk_sum_ring": [_PTR] * 4 + [_INT] * 7 + [_PTR],
    # x, out; count (floats), scale; stream
    "hg_scaled_copy": [_PTR] * 2 + [ctypes.c_longlong, ctypes.c_float, _PTR],
}


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument types of those of its entries in ``ENTRIES``."""
    for name, argtypes in ENTRIES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _INT
    if hasattr(lib, "hg_error_string"):
        lib.hg_error_string.argtypes = [_INT]
        lib.hg_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with typed entries."""
    return typed(ctypes.CDLL(str(build())))


def build_log() -> str:
    """The compiler's resource report for the current build."""
    return build().with_suffix(".log").read_text()
