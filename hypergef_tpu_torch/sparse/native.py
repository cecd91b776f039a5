"""ctypes bindings to the port's native host library.

Port of ``hypergef_tpu/sparse/native.py`` (``:31-257``). The C++ source is
the port's own copy, ``hypergef_tpu_torch/csrc/hypergef_native.cpp``; it is
compiled at first use with the flags of the repo's ``csrc/Makefile``
(``g++ -O3 -fPIC -std=c++17 -fopenmp -shared``; without ``-fopenmp`` where
the toolchain has no OpenMP runtime to link, as on the card's machine:
OpenMP only spreads the aligned window search's independent groups over
threads, so the results are the same) into a library named by a digest
of the source and flags under ``build/native/`` at the root of the
checkout, written to a temporary name and renamed into place, so that
several processes may build it at the same moment. Nothing is written
into ``csrc/``. Nothing here runs when the module is imported.

Unlike the JAX package, which falls back to NumPy when its library is not
built (``:31-37``), a wrapper here builds the library and raises with the
compiler's message when the build fails. Callers that want the NumPy twin
ask for it (``use_native=False``). Every entry is bit-identical to its
NumPy twin (``tests/test_torch_port_native.py``):

* :func:`read_mtx_coo` — :func:`hypergef_tpu_torch.sparse.mtx.read_mtx`;
* :func:`coo_to_csr` — a row-sorted CSR, columns sorted within rows;
* :func:`build_ell_native` — :func:`hypergef_tpu_torch.sparse.planner.build_ell`;
* :func:`coarsen_order_native` and :func:`community_order_native` —
  :mod:`hypergef_tpu_torch.sparse.reorder`;
* :func:`aligned_windows_native` — the aligned planner's per-group window
  search (``planner._group_windows_opt``).
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
from typing import Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "hypergef_native.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-fopenmp", "-shared")
OPENMP = "-fopenmp"

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.c_int64
# the argument and result types of each entry of the library
ENTRIES = {
    # path; rows, cols, entries out
    "hg_read_mtx_header": ([ctypes.c_char_p, _I64P, _I64P, _I64P], ctypes.c_int),
    # path; row out, col out; capacity
    "hg_read_mtx_coo": ([ctypes.c_char_p, _I32P, _I32P, _I64], _I64),
    # row, col; nnz, num_rows; indptr out, indices out
    "hg_coo_to_csr": ([_I32P, _I32P, _I64, _I64, _I64P, _I32P], ctypes.c_int),
    # indptr; num_rows, ngs
    "hg_num_chunks": ([_I64P, _I64, _I64], _I64),
    # indptr, indices; num_rows, nnz, ngs, c_pad; gather_idx, mask, seg_ids, seg_ptr out
    "hg_build_ell": ([_I64P, _I32P, _I64, _I64, _I64, _I64, _I32P, _F32P, _I32P, _I64P],
                     _I64),
    # n, e; ht_indptr, ht_vertex (edge-major); h_indptr, h_edge (vertex-major); iters;
    # order out
    "hg_community_order": ([_I64, _I64, _I64P, _I32P, _I64P, _I32P, ctypes.c_int32, _I32P],
                           None),
    # n, e; ht_indptr, ht_vertex; edge_cap, max_levels; order out
    "hg_coarsen_order": ([_I64, _I64, _I64P, _I32P, _I64, _I64, _I32P], None),
    # n_groups, starts [n_groups+1]; bs (group-sorted blocks), nb; widths, n_widths;
    # block_cost, spill_cost; off out, wid out
    "hg_aligned_windows": ([_I64, _I64P, _I64P, _I64, _I64P, _I64, _I64, _I64, _I64P,
                            _I64P], None),
}


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (set CXX or put g++ on PATH): the native host "
                           "library is built from source at first use")
    return cxx


@functools.lru_cache(maxsize=None)
def cxx_flags() -> tuple:
    """``CXX_FLAGS``, less ``-fopenmp`` where g++ cannot build a shared
    library with it (a toolchain without its OpenMP runtime refuses the
    flag)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
        src = Path(d) / "probe.cpp"
        src.write_text("int hg_probe() { return 0; }\n")
        proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(Path(d) / "probe.so"), str(src)],
                              capture_output=True, check=False)
    return CXX_FLAGS if proc.returncode == 0 else tuple(f for f in CXX_FLAGS if f != OPENMP)


def _digest() -> str:
    h = hashlib.sha256(" ".join(cxx_flags()).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if this exact build is missing; return its path.
    Raises ``RuntimeError`` with the compiler's output if the build fails."""
    lib = BUILD_DIR / f"libhypergef_native_{_digest()}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_cxx(), *cxx_flags(), "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"native host library build failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, with typed entries."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _p(a: np.ndarray, ptr):
    return a.ctypes.data_as(ptr)


def read_mtx_coo(path: str) -> Tuple[int, int, np.ndarray, np.ndarray]:
    """Parse a MatrixMarket file: (rows, cols, row_idx, col_idx), symmetric
    entries expanded and indices rebased to 0 (``:123-141``)."""
    lib = load_library()
    rows, cols, entries = (np.zeros(1, dtype=np.int64) for _ in range(3))
    rc = lib.hg_read_mtx_header(str(path).encode(), _p(rows, _I64P), _p(cols, _I64P),
                                _p(entries, _I64P))
    if rc != 0:
        raise IOError(f"native mtx header parse failed ({rc}) for {path}")
    cap = int(entries[0]) * 2  # the symmetric expansion's upper bound
    r = np.empty(cap, dtype=np.int32)
    c = np.empty(cap, dtype=np.int32)
    nnz = lib.hg_read_mtx_coo(str(path).encode(), _p(r, _I32P), _p(c, _I32P), cap)
    if nnz < 0:
        raise IOError(f"native mtx body parse failed ({nnz}) for {path}")
    return int(rows[0]), int(cols[0]), r[:nnz].copy(), c[:nnz].copy()


def coo_to_csr(row, col, num_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """A COO list as (indptr int64, indices int32): rows in order, the
    columns of each row sorted, duplicates kept."""
    lib = load_library()
    row, col = _i32(row), _i32(col)
    indptr = np.zeros(num_rows + 1, dtype=np.int64)
    indices = np.zeros(row.shape[0], dtype=np.int32)
    rc = lib.hg_coo_to_csr(_p(row, _I32P), _p(col, _I32P), row.shape[0], num_rows,
                           _p(indptr, _I64P), _p(indices, _I32P))
    if rc != 0:
        raise ValueError(f"coo_to_csr: a row id outside [0, {num_rows})")
    return indptr, indices


def build_ell_native(indptr, indices, ngs: int, pad_chunks_to: int = 8):
    """Native twin of :func:`hypergef_tpu_torch.sparse.planner.build_ell`
    (``:144-183``)."""
    from hypergef_tpu_torch.sparse.planner import EllTable, _round_up

    lib = load_library()
    indptr, indices = _i64(indptr), _i32(indices)
    num_rows = indptr.shape[0] - 1
    num_chunks = int(lib.hg_num_chunks(_p(indptr, _I64P), num_rows, ngs))
    c_pad = max(_round_up(max(num_chunks, 1), pad_chunks_to), pad_chunks_to)
    gather_idx = np.zeros((c_pad, ngs), dtype=np.int32)
    mask = np.zeros((c_pad, ngs), dtype=np.float32)
    seg_ids = np.full(c_pad, num_rows, dtype=np.int32)
    seg_ptr = np.zeros(num_rows + 1, dtype=np.int64)
    got = lib.hg_build_ell(_p(indptr, _I64P), _p(indices, _I32P), num_rows,
                           indices.shape[0], ngs, c_pad, _p(gather_idx, _I32P),
                           _p(mask, _F32P), _p(seg_ids, _I32P), _p(seg_ptr, _I64P))
    if got != num_chunks:
        raise RuntimeError(f"native ELL build wrote {got} chunks, counted {num_chunks}")
    return EllTable(gather_idx=gather_idx, mask=mask, seg_ids=seg_ids, seg_ptr=seg_ptr,
                    num_chunks=num_chunks, num_segments=num_rows, ngs=ngs)


def coarsen_order_native(hg, edge_cap: int = 64, max_levels: int = 40) -> np.ndarray:
    """The multilevel coarsening order in C++ (``:208-223``), bit-identical
    to :func:`hypergef_tpu_torch.sparse.reorder.coarsen_order` with
    ``use_native=False``."""
    lib = load_library()
    ht_indptr, ht_vertex = _i64(hg.ht_indptr), _i32(hg.ht_indices)
    order = np.empty(hg.num_nodes, dtype=np.int32)
    lib.hg_coarsen_order(hg.num_nodes, hg.num_edges, _p(ht_indptr, _I64P),
                         _p(ht_vertex, _I32P), edge_cap, max_levels, _p(order, _I32P))
    return order


def community_order_native(hg, iters: int = 8) -> np.ndarray:
    """Label-propagation order in C++ (``:226-242``), bit-identical to
    :func:`hypergef_tpu_torch.sparse.reorder.community_order_numpy`."""
    lib = load_library()
    ht_indptr, ht_vertex = _i64(hg.ht_indptr), _i32(hg.ht_indices)
    h_indptr, h_edge = _i64(hg.h_indptr), _i32(hg.h_indices)
    order = np.empty(hg.num_nodes, dtype=np.int32)
    lib.hg_community_order(hg.num_nodes, hg.num_edges, _p(ht_indptr, _I64P),
                           _p(ht_vertex, _I32P), _p(h_indptr, _I64P), _p(h_edge, _I32P),
                           iters, _p(order, _I32P))
    return order


def aligned_windows_native(starts, bs, nb: int, widths, block_cost: int, spill_cost: int):
    """Per-group cost-optimal (offset, width) in C++ (``:245-257``), the
    twin of the NumPy search of ``planner._group_windows_opt``. ``starts``
    [n_groups+1] are the group boundaries into ``bs``, the block ids sorted
    within each group."""
    lib = load_library()
    starts, bs, widths = _i64(starts), _i64(bs), _i64(widths)
    n_groups = len(starts) - 1
    off = np.empty(n_groups, dtype=np.int64)
    wid = np.empty(n_groups, dtype=np.int64)
    lib.hg_aligned_windows(n_groups, _p(starts, _I64P), _p(bs, _I64P), nb,
                           _p(widths, _I64P), len(widths), block_cost, spill_cost,
                           _p(off, _I64P), _p(wid, _I64P))
    return off, wid
