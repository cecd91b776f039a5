"""MatrixMarket incidence-matrix IO.

Port of ``hypergef_tpu/sparse/mtx.py`` (``:16-42``): a .mtx file read into
the |V|×|E| incidence CSR pair (symmetric files expanded, 1-based indices
rebased), and H written back as a coordinate-pattern file. Reading goes
through the native host library's parser
(:func:`hypergef_tpu_torch.sparse.native.read_mtx_coo`), which the JAX
package uses when its library is built; ``use_native=False`` reads with
``scipy.io.mmread``, the same MatrixMarket semantics and the same CSR.
"""

from __future__ import annotations


def read_mtx(path: str, name: str | None = None, use_native: bool = True):
    """Read a MatrixMarket file into a :class:`Hypergraph` (H = V×E)."""
    from hypergef_tpu_torch.sparse.hypergraph import Hypergraph

    if name is None:
        name = str(path).rsplit("/", 1)[-1].removesuffix(".mtx")
    if use_native:
        from hypergef_tpu_torch.sparse import native

        n, e, v_idx, e_idx = native.read_mtx_coo(path)
        return Hypergraph.from_coo(v_idx, e_idx, num_nodes=n, num_edges=e, name=name)
    import scipy.io

    H = scipy.io.mmread(str(path)).tocoo()
    return Hypergraph.from_coo(
        H.row, H.col, num_nodes=H.shape[0], num_edges=H.shape[1], name=name
    )


def write_mtx(path: str, hg) -> None:
    """Write H as a coordinate-pattern MatrixMarket file."""
    import scipy.io

    scipy.io.mmwrite(str(path), hg.to_scipy())
