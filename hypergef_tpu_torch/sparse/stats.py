"""Hypergraph workload statistics.

Port of ``hypergef_tpu/sparse/stats.py`` (``:17-50``), the same NumPy code:
the reference's dataset feature set (degree histogram mass in the lower
and upper percentiles, Gini coefficient, normalized spread) over the
hyperedge sizes and the vertex degrees.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def gini(x: np.ndarray) -> float:
    """Gini coefficient of a non-negative distribution (0 = uniform)."""
    x = np.sort(np.asarray(x, dtype=np.float64))
    n = x.size
    if n == 0 or x.sum() == 0:
        return 0.0
    cum = np.cumsum(x)
    return float((n + 1 - 2 * (cum / cum[-1]).sum()) / n)


def graph_stats(hg, percentile: float = 10.0) -> Dict[str, float]:
    """Summary statistics of the hyperedge-size and vertex-degree
    distributions."""
    out: Dict[str, float] = {
        "num_nodes": float(hg.num_nodes),
        "num_edges": float(hg.num_edges),
        "nnz": float(hg.nnz),
        "density": hg.nnz / max(hg.num_nodes * hg.num_edges, 1),
    }
    for tag, deg in (("edge_size", hg.edge_sizes()),
                     ("vertex_deg", hg.vertex_degrees())):
        deg = np.asarray(deg, dtype=np.float64)
        if deg.size == 0:
            continue
        s = np.sort(deg)
        k = max(int(len(s) * percentile / 100.0), 1)
        total = max(s.sum(), 1.0)
        out[f"{tag}_mean"] = float(deg.mean())
        out[f"{tag}_max"] = float(deg.max())
        out[f"{tag}_std_norm"] = float(deg.std() / max(deg.mean(), 1e-12))
        out[f"{tag}_gini"] = gini(deg)
        out[f"{tag}_low{int(percentile)}pct_mass"] = float(s[:k].sum() / total)
        out[f"{tag}_top{int(percentile)}pct_mass"] = float(s[-k:].sum() / total)
    return out
