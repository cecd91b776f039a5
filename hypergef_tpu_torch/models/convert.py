"""Weights from the JAX package into the port.

:func:`params_from_flax` turns the params of ``hypergef_tpu``'s HGNN (nested
dicts of arrays, as ``model.init(...)["params"]`` returns them) into a
``state_dict`` for :class:`hypergef_tpu_torch.models.zoo.HGNN`. Leaves are
read with ``np.asarray``, so the port needs no JAX to take them.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_CONV = re.compile(r"HGNNConv_(\d+)$")


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``HGNNConv_i/linear/kernel`` [in, out] → ``convs.i.linear.weight``
    [out, in]; ``HGNNConv_i/wdiag`` [E, 1] → ``convs.i.wdiag``."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        m = _CONV.match(name)
        if m is None:
            raise NotImplementedError(
                f"param group {name!r}: only HGNN is ported (ROADMAP.md queue 1, item 4)")
        i = int(m.group(1))
        kernel = np.asarray(sub["linear"]["kernel"], dtype=np.float32)
        out[f"convs.{i}.linear.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
        if "wdiag" in sub:
            out[f"convs.{i}.wdiag"] = torch.from_numpy(
                np.array(sub["wdiag"], dtype=np.float32))
    return out
