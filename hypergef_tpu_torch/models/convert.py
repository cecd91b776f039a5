"""Weights and optimizer state from the JAX package into the port.

:func:`params_from_flax` turns the params of ``hypergef_tpu``'s models
(nested dicts of arrays, as ``model.init(...)["params"]`` returns them) into
a ``state_dict`` for the port's :class:`~hypergef_tpu_torch.models.zoo.HGNN`,
:class:`~hypergef_tpu_torch.models.zoo.UniGIN` or
:class:`~hypergef_tpu_torch.models.zoo.UniGCNII`;
:func:`opt_state_from_optax` turns the JAX trainer's optax state into the
port's Adam state, so a JAX run's whole training state carries across.
Leaves are read with ``np.asarray``, so the port needs no JAX to take them.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_CONV = re.compile(r"(HGNNConv|UniGINConv|UniGCNIIConv)_(\d+)$")


def _tensor(a, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(a, dtype=np.float32)
    return torch.from_numpy(np.array(a.T if transpose else a, order="C"))


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax names to the port's, kernels [in, out] transposed to torch's
    [out, in]:

    * ``HGNNConv_i/linear/kernel`` and ``UniGINConv_i/linear/kernel`` →
      ``convs.i.linear.weight``; ``HGNNConv_i/wdiag`` [E, 1] →
      ``convs.i.wdiag``; ``UniGINConv_i/eps`` (1,) → ``convs.i.eps``;
    * ``UniGCNIIConv_i/W/kernel`` → ``convs.i.W.weight``;
    * ``lin_in`` and ``lin_out`` ``{kernel, bias}`` → ``lin_in.weight``,
      ``lin_in.bias`` (and ``lin_out``);
    * ``PReLU_0/negative_slope`` () → ``prelu.weight`` (1,).
    """
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        m = _CONV.match(name)
        if m is not None:
            i = int(m.group(2))
            if m.group(1) == "UniGCNIIConv":
                out[f"convs.{i}.W.weight"] = _tensor(sub["W"]["kernel"], transpose=True)
                continue
            out[f"convs.{i}.linear.weight"] = _tensor(sub["linear"]["kernel"], transpose=True)
            for leaf in ("wdiag", "eps"):
                if leaf in sub:
                    out[f"convs.{i}.{leaf}"] = _tensor(sub[leaf])
        elif name in ("lin_in", "lin_out"):
            out[f"{name}.weight"] = _tensor(sub["kernel"], transpose=True)
            out[f"{name}.bias"] = _tensor(sub["bias"])
        elif name == "PReLU_0":
            out["prelu.weight"] = _tensor(sub["negative_slope"]).reshape(1)
        else:
            raise ValueError(f"unknown param group {name!r} (HGNN | UniGIN | UniGCNII)")
    return out


def opt_state_from_optax(opt_state: Any, params: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX trainer's optax state (``optax.chain(add_decayed_weights,
    scale_by_adam, scale)``, ``hypergef_tpu/train/trainer.py:67-74``) as the
    port's Adam state by parameter name (``Trainer(opt_state=...)``,
    ``Trainer.opt_state``): ``ScaleByAdamState``'s ``count`` becomes each
    parameter's ``step``, ``mu`` its ``exp_avg`` and ``nu`` its
    ``exp_avg_sq``, under the names and transposes of
    :func:`params_from_flax`. ``params`` is the flax params the state
    belongs to; the moments must have its groups. The other two states of
    the chain hold nothing."""
    adam = [s for s in (opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,))
            if all(hasattr(s, f) for f in ("count", "mu", "nu"))]
    if len(adam) != 1:
        raise ValueError("opt_state holds no single ScaleByAdamState (count, mu, nu): "
                         f"{type(opt_state).__name__}")
    (adam,) = adam
    for name, moments in (("mu", adam.mu), ("nu", adam.nu)):
        if set(moments) != set(params):
            raise ValueError(f"{name} groups {sorted(moments)} != params {sorted(params)}")
    step = float(np.asarray(adam.count))
    mu, nu = params_from_flax(adam.mu), params_from_flax(adam.nu)
    return {k: {"step": torch.tensor(step), "exp_avg": mu[k], "exp_avg_sq": nu[k]} for k in mu}
