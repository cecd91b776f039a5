"""Checkpoint and resume: the port of ``hypergef_tpu/train/checkpoint.py``.

Saves and restores (params, opt_state, step), where each state is a dict of
tensors, nested or not (a ``state_dict``; Adam's state by parameter name,
``Trainer.opt_state``). Each step is one subdirectory of ``directory``
named by the step, holding one ``torch.save`` file; it is written under a
temporary name and then renamed, so a reader never sees half of one. The
newest ``max_to_keep`` steps are kept, as orbax's manager keeps them
(``:16-22``). With ``wait=False`` the tensors are copied to the host at
once and written by a background thread, which the next save or restore
into the same directory joins first.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

_FILE = "state.pt"
_lock = threading.Lock()
_pending: Dict[str, "_Writer"] = {}  # background writers by directory


class _Writer(threading.Thread):
    def __init__(self, fn):
        super().__init__(daemon=True)
        self._fn = fn
        self.error: Optional[Exception] = None

    def run(self) -> None:
        try:
            self._fn()
        except Exception as e:  # re-raised by the join in _join
            self.error = e


def _join(directory: str) -> None:
    """Wait for the background write into ``directory``; raise its error."""
    with _lock:
        writer = _pending.pop(directory, None)
    if writer is not None:
        writer.join()
        if writer.error is not None:
            raise writer.error


def _to_host(tree: Mapping) -> Dict[str, Any]:
    return {k: _to_host(v) if isinstance(v, Mapping)
            else torch.as_tensor(v).detach().cpu().clone() for k, v in tree.items()}


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit() and os.path.isfile(os.path.join(directory, name, _FILE)))


def _write(directory: str, step: int, state: Dict[str, Any], max_to_keep: int) -> None:
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=directory)
    try:
        torch.save(state, os.path.join(tmp, _FILE))
        final = os.path.join(directory, str(step))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))


def save_checkpoint(
    directory: str,
    step: int,
    params: Mapping,
    opt_state: Mapping,
    wait: bool = True,
    max_to_keep: int = 3,
) -> None:
    """Save ``params`` and ``opt_state`` as step ``step`` of ``directory``
    (an existing step is replaced), keeping the newest ``max_to_keep``."""
    if max_to_keep < 1:
        raise ValueError(f"max_to_keep must be at least 1, got {max_to_keep}")
    directory = os.path.abspath(directory)
    _join(directory)
    state = {"step": int(step), "params": _to_host(params), "opt_state": _to_host(opt_state)}
    if wait:
        _write(directory, int(step), state, max_to_keep)
        return
    writer = _Writer(lambda: _write(directory, int(step), state, max_to_keep))
    with _lock:
        _pending[directory] = writer
    writer.start()


def _like(template: Mapping, value: Mapping, what: str) -> Dict[str, Any]:
    """``value`` laid out as ``template``: the same keys, each tensor on its
    template's device and of its dtype and shape."""
    if set(template) != set(value):
        raise ValueError(f"{what}: checkpoint keys {sorted(value)} != {sorted(template)}")
    out = {}
    for k, t in template.items():
        if isinstance(t, Mapping):
            out[k] = _like(t, value[k], f"{what}[{k!r}]")
            continue
        t = torch.as_tensor(t)
        v = value[k]
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{what}[{k!r}]: checkpoint shape {tuple(v.shape)} != "
                             f"{tuple(t.shape)}")
        out[k] = v.to(device=t.device, dtype=t.dtype)
    return out


def restore_checkpoint(
    directory: str,
    params_template: Mapping,
    opt_state_template: Mapping,
    step: Optional[int] = None,
) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
    """Restore the latest (or the given) step; returns (step, params,
    opt_state), laid out as the templates. Raises FileNotFoundError when no
    checkpoint exists."""
    directory = os.path.abspath(directory)
    _join(directory)
    steps = _steps(directory)
    if step is None:
        step = steps[-1] if steps else None
    if step is None or int(step) not in steps:
        raise FileNotFoundError(f"no checkpoint under {directory}"
                                + (f" for step {step}" if step is not None else ""))
    state = torch.load(os.path.join(directory, str(int(step)), _FILE), map_location="cpu",
                       weights_only=True)
    return (int(state["step"]), _like(params_template, state["params"], "params"),
            _like(opt_state_template, state["opt_state"], "opt_state"))
