"""Training configuration.

Port of ``hypergef_tpu/train/trainer.py::TrainConfig`` (``:32-64``) with the
same fields and defaults, so a server and (later) a trainer are built from
the same config in both packages. The ``Trainer`` itself comes with the
backward kernels (ROADMAP.md queue 1, item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    """The reference's argparse knobs (``hgsys.py:22-70``) plus route
    options. ``backend="auto"`` needs the routing ladder, which is not
    ported yet: name ``xla``, ``dense`` or ``pallas``."""

    model: str = "HGNN"
    nhid: int = 32
    nlayer: int = 2
    nhead: int = 1
    first_aggr: str = "sum"
    dropout: float = 0.6
    input_drop: float = 0.6
    activation: str = "relu"
    lr: float = 0.01
    wd: float = 5e-4
    epochs: int = 200
    warmup: int = 10
    seed: int = 1
    train_prop: float = 0.5
    valid_prop: float = 0.25
    backend: Optional[str] = "auto"
    tune: bool = False
    plan_cache: Optional[str] = None
