"""Train/valid/test splits and the accuracy metric, in NumPy.

Port of ``hypergef_tpu/train/splits.py`` (``:17-60``): the same NumPy code,
so a seed gives the same split in both packages, bit for bit.

* :func:`rand_train_test_idx` — proportional random split (ignoring label
  −1) or class-balanced split.
* :func:`accuracy` — argmax match percentage.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def accuracy(Z, Y) -> float:
    """Percentage of rows of Z whose argmax equals Y."""
    Z = np.asarray(Z)
    Y = np.asarray(Y)
    return 100.0 * float((Z.argmax(axis=1) == Y).mean())


def rand_train_test_idx(
    label: np.ndarray,
    train_prop: float = 0.5,
    valid_prop: float = 0.25,
    ignore_negative: bool = True,
    balance: bool = False,
    seed: int | None = None,
) -> Dict[str, np.ndarray]:
    """Randomly split node indices into train/valid/test."""
    label = np.asarray(label)
    rng = np.random.default_rng(seed)
    if not balance:
        if ignore_negative:
            labeled_nodes = np.nonzero(label != -1)[0]
        else:
            labeled_nodes = np.arange(label.shape[0])
        n = labeled_nodes.shape[0]
        train_num = int(n * train_prop)
        valid_num = int(n * valid_prop)
        perm = rng.permutation(n)
        train_idx = labeled_nodes[perm[:train_num]]
        valid_idx = labeled_nodes[perm[train_num : train_num + valid_num]]
        test_idx = labeled_nodes[perm[train_num + valid_num :]]
    else:
        num_classes = int(label.max()) + 1
        indices = []
        for i in range(num_classes):
            idx = np.nonzero(label == i)[0]
            indices.append(rng.permutation(idx))
        percls_trn = int(train_prop / num_classes * label.shape[0])
        val_lb = int(valid_prop * label.shape[0])
        train_idx = np.concatenate([i[:percls_trn] for i in indices])
        rest = np.concatenate([i[percls_trn:] for i in indices])
        rest = rng.permutation(rest)
        valid_idx = rest[:val_lb]
        test_idx = rest[val_lb:]
    return {"train": train_idx, "valid": valid_idx, "test": test_idx}
