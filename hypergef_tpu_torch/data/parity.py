"""Real-data readiness check: one-command parity validation of a dataset.

Port of ``hypergef_tpu/data/parity.py`` (``:44-271``). The reference's
correctness story for real data is its tier-1 test (load each of the 13
datasets, run the fused op, compare against an oracle) plus the accuracies
its training driver reaches. The repository holds format fixtures only
(``tests/fixtures/data``, each with a ``FIXTURE`` marker), so this turns a
drop of the real AllSet raw files into a pass/fail check:

    python -m hypergef_tpu_torch.train.cli --dname cora --validate-parity \
        --data-path /path/to/AllSet/data

Checks, in order (each an independent PASS/FAIL/SKIP line):

1. **format**: the raw files load through the loaders; CSR invariants
   hold; feature and label rows match the graph.
2. **shape**: |V|, |E|, feature width and class count match the published
   AllSet statistics (``EXPECTED_REAL``); SKIP under a FIXTURE marker.
3. **oracle**: the ladder's plan (:func:`plan_aggregation` on ``device``)
   and the fused aggregation on its preferred route agree with the plain
   :func:`~hypergef_tpu_torch.ops.refops.hgnn_aggregate_ref` on ``device``
   within 1e-2 of the output's scale.
4. **accuracy** (advisory): a short HGNN run through
   :func:`~hypergef_tpu_torch.train.trainer.train_full_batch` lands in the
   published band; only on real-shaped data.

A load or oracle failure is a FAIL line, never a PASS or a SKIP.
:func:`fingerprint` records the sha256 and size of every raw file, so a
first validated real drop can be committed as the reference (``record``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

# Published AllSet dataset statistics (AllSet, Chien et al., ICLR'22,
# benchmark tables; the reference consumes these exact raw sets via
# data/load_dataset.py).  num_nodes/num_edges also appear in the
# reference's own artifacts (e.g. dataloader.py:31 pubmed 7963
# hyperedges).  ``features``/``classes`` entries of None are not
# checked (cornell features are noise-synthesized at load time; LE
# feature dims vary with the published extraction).  VERIFY against the
# AllSet paper when real raw data is first dropped in — shape mismatches
# fail loudly by design.
EXPECTED_REAL: Dict[str, dict] = {
    "cora": dict(num_nodes=2708, num_edges=1579, features=1433, classes=7),
    "citeseer": dict(num_nodes=3312, num_edges=1079, features=3703, classes=6),
    "pubmed": dict(num_nodes=19717, num_edges=7963, features=500, classes=3),
    "coauthor_cora": dict(num_nodes=2708, num_edges=1072, features=1433, classes=7),
    "coauthor_dblp": dict(num_nodes=41302, num_edges=22363, features=1425, classes=6),
    "NTU2012": dict(num_nodes=2012, num_edges=2012, features=100, classes=67),
    "ModelNet40": dict(num_nodes=12311, num_edges=12311, features=100, classes=40),
    "zoo": dict(num_nodes=101, num_edges=43, features=16, classes=7),
    "20newsW100": dict(num_nodes=16242, num_edges=100, features=100, classes=4),
    "Mushroom": dict(num_nodes=8124, num_edges=298, features=None, classes=2),
    "house-committees": dict(num_nodes=1290, num_edges=341, features=None, classes=2),
    "walmart-trips": dict(num_nodes=88860, num_edges=69906, features=None, classes=11),
    "yelp": dict(num_nodes=50758, num_edges=679302, features=None, classes=9),
}

# Advisory HGNN test-accuracy bands (fraction correct), transcribed from
# the AllSet benchmark's HGNN rows with ±5-point slack; half the nodes
# train (the reference's default split, hgsys.py train_prop=0.5).
# Checked only when the loaded graph matches the real shape.
EXPECTED_ACC_BAND: Dict[str, tuple] = {
    "cora": (0.70, 0.88),
    "citeseer": (0.62, 0.80),
    "pubmed": (0.78, 0.92),
    "coauthor_cora": (0.75, 0.90),
    "coauthor_dblp": (0.85, 0.96),
    "NTU2012": (0.78, 0.93),
    "ModelNet40": (0.90, 0.99),
    "zoo": (0.80, 1.00),
    "20newsW100": (0.72, 0.86),
    "Mushroom": (0.95, 1.00),
}


@dataclasses.dataclass
class CheckResult:
    name: str
    status: str  # PASS | FAIL | SKIP
    detail: str

    def line(self) -> str:
        return f"[{self.status:4s}] {self.name}: {self.detail}"


def fingerprint(root: str, name: str) -> Dict[str, dict]:
    """sha256 + byte size of every file under <root>/<name>/raw —
    the committable identity of a raw-data drop."""
    d = os.path.join(root, name, "raw")
    out = {}
    if not os.path.isdir(d):
        return out
    for fn in sorted(os.listdir(d)):
        p = os.path.join(d, fn)
        if not os.path.isfile(p):
            continue
        h = hashlib.sha256()
        with open(p, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        out[fn] = {"sha256": h.hexdigest(), "bytes": os.path.getsize(p)}
    return out




def validate(
    name: str,
    root: str,
    feature_noise: float = 1.0,
    train_epochs: int = 150,
    seed: int = 1,
    record: Optional[str] = None,
    device="cuda",
) -> List[CheckResult]:
    """Run the checks for one dataset on ``device`` (the card unless the
    caller asks for the CPU); returns their results (the CLI prints them
    and exits non-zero on any FAIL)."""
    from hypergef_tpu_torch.data.datasets import load_dataset

    results: List[CheckResult] = []

    # 1. format ----------------------------------------------------------
    try:
        ds = load_dataset(name, root=root, feature_noise=feature_noise, cache=False)
        hg = ds.hg
        ok = (
            int(hg.h_indptr[-1]) == hg.nnz
            and int(hg.ht_indptr[-1]) == hg.nnz
            and ds.features.shape[0] == hg.num_nodes
            and ds.labels.shape[0] == hg.num_nodes
            and ds.labels.min() >= 0
        )
        results.append(CheckResult(
            "format",
            "PASS" if ok else "FAIL",
            f"loaded |V|={hg.num_nodes} |E|={hg.num_edges} nnz={hg.nnz} "
            f"F={ds.features.shape[1]} C={ds.num_classes}",
        ))
        if not ok:
            return results
    except Exception as e:  # noqa: BLE001 — any load failure is a FAIL line
        results.append(CheckResult("format", "FAIL", f"{type(e).__name__}: {e}"))
        return results

    # 2. shape against the published statistics -----------------------------
    is_fixture = os.path.exists(os.path.join(root, name, "FIXTURE"))
    exp = EXPECTED_REAL.get(name)
    is_real_shape = False
    if exp is None:
        results.append(CheckResult("shape", "SKIP", "no published stats"))
    elif is_fixture:
        results.append(CheckResult(
            "shape", "SKIP",
            "FIXTURE marker present (synthetic format fixture) — drop "
            "real AllSet raw files in to activate this check"))
    else:
        got = {"num_nodes": hg.num_nodes, "num_edges": hg.num_edges,
               "features": ds.features.shape[1], "classes": ds.num_classes}
        mism = [f"{key}={got[key]} (expected {want})" for key, want in exp.items()
                if want is not None and got[key] != want]
        is_real_shape = not mism
        if is_real_shape:
            results.append(CheckResult("shape", "PASS", "matches published AllSet statistics"))
        else:
            results.append(CheckResult("shape", "FAIL", "; ".join(mism)))

    # 3. the fused op on the ladder's route against the plain oracle ---------
    try:
        from hypergef_tpu_torch.ops import fused, refops
        from hypergef_tpu_torch.sparse.planner import plan_aggregation

        plan = plan_aggregation(hg, device)
        hgd = hg.device_data(device)
        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.normal(size=(hg.num_nodes, 2)).astype(np.float32),
                            device=device)
        with torch.no_grad():
            got = fused.hgnn_aggregate(hgd, x, None, "sum", plan=plan,
                                       backend=plan.preferred_backend)
            want = refops.hgnn_aggregate_ref(hgd, x, None, "sum")
        # the reference's tier-2 tolerance, relative 1e-2 (check.cuh:47),
        # of the output's scale: the bf16 routes' error scales with it
        err = float((got - want).abs().max())
        scale = max(float(want.abs().max()), 1e-6)
        close = err <= 1e-2 * scale
        results.append(CheckResult(
            "oracle",
            "PASS" if close else "FAIL",
            f"fused[{plan.preferred_backend}] on {torch.device(device).type} vs plain "
            f"oracle max|Δ|/scale={err / scale:.2e} (limit 1e-2, the reference "
            "check.cuh:47 tolerance)",
        ))
    except Exception as e:  # noqa: BLE001 — any failure of the op is a FAIL line
        results.append(CheckResult("oracle", "FAIL", f"{type(e).__name__}: {e}"))

    # 4. accuracy band (advisory; real shapes only) --------------------------
    band = EXPECTED_ACC_BAND.get(name)
    if band is None or not is_real_shape:
        results.append(CheckResult(
            "accuracy", "SKIP",
            "expected band fires on real-shaped data only" if band else "no published band"))
    else:
        from hypergef_tpu_torch.train import TrainConfig, rand_train_test_idx, train_full_batch

        split = rand_train_test_idx(ds.labels, seed=seed)
        res = train_full_batch(
            TrainConfig(model="HGNN", nhid=64, epochs=train_epochs, warmup=0, seed=seed),
            hg, ds.features, ds.labels, split, device=device,
        )
        acc = res.get("test_acc", 0.0) / 100.0
        lo, hi = band
        results.append(CheckResult(
            "accuracy",
            "PASS" if lo <= acc <= hi else "FAIL",
            f"HGNN test acc {acc:.3f} vs expected [{lo:.2f}, {hi:.2f}] "
            "(AllSet HGNN row ±5pt, advisory)",
        ))

    if record:
        rec = {
            "dataset": name,
            "files": fingerprint(root, name),
            "loaded": {
                "num_nodes": hg.num_nodes,
                "num_edges": hg.num_edges,
                "nnz": hg.nnz,
                "features": int(ds.features.shape[1]),
                "classes": int(ds.num_classes),
            },
            "checks": {r.name: r.status for r in results},
        }
        with open(record, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
        results.append(CheckResult("record", "PASS", f"wrote {record}"))
    return results
