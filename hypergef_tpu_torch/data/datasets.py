"""Named-dataset loaders: the 13 hypergraph benchmarks of the reference.

Port of ``hypergef_tpu/data/datasets.py`` (``:1-307``), the same NumPy code
over the port's :class:`~hypergef_tpu_torch.sparse.hypergraph.Hypergraph`,
so a dataset loads bit-identical to the JAX package's. Every loader reads
local raw files under ``root/<name>/raw`` (the layout the reference's
``data/prepare.sh`` downloads) and raises :class:`DatasetNotAvailable` when
one is absent; nothing is downloaded. Processed results are cached as
``root/<name>/processed.npz`` in the JAX package's format (cornell sets as
``processed_fn<noise>.npz``, since their features depend on the noise), so
either package reads the other's cache.

Formats:

* **LE datasets** (ModelNet40, NTU2012, zoo, 20newsW100, Mushroom):
  ``<name>.content`` (``id feat... label`` rows) and ``<name>.edges``
  (member-id lists, one hyperedge a line);
* **citation cocitation/coauthorship** (cora, citeseer, pubmed,
  coauthor_cora, coauthor_dblp): the AllSet pickles ``features.pickle``,
  ``labels.pickle`` and ``hypergraph.pickle``;
* **yelp**: five CSVs, with a bag of words of the restaurants' names;
* **cornell** (walmart-trips, house-committees): ``hyperedges-*.txt`` and
  ``node-labels-*.txt``, features one-hot labels plus seeded Gaussian noise.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Optional

import numpy as np

from hypergef_tpu_torch.sparse.hypergraph import Hypergraph

EXISTING_DATASETS = [
    "20newsW100", "ModelNet40", "zoo", "NTU2012", "Mushroom",
    "coauthor_cora", "coauthor_dblp", "yelp", "walmart-trips",
    "house-committees", "cora", "citeseer", "pubmed",
]

SYNTHETIC_LIST = ["walmart-trips", "house-committees"]

_LE = ["ModelNet40", "NTU2012", "zoo", "20newsW100", "Mushroom"]
_CITATION_COCITE = ["cora", "citeseer", "pubmed"]
_CITATION_COAUTH = {"coauthor_cora": "cora", "coauthor_dblp": "dblp"}
_CORNELL = {"walmart-trips": "walmart-trips", "house-committees": "house-committees"}


@dataclass
class HypergraphDataset:
    name: str
    hg: Hypergraph
    features: np.ndarray  # [N, F] f32
    labels: np.ndarray  # [N] int32

    @property
    def num_features(self) -> int:
        return int(self.features.shape[1])

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1


class DatasetNotAvailable(FileNotFoundError):
    pass


def _raw_dir(root: str, name: str) -> str:
    return os.path.join(root, name, "raw")


def _require(path: str, name: str) -> str:
    if not os.path.exists(path):
        raise DatasetNotAvailable(
            f"dataset {name!r}: raw file {path} not found. The loaders read "
            "local files only and download nothing; place the AllSet raw files there "
            "(same layout the reference's data/prepare.sh downloads)."
        )
    return path


def _from_edge_lists(edge_lists, num_nodes, name) -> Hypergraph:
    vs, es = [], []
    for e, members in enumerate(edge_lists):
        for v in members:
            vs.append(v)
            es.append(e)
    return Hypergraph.from_coo(
        np.asarray(vs, dtype=np.int64),
        np.asarray(es, dtype=np.int64),
        num_nodes=num_nodes,
        num_edges=len(edge_lists),
        name=name,
    )


def load_LE_dataset(root: str, name: str) -> HypergraphDataset:
    """`.content` + `.edges` loader (load_dataset.py:33-130)."""
    d = _raw_dir(root, name)
    content = _require(os.path.join(d, f"{name}.content"), name)
    edges_f = _require(os.path.join(d, f"{name}.edges"), name)
    rows = [l.split() for l in open(content) if l.strip()]
    ids = np.array([int(r[0]) for r in rows])
    feats = np.array([[float(x) for x in r[1:-1]] for r in rows], dtype=np.float32)
    labels_raw = [r[-1] for r in rows]
    classes = sorted(set(labels_raw))
    labels = np.array([classes.index(c) for c in labels_raw], dtype=np.int32)
    id_of = {v: i for i, v in enumerate(ids)}
    edge_lists = []
    for line in open(edges_f):
        if line.strip():
            members = [id_of[int(t)] for t in line.split() if int(t) in id_of]
            if members:
                edge_lists.append(members)
    hg = _from_edge_lists(edge_lists, len(ids), name)
    return HypergraphDataset(name, hg, feats, labels)


def load_citation_dataset(root: str, name: str, sub: Optional[str] = None) -> HypergraphDataset:
    """AllSet citation pickles (load_dataset.py:132-236)."""
    d = _raw_dir(root, name)
    with open(_require(os.path.join(d, "features.pickle"), name), "rb") as f:
        features = pickle.load(f)
    features = np.asarray(
        features.todense() if hasattr(features, "todense") else features,
        dtype=np.float32,
    )
    with open(_require(os.path.join(d, "labels.pickle"), name), "rb") as f:
        labels = np.asarray(pickle.load(f), dtype=np.int32)
    with open(_require(os.path.join(d, "hypergraph.pickle"), name), "rb") as f:
        hyperg = pickle.load(f)
    edge_lists = [list(members) for members in hyperg.values() if len(members)]
    hg = _from_edge_lists(edge_lists, features.shape[0], name)
    return HypergraphDataset(name, hg, features, labels)


def load_cornell_dataset(
    root: str, name: str, feature_noise: float = 1.0, feature_dim: Optional[int] = None,
    seed: int = 0,
) -> HypergraphDataset:
    """Cornell datasets: labels + synthetic noisy features
    (load_dataset.py:305-384: one-hot(label) + N(0, noise))."""
    d = _raw_dir(root, name)
    tag = _CORNELL[name]
    labels_f = _require(os.path.join(d, f"node-labels-{tag}.txt"), name)
    edges_f = _require(os.path.join(d, f"hyperedges-{tag}.txt"), name)
    labels = np.array([int(l) for l in open(labels_f) if l.strip()], dtype=np.int32)
    labels = labels - labels.min()  # reference shifts labels to start at 0
    edge_lists = []
    for line in open(edges_f):
        if line.strip():
            edge_lists.append([int(t) - 1 for t in line.replace(",", " ").split()])
    num_classes = int(labels.max()) + 1
    rng = np.random.default_rng(seed)
    feats = np.eye(num_classes, dtype=np.float32)[labels]
    feats = feats + feature_noise * rng.normal(size=feats.shape).astype(np.float32)
    if feature_dim is not None and feature_dim != feats.shape[1]:
        proj = rng.normal(size=(feats.shape[1], feature_dim)).astype(np.float32)
        feats = feats @ proj
    hg = _from_edge_lists(edge_lists, len(labels), name)
    return HypergraphDataset(name, hg, feats, labels)


def _read_csv(path):
    """Tiny dependency-free CSV reader: (header list, list of row lists)."""
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f if l.strip()]
    header = [c.strip() for c in lines[0].split(",")]
    rows = [l.split(",") for l in lines[1:]]
    return header, rows


def _bag_of_words(texts, vocab_size=1000):
    """Counting vectorizer over lowercase word tokens, top-``vocab_size``
    by corpus frequency (the reference's sklearn CountVectorizer role,
    load_dataset.py:237-240, without the sklearn dependency)."""
    import re

    token_re = re.compile(r"[a-z0-9']+")
    docs = [token_re.findall(t.lower()) for t in texts]
    counts = {}
    for d in docs:
        for t in d:
            counts[t] = counts.get(t, 0) + 1
    vocab = [t for t, _ in sorted(counts.items(),
                                  key=lambda kv: (-kv[1], kv[0]))[:vocab_size]]
    index = {t: i for i, t in enumerate(vocab)}
    bow = np.zeros((len(docs), len(vocab)), dtype=np.float32)
    for i, d in enumerate(docs):
        for t in d:
            j = index.get(t)
            if j is not None:
                bow[i, j] += 1.0
    return bow


def load_yelp_dataset(root: str, name: str = "yelp",
                      name_dictionary_size: int = 1000) -> HypergraphDataset:
    """Yelp restaurant hypergraph — the reference's exact raw schema
    (load_dataset.py:199-303; each node a restaurant, each hyperedge the
    set of restaurants one user visited):

    * ``yelp_restaurant_latlong.csv`` — latitude/longitude per node
    * ``yelp_restaurant_locations.csv`` — ``state_int``/``city_int``
      columns (1-based category codes) → one-hot features
    * ``yelp_restaurant_name.csv`` — names → bag-of-words (top 1000)
    * ``yelp_restaurant_business_stars.csv`` — integer star labels
      (shifted to 0-based, the Dataloader label-shift parity)
    * ``yelp_restaurant_incidence_H.csv`` — ``node``/``he`` columns,
      1-based incidence pairs
    """
    d = _raw_dir(root, name)
    sub = os.path.join(d, name)
    if not os.path.isdir(sub):  # reference layout nests raw/yelp/
        sub = d
    _, ll_rows = _read_csv(
        _require(os.path.join(sub, "yelp_restaurant_latlong.csv"), name))
    latlong = np.asarray([[float(x) for x in r] for r in ll_rows], np.float32)
    loc_hdr, loc_rows = _read_csv(
        _require(os.path.join(sub, "yelp_restaurant_locations.csv"), name))
    s_col = loc_hdr.index("state_int")
    c_col = loc_hdr.index("city_int")
    state_int = np.asarray([int(r[s_col]) for r in loc_rows])
    city_int = np.asarray([int(r[c_col]) for r in loc_rows])
    num_nodes = len(loc_rows)
    state_1hot = np.zeros((num_nodes, state_int.max()), np.float32)
    state_1hot[np.arange(num_nodes), state_int - 1] = 1
    city_1hot = np.zeros((num_nodes, city_int.max()), np.float32)
    city_1hot[np.arange(num_nodes), city_int - 1] = 1
    _, name_rows = _read_csv(
        _require(os.path.join(sub, "yelp_restaurant_name.csv"), name))
    name_bow = _bag_of_words([",".join(r) for r in name_rows],
                             name_dictionary_size)
    features = np.hstack([latlong, state_1hot, city_1hot, name_bow])
    _, star_rows = _read_csv(_require(
        os.path.join(sub, "yelp_restaurant_business_stars.csv"), name))
    labels = np.asarray([int(float(r[0])) for r in star_rows], np.int32)
    labels = labels - labels.min()  # 0-based (transform_data label shift)
    h_hdr, h_rows = _read_csv(_require(
        os.path.join(sub, "yelp_restaurant_incidence_H.csv"), name))
    n_col = h_hdr.index("node")
    e_col = h_hdr.index("he")
    vs = np.asarray([int(r[n_col]) for r in h_rows], np.int64) - 1
    es = np.asarray([int(r[e_col]) for r in h_rows], np.int64) - 1
    hg = Hypergraph.from_coo(vs, es, num_nodes=num_nodes, name=name)
    assert num_nodes == len(labels) == features.shape[0]
    return HypergraphDataset(name, hg, features, labels)


def load_dataset(
    name: str,
    root: str = "data/",
    feature_noise: float = 1.0,
    cache: bool = True,
) -> HypergraphDataset:
    """Main entry: name → HypergraphDataset (dataloader.py:20-110 role),
    with npz caching (the reference caches to ``data.pt``)."""
    if name not in EXISTING_DATASETS:
        raise ValueError(f"unknown dataset {name!r}; known: {EXISTING_DATASETS}")
    # cornell datasets synthesize features from feature_noise → the cache
    # key must include it (the reference encodes it in the dataset dir
    # name, e.g. walmart-trips-100) or a second call with a different
    # noise level would silently return stale features.
    if name in _CORNELL:
        cache_f = os.path.join(root, name, f"processed_fn{feature_noise:g}.npz")
    else:
        cache_f = os.path.join(root, name, "processed.npz")
    if cache and os.path.exists(cache_f):
        z = np.load(cache_f)
        hg = Hypergraph(
            num_nodes=int(z["num_nodes"]),
            num_edges=int(z["num_edges"]),
            h_indptr=z["h_indptr"],
            h_indices=z["h_indices"],
            ht_indptr=z["ht_indptr"],
            ht_indices=z["ht_indices"],
            name=name,
        )
        return HypergraphDataset(name, hg, z["features"], z["labels"])
    if name in _LE:
        ds = load_LE_dataset(root, name)
    elif name in _CITATION_COCITE or name in _CITATION_COAUTH:
        ds = load_citation_dataset(root, name)
    elif name in _CORNELL:
        ds = load_cornell_dataset(root, name, feature_noise)
    elif name == "yelp":
        ds = load_yelp_dataset(root)
    else:  # pragma: no cover
        raise AssertionError(name)
    if cache:
        os.makedirs(os.path.dirname(cache_f), exist_ok=True)
        np.savez_compressed(
            cache_f,
            num_nodes=ds.hg.num_nodes,
            num_edges=ds.hg.num_edges,
            h_indptr=ds.hg.h_indptr,
            h_indices=ds.hg.h_indices,
            ht_indptr=ds.hg.ht_indptr,
            ht_indices=ds.hg.ht_indices,
            features=ds.features,
            labels=ds.labels,
        )
    return ds
