"""Row clustering for input splitting (``delphi.misc.splitInputTable``).

Rows become hashed bags of q-grams (a fixed width of ``FEATURE_DIM``), and
Lloyd's k-means runs over them on the port's device, seeded k-means++
style on the host by the same ``RandomState`` draws as the JAX package:

* distances ``((X[:, None, :] - C[None]) ** 2).sum(-1)`` in f32, the
  label the first index of the least distance;
* centroid sums ``one_hot.T @ X``; a cluster that lost every row keeps
  its centroid.

The q-gram counts are small integers, so the centroid sums are exact in
any summation order; a label can differ from the JAX package's only where
two distances tie to the last bits of their f32 sums. The distances take
the rows in blocks, so the ``[rows, k, FEATURE_DIM]`` difference tensor
stays under :data:`BLOCK_BYTES`.
"""

from typing import Iterator, List, Tuple

import numpy as np
import pandas as pd
import torch

from delphi_tpu_torch.ops.xfer import to_device
from delphi_tpu_torch.parallel import planner
from delphi_tpu_torch.utils.native import get_qgram

FEATURE_DIM = 1024

# the most bytes one block's difference tensor may take
BLOCK_BYTES = 1 << 30

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_U64 = (1 << 64) - 1


def _fnv1a(value: str) -> int:
    """FNV-1a over the UTF-32-LE bytes: identical to the native kernel
    (native/qgram.cpp) and, unlike builtin `hash()`, unsalted, so the same
    input clusters identically across processes."""
    h = _FNV_OFFSET
    for b in value.encode("utf-32-le", "surrogatepass"):
        h = ((h ^ b) * _FNV_PRIME) & _U64
    return h


def _qgrams(value: str, q: int) -> Iterator[str]:
    if len(value) > q:
        for i in range(len(value) - q + 1):
            yield value[i:i + q]
    else:
        yield value


def _is_null(v: object) -> bool:
    return v is None or (isinstance(v, float) and np.isnan(v))


def _column_strings(values: List[object]) -> Tuple[np.ndarray, np.ndarray]:
    """(row positions, value strings) of a column's non-null cells."""
    rows = np.fromiter((i for i, v in enumerate(values) if not _is_null(v)),
                       dtype=np.int64)
    return rows, np.array([str(values[i]) for i in rows], dtype=object)


def qgram_features(df: pd.DataFrame, q: int) -> np.ndarray:
    """Hashed bag-of-q-grams over each row's non-null values as strings:
    ``[len(df), FEATURE_DIM]`` f32 counts. The native C++ kernel computes
    it when the library is built; otherwise each distinct value of a
    column is hashed once and its counts are added to every row that holds
    it (the same integer counts)."""
    assert q > 0, f"`q` must be positive, but {q} got"
    n = len(df)
    columns = [_column_strings(df[c].tolist()) for c in df.columns]

    native = get_qgram()
    if native is not None:
        rows = np.concatenate([r for r, _ in columns] or [np.zeros(0, np.int64)])
        values = np.concatenate([v for _, v in columns]
                                or [np.zeros(0, object)])
        return native.features(values.tolist(), rows, n, q, FEATURE_DIM)

    out = np.zeros((n, FEATURE_DIM), dtype=np.float32)
    for rows, strings in columns:
        if not len(rows):
            continue
        codes, uniques = pd.factorize(strings)
        buckets = [[_fnv1a(g) % FEATURE_DIM for g in _qgrams(u, q)]
                   for u in uniques]
        sizes = np.array([len(b) for b in buckets], dtype=np.int64)
        flat = np.array([b for bs in buckets for b in bs], dtype=np.int64)
        starts = np.cumsum(sizes) - sizes
        # one (row, bucket) hit per q-gram of every cell: the j-th hit of
        # a cell is the j-th bucket of its value
        per_cell = sizes[codes]
        first_hit = np.cumsum(per_cell) - per_cell
        j = np.arange(int(per_cell.sum())) - np.repeat(first_hit, per_cell)
        hit_buckets = flat[np.repeat(starts[codes], per_cell) + j]
        np.add.at(out, (np.repeat(rows, per_cell), hit_buckets),
                  np.float32(1.0))
    return out


def _assign(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The nearest centroid of each row of a non-empty ``X`` (first index
    on ties)."""
    k, d = centers.shape
    block = max(1, BLOCK_BYTES // (4 * k * max(d, 1)))
    return torch.cat([((X[s:s + block, None, :] - centers[None, :, :]) ** 2)
                      .sum(-1).argmin(dim=1)
                      for s in range(0, X.shape[0], block)])


def _lloyd(X: torch.Tensor, init: torch.Tensor, k: int,
           n_iters: int) -> torch.Tensor:
    """``n_iters`` Lloyd iterations from ``init``; the final labels."""
    centers = init
    for _ in range(n_iters):
        one_hot = torch.nn.functional.one_hot(_assign(X, centers), k) \
            .to(X.dtype)
        counts = one_hot.sum(0)
        sums = one_hot.T @ X
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1.0),
                              centers)
    return _assign(X, centers)


def kmeans(X: np.ndarray, k: int, seed: int = 0, n_iters: int = 20) -> np.ndarray:
    """Lloyd's k-means with distance-weighted (k-means++-style) seeding."""
    n = X.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    k = min(k, n)
    rng = np.random.RandomState(seed)
    centers = [X[rng.randint(n)]]
    for _ in range(1, k):
        d = np.min([((X - c) ** 2).sum(-1) for c in centers], axis=0)
        total = d.sum()
        if total <= 0:
            centers.append(X[rng.randint(n)])
        else:
            centers.append(X[rng.choice(n, p=d / total)])
    # the JAX package pads the rows to the launch planner's extent so that
    # one compiled program serves every split size; eager PyTorch gains
    # nothing from that, so the rows stay unpadded and the plan is only
    # recorded (its `launch.*` counts)
    planner.padded_extent(
        "cluster", n, floor=8, shape=(int(k), int(n_iters), int(X.shape[1])))
    labels = _lloyd(to_device(X), to_device(np.stack(centers)), k, n_iters)
    return labels.cpu().numpy().astype(np.int64)


def bisecting_kmeans(X: np.ndarray, k: int, seed: int = 0,
                     n_iters: int = 20) -> np.ndarray:
    """Top-down divisive clustering (Spark MLlib's BisectingKMeans): start
    from one cluster and repeatedly 2-means-split the largest remaining
    cluster until ``k`` clusters exist."""
    n = X.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    k = min(k, n)
    labels = np.zeros(n, dtype=np.int64)
    next_label = 1
    while next_label < k:
        sizes = np.bincount(labels, minlength=next_label)
        splittable = np.nonzero(sizes >= 2)[0]
        if splittable.size == 0:
            break
        target = splittable[np.argmax(sizes[splittable])]
        idx = np.nonzero(labels == target)[0]
        sub = kmeans(X[idx], 2, seed=seed + next_label, n_iters=n_iters)
        if (sub == 1).any() and (sub == 0).any():
            labels[idx[sub == 1]] = next_label
        else:
            # degenerate split (identical rows): peel one row off so the
            # cluster count still advances, like MLlib's forced division
            labels[idx[-1]] = next_label
        next_label += 1
    return labels
