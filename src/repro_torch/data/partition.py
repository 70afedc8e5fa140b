"""Client data partitioning for federated simulation (counterpart of
`repro/data/partition.py`): iid sharding and a Dirichlet label-skew
partitioner (the standard FL non-iid benchmark protocol).  Host NumPy,
drawing from the caller's `np.random.Generator` in the reference's order,
so the same generator state gives the same partition."""
from __future__ import annotations

import numpy as np


def partition_iid(n_items: int, n_clients: int,
                  rng: np.random.Generator) -> list[np.ndarray]:
    """Random equal split of item indices."""
    perm = rng.permutation(n_items)
    return [np.sort(s) for s in np.array_split(perm, n_clients)]


def partition_noniid(labels: np.ndarray, n_clients: int, alpha: float,
                     rng: np.random.Generator) -> list[np.ndarray]:
    """Dirichlet(alpha) label-skew partition.

    Small alpha => each client sees few classes (highly non-iid);
    alpha -> inf recovers iid.  Returns per-client index arrays.
    """
    classes = np.unique(labels)
    client_idx: list[list[int]] = [[] for _ in range(n_clients)]
    for cls in classes:
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        shares = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(shares)[:-1] * len(idx)).astype(int)
        for i, part in enumerate(np.split(idx, cuts)):
            client_idx[i].extend(part.tolist())
    return [np.sort(np.array(ix, dtype=np.int64)) for ix in client_idx]
