"""Label-map utilities: compaction and random coloring.

Random coloring is the JAX rebuild of the reference's Fast Hierarchy
Creation color stage (Report.pdf p.4 §3.2.3: cuRAND builds a componentID ->
random-color map, then a per-pixel remap kernel). cuRAND becomes stateless
`jax.random` with a fixed seed (reproducible renders); the remap kernel is a
single gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def compact_labels_np(labels: np.ndarray) -> np.ndarray:
    """Relabel arbitrary int labels to consecutive ids [0, n) (NumPy, host)."""
    _, inv = np.unique(labels, return_inverse=True)
    return inv.reshape(labels.shape).astype(np.int32)


def num_components(labels) -> int:
    return int(np.unique(np.asarray(labels)).size)


def canonical_min_labels_np(labels: np.ndarray) -> np.ndarray:
    """Relabel each class by its minimum member vertex id (flat index).

    The canonical partition representation: two label maps describe the same
    segmentation iff their canonical forms are equal. Used to compare
    union-find-rooted paths (atomic/fastmst/oracle) against the gossip turbo
    path, whose labels are min-vertex ids natively.
    """
    flat = np.asarray(labels).ravel()
    uniq, inv = np.unique(flat, return_inverse=True)
    minid = np.full(uniq.shape, np.iinfo(np.int64).max)
    np.minimum.at(minid, inv, np.arange(flat.size))
    return minid[inv].reshape(np.asarray(labels).shape).astype(np.int32)


def colorize(labels: jnp.ndarray, seed: int = 0) -> jnp.ndarray:
    """(H, W) int labels (root vertex ids in [0, H*W)) -> (H, W, 3) uint8.

    Colors are a pure function of (seed, component id): identical components
    get identical colors across hierarchy levels, like the reference's single
    color map reused per level.
    """
    h, w = labels.shape
    colors = jax.random.randint(
        jax.random.PRNGKey(seed), (h * w, 3), 30, 256, dtype=jnp.int32
    ).astype(jnp.uint8)
    return colors[labels.reshape(-1)].reshape(h, w, 3)


def colorize_hierarchy(levels: jnp.ndarray, seed: int = 0) -> jnp.ndarray:
    """(L, H, W) labels -> (L, H, W, 3) uint8 with one shared color map."""
    return jax.vmap(lambda lv: colorize(lv, seed))(levels)
