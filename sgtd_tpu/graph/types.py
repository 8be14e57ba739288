"""Semantic-graph keyframe representation as fixed-shape arrays.

JAX analog of the reference ``Graph`` struct
(src/sgtd/include/Semantic_Graph.hpp:62-111): per keyframe a set of semantic
instance nodes (centroid + class label). Dynamic std::vectors become padded
arrays with a validity mask so every scan has an identical shape and the
whole pipeline stays jit-compatible.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class SemanticGraph(NamedTuple):
    """One keyframe's semantic instance graph (padded to ``max_nodes``).

    centers: (N, 3) float32 — instance centroids in the sensor frame.
    labels:  (N,)  int32   — remapped node class labels (3..12 valid,
                             ref get_json.cpp:287-293).
    density: (N,)  float32 — per-instance spread (mean squared distance to
                             centroid, ref get_json.cpp:278-284).
    mask:    (N,)  bool    — True for real nodes, False for padding.
    pose:    (4, 4) float32 — keyframe pose (sensor/base in world frame).
    """

    centers: jnp.ndarray
    labels: jnp.ndarray
    density: jnp.ndarray
    mask: jnp.ndarray
    pose: jnp.ndarray

    @property
    def num_nodes(self):
        return jnp.sum(self.mask.astype(jnp.int32))


def make_graph(
    centers: np.ndarray,
    labels: np.ndarray,
    pose: np.ndarray,
    max_nodes: int,
    density: np.ndarray | None = None,
) -> SemanticGraph:
    """Build a padded SemanticGraph from variable-length host arrays."""
    centers = np.asarray(centers, dtype=np.float32).reshape(-1, 3)
    labels = np.asarray(labels, dtype=np.int32).reshape(-1)
    n = centers.shape[0]
    if n > max_nodes:
        # Keep the nodes closest to the sensor, mirroring the reference's
        # implicit preference for nearby instances (range-gated clustering).
        order = np.argsort(np.linalg.norm(centers, axis=1), kind="stable")[:max_nodes]
        order = np.sort(order)
        centers, labels = centers[order], labels[order]
        if density is not None:
            density = np.asarray(density, dtype=np.float32)[order]
        n = max_nodes
    pad = max_nodes - n
    c = np.pad(centers, ((0, pad), (0, 0)))
    l = np.pad(labels, (0, pad))
    d = np.zeros(max_nodes, dtype=np.float32)
    if density is not None:
        d[:n] = np.asarray(density, dtype=np.float32)[:n]
    m = np.zeros(max_nodes, dtype=bool)
    m[:n] = True
    # Host-backed arrays: a SemanticGraph is jit-ready as-is, and keeping
    # fields in NumPy avoids one device transfer per field per graph
    # (stacking transfers once per field instead).
    return SemanticGraph(
        centers=c,
        labels=l,
        density=d,
        mask=m,
        pose=np.asarray(pose, dtype=np.float32).reshape(4, 4),
    )
