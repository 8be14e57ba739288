"""Fast Euclidean Clustering (FEC) as a fixed-shape tensor program.

Tensor-program analog of the reference's alternate (non-DCVC) clustering
backend (src/sgtd/src/FEC.h:34-140, invoked — commented out — at
src/sgtd/src/get_json.cpp:196-197): connected components of the
"within ``tolerance``" euclidean-radius graph, followed by a
``min_component_size`` filter.

The reference runs a sequential one-pass kd-tree radius sweep with
retroactive min-label merging, capping each radius query at ``max_n``
neighbours. Here the neighbour graph is the k-nearest-neighbour graph
(k = ``max_n``) gated at ``tolerance`` — the same bounded-degree
approximation the reference makes — computed by the brute-force kNN
(ops.nn), and components resolve by iterated min-label
propagation with pointer jumping (O(log diameter) fully-parallel sweeps,
the same machinery as cluster.dcvc). Brute-force kNN bounds practical N
to ~8192 points, matching the per-class instance clouds the reference
applies FEC to.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from sgtd_tpu.ops import nn


class FecResult(NamedTuple):
    """labels: (N,) int32 cluster id per point (-1 = unclustered/filtered),
    ids compacted by descending cluster size;
    counts: (C,) float32 points per cluster id."""

    labels: jnp.ndarray
    counts: jnp.ndarray


@functools.partial(
    jax.jit, static_argnames=("max_n", "max_clusters")
)
def fec_cluster(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    tolerance,
    min_component_size,
    max_n: int = 16,
    max_clusters: int = 256,
) -> FecResult:
    """Cluster the masked points of one (class-filtered) cloud.

    points (N, 3) float32 padded; mask (N,) bool; tolerance: radius in
    metres (ref FEC.h radiusSearch tolorance); min_component_size: minimum
    cluster size (ref :36); max_n: neighbour cap (ref :64).

    ``max_n`` caveat: when a point's ``max_n`` nearest neighbours all lie
    inside a dense local clump, bridging radius edges beyond them are lost
    and a true radius-graph component can split (the reference's sequential
    sweep merges labels retroactively, so its cap binds less often). For
    dense instance clouds raise ``max_n`` above the expected local clump
    size — tests/test_fec.py::test_max_n_binds_on_dense_elongated_cluster
    demonstrates both regimes.
    """
    n = points.shape[0]
    pts_eff = jnp.where(mask[:, None], points, jnp.float32(1e6))
    idx = nn.knn(pts_eff, pts_eff, max_n)  # (N, k), self included
    d = pts_eff[idx] - pts_eff[:, None, :]
    within = jnp.sum(d * d, axis=-1) <= jnp.float32(tolerance) ** 2
    self_i = jnp.arange(n, dtype=jnp.int32)
    nidx = jnp.where(within & mask[:, None], idx, self_i[:, None])

    def body(state):
        label, _ = state
        new = jnp.minimum(label, jnp.min(label[nidx], axis=1))
        # Symmetrize: push my label down to my neighbours too (kNN edges
        # are directed; scatter-min covers the reverse direction).
        new = new.at[nidx].min(new[:, None])
        new = jnp.minimum(new, new[new])  # pointer jumping
        new = jnp.minimum(new, new[new])
        return new, jnp.any(new != label)

    label, _ = jax.lax.while_loop(
        lambda s: s[1], body, (self_i, jnp.bool_(True))
    )
    label = jnp.where(mask, label, n)

    # Component sizes; filter small components (ref FEC.h:110-128).
    sizes = jax.ops.segment_sum(
        mask.astype(jnp.float32), jnp.minimum(label, n), num_segments=n + 1
    )[:n]
    keep_root = sizes >= jnp.float32(min_component_size)

    # Compact kept roots into dense ids, largest first.
    is_root = (label == self_i) & mask & keep_root
    score = jnp.where(is_root, sizes, -1.0)
    top_score, top_root = jax.lax.top_k(score, min(max_clusters, n))
    slot_of_root = (
        jnp.full(n + 1, -1, jnp.int32)
        .at[jnp.where(top_score > 0, top_root, n)]
        .set(
            jnp.where(
                top_score > 0,
                jnp.arange(top_score.shape[0], dtype=jnp.int32),
                -1,
            ),
            mode="drop",
        )
    )
    labels = jnp.where(mask, slot_of_root[jnp.minimum(label, n)], -1)
    counts = jax.ops.segment_sum(
        (labels >= 0).astype(jnp.float32),
        jnp.where(labels >= 0, labels, top_score.shape[0]),
        num_segments=top_score.shape[0] + 1,
    )[: top_score.shape[0]]
    return FecResult(labels=labels, counts=counts)
