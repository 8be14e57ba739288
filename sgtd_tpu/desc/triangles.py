"""Semantic-guided triangle descriptor construction (batched, jittable).

JAX re-design of the reference's ``STDescManager::BuildSingleScanSTD``
(src/sgtd/src/STDesc.cpp:174-315). The reference walks a PCL kd-tree per
centroid and fills hash maps; here the whole scan is one fixed-shape tensor
program:

  1. dense pairwise distances over the (padded) node set,
  2. top-k nearest neighbours per node (dense distances, no tree),
  3. static enumeration of all (m, n) neighbour pairs -> N * C(k-1, 2)
     candidate triangles,
  4. side-length gating + vertex ordering by opposite-side length,
  5. first-occurrence deduplication on mm-quantised side triples via a
     lexicographic sort (replacing the reference's ``feat_map`` hash,
     STDesc.cpp:244-251),
  6. compaction into a padded descriptor set.

Semantics match the reference exactly: triangle sides sorted ascending
(a <= b <= c), vertex A opposite the longest side, B opposite the middle,
C opposite the shortest (STDesc.cpp:209-291), side lengths stored scaled by
1/std_side_resolution (STDesc.cpp:298), dedup on truncated (a,b,c)*1000.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sgtd_tpu.config import CapacityConfig, DescriptorConfig
from sgtd_tpu.graph.types import SemanticGraph

_BIG = jnp.float32(1e30)


class Descriptors(NamedTuple):
    """Padded per-scan triangle descriptor set.

    sides:    (D, 3) float32 — scaled side lengths, ascending.
    angles:   (D, 3) float32 — |cos| of the triangle's interior angles
                               (ref STDesc.cpp:299-301).
    vertices: (D, 3, 3) float32 — rows A, B, C.
    labels:   (D, 3) int32 — semantic labels attached to A, B, C.
    node_ids: (D, 3) int32 — graph node indices of A, B, C.
    center:   (D, 3) float32 — triangle centroid.
    mask:     (D,) bool.
    """

    sides: jnp.ndarray
    angles: jnp.ndarray
    vertices: jnp.ndarray
    labels: jnp.ndarray
    node_ids: jnp.ndarray
    center: jnp.ndarray
    mask: jnp.ndarray

    @property
    def count(self):
        return jnp.sum(self.mask.astype(jnp.int32))


def _pair_indices(near_num: int):
    """Static (m, n) neighbour-slot pairs, 1 <= m < n < near_num.

    Mirrors the loop nest at STDesc.cpp:193-194 (slot 0 is the query point
    itself, returned first by the kNN search).
    """
    ms, ns = [], []
    for m in range(1, near_num - 1):
        for n in range(m + 1, near_num):
            ms.append(m)
            ns.append(n)
    return jnp.asarray(ms, dtype=jnp.int32), jnp.asarray(ns, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("cfg", "caps"))
def build_descriptors(
    graph: SemanticGraph,
    cfg: DescriptorConfig = DescriptorConfig(),
    caps: CapacityConfig = CapacityConfig(),
) -> Descriptors:
    """Build the scan's triangle descriptors from its semantic graph."""
    pts = graph.centers.astype(jnp.float32)  # (N, 3)
    mask = graph.mask
    n_nodes = pts.shape[0]
    near = min(cfg.near_num, n_nodes)

    # --- kNN over the padded node set (self included at slot 0). ---
    # Masked nodes are pushed to +inf so they never appear as neighbours.
    diff = pts[:, None, :] - pts[None, :, :]
    dist2 = jnp.sum(diff * diff, axis=-1)
    valid_pair = mask[:, None] & mask[None, :]
    dist2 = jnp.where(valid_pair, dist2, _BIG)
    # Ensure self-distance is exactly 0 for valid nodes so slot 0 == self.
    dist2 = jnp.where(
        jnp.eye(n_nodes, dtype=bool) & mask[:, None], 0.0, dist2
    )
    neg_d, knn_idx = jax.lax.top_k(-dist2, near)  # (N, near)
    knn_valid = -neg_d < _BIG * 0.5

    # --- enumerate candidate triangles (i, m, n). ---
    m_slots, n_slots = _pair_indices(near)  # (P,)
    p2 = knn_idx[:, m_slots]  # (N, P) neighbour index for slot m
    p3 = knn_idx[:, n_slots]
    v2ok = knn_valid[:, m_slots]
    v3ok = knn_valid[:, n_slots]

    x1 = pts[:, None, :]  # (N, 1, 3)
    x2 = pts[p2]  # (N, P, 3)
    x3 = pts[p3]

    a = jnp.linalg.norm(x1 - x2, axis=-1)  # |p1-p2|
    b = jnp.linalg.norm(x1 - x3, axis=-1)  # |p1-p3|
    c = jnp.linalg.norm(x3 - x2, axis=-1)  # |p3-p2|
    raw_sides = jnp.stack([a, b, c], axis=-1)  # (N, P, 3)

    len_ok = jnp.all(
        (raw_sides >= cfg.min_len) & (raw_sides <= cfg.max_len), axis=-1
    )
    tri_valid = mask[:, None] & v2ok & v3ok & len_ok  # (N, P)

    # --- sort sides ascending; order vertices by opposite-side length. ---
    # Opposite vertices: side a=|p1p2| <-> p3, b=|p1p3| <-> p2, c=|p2p3| <-> p1.
    order = jnp.argsort(raw_sides, axis=-1, stable=True)  # (N, P, 3)
    sides_sorted = jnp.take_along_axis(raw_sides, order, axis=-1)
    # Vertex A is opposite the longest side, B the middle, C the shortest
    # (equivalently: A = shared vertex of the two shortest sides,
    # STDesc.cpp:252-291).
    verts = jnp.stack([x3, x2, jnp.broadcast_to(x1, x2.shape)], axis=-2)
    # verts[..., s, :] is the vertex opposite side s in (a, b, c) order.
    opp_order = order[..., ::-1]  # longest, middle, shortest
    abc = jnp.take_along_axis(verts, opp_order[..., None], axis=-2)  # (N,P,3,3)

    node_idx3 = jnp.stack(
        [p3, p2, jnp.broadcast_to(jnp.arange(n_nodes, dtype=p2.dtype)[:, None], p2.shape)],
        axis=-1,
    )  # (N, P, 3): node index opposite each of (a, b, c)
    abc_nodes = jnp.take_along_axis(node_idx3, opp_order, axis=-1)  # (N, P, 3)
    abc_labels = graph.labels[abc_nodes]

    # Interior-angle cosines (ref STDesc.cpp:299-301), on sorted sides.
    sa, sb, sc = (
        sides_sorted[..., 0],
        sides_sorted[..., 1],
        sides_sorted[..., 2],
    )
    eps = 1e-12
    angles = jnp.stack(
        [
            jnp.abs((sb * sb + sc * sc - sa * sa) / (2 * sb * sc + eps)),
            jnp.abs((sa * sa + sc * sc - sb * sb) / (2 * sa * sc + eps)),
            jnp.abs((sa * sa + sb * sb - sc * sc) / (2 * sa * sb + eps)),
        ],
        axis=-1,
    )

    # --- first-occurrence dedup on truncated mm side triples. ---
    # int32-safe: lexicographic sort over the quantised components instead of
    # a single wide key (values <= max_len * 1000 fit easily in int32).
    q = jnp.trunc(sides_sorted * 1000.0).astype(jnp.int32)  # (N, P, 3)
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    q_f = flat(q)
    tri_valid_f = flat(tri_valid)
    n_flat = q_f.shape[0]
    flat_idx = jnp.arange(n_flat, dtype=jnp.int32)
    invalid = (~tri_valid_f).astype(jnp.int32)
    # Lexicographic (invalid, q0, q1, q2, flat position) sort -> first of each
    # key group is the earliest triangle in (i, m, n) enumeration order,
    # matching the reference's insertion-order feat_map semantics.
    perm = jnp.lexsort((flat_idx, q_f[:, 2], q_f[:, 1], q_f[:, 0], invalid))
    q_s = q_f[perm]
    inv_s = invalid[perm]
    same_as_prev = jnp.concatenate(
        [
            jnp.zeros((1,), dtype=bool),
            jnp.all(q_s[1:] == q_s[:-1], axis=-1) & (inv_s[1:] == inv_s[:-1]),
        ]
    )
    keep_sorted = (~same_as_prev) & (inv_s == 0)
    keep = jnp.zeros(n_flat, dtype=bool).at[perm].set(keep_sorted)

    # --- compact the survivors into D_MAX slots, preserving flat order. ---
    d_max = caps.max_descriptors
    priority = jnp.where(keep, flat_idx, jnp.int32(n_flat))
    comp = jnp.argsort(priority)[:d_max]
    out_mask = priority[comp] < n_flat

    take = lambda x: flat(x)[comp]
    abc_c = take(abc)
    return Descriptors(
        sides=take(sides_sorted) * jnp.float32(cfg.scale),
        angles=take(angles),
        vertices=abc_c,
        labels=take(abc_labels).astype(jnp.int32),
        node_ids=take(abc_nodes).astype(jnp.int32),
        center=jnp.mean(abc_c, axis=-2),
        mask=out_mask,
    )
