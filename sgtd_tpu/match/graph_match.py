"""Legacy coarse matcher: semantic-topology histograms + linear assignment.

JAX re-design of the reference's ``graph_match`` path
(src/sgtd/include/Semantic_Graph.hpp:359-521) — the alternate coarse matcher
superseded by the descriptor SearchLoop but kept for parity (SURVEY.md L5):

  * per-node feature: 9 classes x 12 range bins (5 m each) histogram of the
    other nodes (Semantic_Graph.hpp:385-407);
  * assignment on the histogram-distance cost with same-class gating and a
    density ratio gate (:414-426);
  * pairwise-distance consistency filter: a match survives when >= 20% of its
    co-matches preserve inter-node distances within 10% (:463-489);
  * final score = matched fraction (:492-494).

The reference solves assignment with a scipy-port LSAP / LAPJV
(linear_sum_assignment.hpp, lapjav.cpp — sequential augmenting paths); here
assignment is a batched Bertsekas auction (parallel bidding, fixed sweeps),
which matches LSAP on well-separated costs and fits a batched tensor program.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

_BIG = jnp.float32(1e9)


def node_histograms(
    centers: jnp.ndarray,
    labels: jnp.ndarray,
    mask: jnp.ndarray,
    num_classes: int = 9,
    num_bins: int = 12,
    bin_m: float = 5.0,
    label_base: int = 3,
) -> jnp.ndarray:
    """(N, num_classes * num_bins) semantic-topology histogram per node."""
    d = jnp.linalg.norm(
        centers[:, None, :] - centers[None, :, :], axis=-1
    )  # (N, N)
    bins = jnp.minimum((d / bin_m).astype(jnp.int32), num_bins - 1)
    cls = jnp.clip(labels - label_base, 0, num_classes - 1)
    feat_idx = cls[None, :] * num_bins + bins  # (N, N)
    weights = mask[None, :].astype(jnp.float32)
    flat = jax.vmap(
        lambda idx, w: jax.ops.segment_sum(
            w, idx, num_segments=num_classes * num_bins
        )
    )(feat_idx, jnp.broadcast_to(weights, feat_idx.shape))
    return jnp.where(mask[:, None], flat, 0.0)


def auction_assignment(
    cost: jnp.ndarray, valid: jnp.ndarray, sweeps: int = 64
) -> jnp.ndarray:
    """Min-cost assignment via Bertsekas auction. cost: (N, M) with _BIG for
    forbidden pairs; valid: (N,) rows to assign. Returns (N,) column index
    or -1."""
    n, m = cost.shape
    eps = 1e-3
    benefit = -cost  # maximize

    def sweep(state, _):
        price, owner = state  # (M,), (M,) owner row per column (-1 free)
        # Rows currently owning a column sit out; the rest bid.
        col_of_row = jnp.full((n,), -1, jnp.int32)
        col_of_row = col_of_row.at[jnp.where(owner >= 0, owner, n)].set(
            jnp.where(owner >= 0, jnp.arange(m, dtype=jnp.int32), -1),
            mode="drop",
        )
        unassigned = valid & (col_of_row < 0)

        value = benefit - price[None, :]  # (N, M)
        best = jnp.max(value, axis=1)
        best_j = jnp.argmax(value, axis=1)
        value2 = value.at[jnp.arange(n), best_j].set(-_BIG)
        second = jnp.max(value2, axis=1)
        bid = price[best_j] + (best - second) + eps  # (N,)

        # Highest bid per column wins.
        bid_masked = jnp.where(unassigned, bid, -_BIG)
        col_bid = jax.ops.segment_max(
            bid_masked, best_j, num_segments=m
        )
        has_bid = col_bid > -_BIG / 2
        # Winner row per column.
        is_winner = unassigned & (bid_masked >= col_bid[best_j] - 1e-6)
        winner_row = jax.ops.segment_max(
            jnp.where(is_winner, jnp.arange(n, dtype=jnp.int32), -1),
            best_j,
            num_segments=m,
        )
        new_price = jnp.where(has_bid, col_bid, price)
        new_owner = jnp.where(has_bid, winner_row, owner)
        return (new_price, new_owner), None

    price0 = jnp.zeros((m,), jnp.float32)
    owner0 = jnp.full((m,), -1, jnp.int32)
    (price, owner), _ = jax.lax.scan(sweep, (price0, owner0), None, length=sweeps)

    col_of_row = jnp.full((n,), -1, jnp.int32)
    col_of_row = col_of_row.at[jnp.where(owner >= 0, owner, n)].set(
        jnp.where(owner >= 0, jnp.arange(m, dtype=jnp.int32), -1), mode="drop"
    )
    # Reject forbidden assignments.
    c = cost[jnp.arange(n), jnp.maximum(col_of_row, 0)]
    return jnp.where(valid & (col_of_row >= 0) & (c < _BIG / 2), col_of_row, -1)


class GraphMatchResult(NamedTuple):
    matches: jnp.ndarray  # (N,) map-node index per query node, -1 unmatched
    score: jnp.ndarray  # () matched fraction


@functools.partial(jax.jit, static_argnames=())
def graph_match(
    q_centers, q_labels, q_density, q_mask,
    m_centers, m_labels, m_density, m_mask,
) -> GraphMatchResult:
    """Match a query graph against one map keyframe graph (legacy path).

    Nodes beyond 50 m of the sensor are ignored (ref :366,378).
    """
    q_mask = q_mask & (jnp.linalg.norm(q_centers, axis=-1) <= 50.0)
    m_mask = m_mask & (jnp.linalg.norm(m_centers, axis=-1) <= 50.0)

    fq = node_histograms(q_centers, q_labels, q_mask)
    fm = node_histograms(m_centers, m_labels, m_mask)

    # Histogram distance cost: sum over classes of row-wise L2
    # (ref :421-424 sums per-class row norms).
    dq = fq.reshape(-1, 9, 12)
    dm = fm.reshape(-1, 9, 12)
    diff = dq[:, None] - dm[None, :]  # (N, M, 9, 12)
    cost = jnp.sum(jnp.linalg.norm(diff, axis=-1), axis=-1)  # (N, M)

    same_class = q_labels[:, None] == m_labels[None, :]
    density_ok = (
        jnp.abs(q_density[:, None] - m_density[None, :])
        / jnp.maximum(q_density[:, None], 1e-6)
    ) <= 3.0
    feasible = same_class & density_ok & q_mask[:, None] & m_mask[None, :]
    cost = jnp.where(feasible, cost, _BIG)

    matches = auction_assignment(cost, q_mask)

    # Pairwise-distance consistency filter (ref :463-489).
    n = matches.shape[0]
    mi = matches
    has = mi >= 0
    dq_pair = jnp.linalg.norm(
        q_centers[:, None] - q_centers[None, :], axis=-1
    )
    mc = m_centers[jnp.maximum(mi, 0)]
    dm_pair = jnp.linalg.norm(mc[:, None] - mc[None, :], axis=-1)
    ok_pair = (
        has[None, :]
        & (jnp.arange(n)[:, None] != jnp.arange(n)[None, :])
    )
    consistent = jnp.abs(dq_pair - dm_pair) < dq_pair * 0.1
    num = jnp.sum((consistent & ok_pair).astype(jnp.float32), axis=1)
    den = jnp.maximum(jnp.sum(ok_pair.astype(jnp.float32), axis=1), 1.0)
    keep = (num / den) >= 0.2
    matches = jnp.where(has & keep, mi, -1)

    n_valid = jnp.maximum(jnp.sum(q_mask.astype(jnp.float32)), 1.0)
    score = jnp.sum((matches >= 0).astype(jnp.float32)) / n_valid
    return GraphMatchResult(matches=matches, score=score)
