"""Brute-force nearest-neighbour search over point clouds.

The GICP hot loop (refine/gicp.py) needs, per iteration, the nearest target
point of every transformed source point, and the covariance stage needs each
point's k=20 nearest neighbours (ref fast_gicp kd-tree queries,
src/sgtd/include/fast_gicp/gicp/impl/fast_gicp_impl.hpp:118-155, 244-290;
the reference's CUDA tier does the same as a brute-force device kernel,
src/sgtd/src/fast_gicp/cuda/brute_force_knn.cu:36-40).

Squared distances use the exact difference form ``sum((q - r)**2)`` rather
than ``|q|^2 + |r|^2 - 2 q.r``: no cancellation at metric coordinates of
50-500 m and no matrix product that could run in reduced precision. XLA
fuses the broadcast-subtract-square-sum into the reduction that consumes it.

Masking follows the displaced-point convention (refine.gicp.knn_indices):
callers move masked points to a far coordinate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sq_dists(query: jnp.ndarray, ref: jnp.ndarray) -> jnp.ndarray:
    """(N, T) squared distances between (N, 3) and (T, 3) point sets."""
    d = query[:, None, :] - ref[None, :, :]
    return jnp.sum(d * d, axis=-1)


def _argmin_pair(a, b):
    """Reducer of (value, index) pairs: smaller value, then lower index."""
    av, ai = a
    bv, bi = b
    take_a = (av < bv) | ((av == bv) & (ai < bi))
    return jnp.where(take_a, av, bv), jnp.where(take_a, ai, bi)


def nn1(query: jnp.ndarray, ref: jnp.ndarray):
    """Nearest ``ref`` index + squared distance for each ``query`` point.

    query (N, 3), ref (T, 3). Returns (idx (N,) int32, sqdist (N,) float32);
    ties go to the lowest index (= jnp.argmin). One variadic reduction over
    the fused distance expression, so no (N, T) matrix is written out.
    """
    d = sq_dists(query, ref)
    cols = jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
    dmin, idx = jax.lax.reduce(
        (d, cols),
        (jnp.float32(jnp.inf), jnp.int32(ref.shape[0])),
        _argmin_pair,
        (1,),
    )
    return idx, dmin


def knn(query: jnp.ndarray, ref: jnp.ndarray, k: int) -> jnp.ndarray:
    """Indices of the k nearest ``ref`` points per ``query`` point: (N, k),
    distance-ascending, ties broken by lower index (lax.top_k semantics)."""
    _, idx = jax.lax.top_k(-sq_dists(query, ref), k)
    return idx.astype(jnp.int32)
