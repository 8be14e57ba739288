"""Batched GICP registration (generalized ICP, plane-regularized).

JAX re-design of the reference's fast_gicp CPU/CUDA engines
(src/fast_gicp/gicp/impl/fast_gicp_impl.hpp, lsq_registration_impl.hpp; the
CUDA tier src/fast_gicp/cuda/*.cu is the reference's device-kernel analog of
this module, SURVEY.md 2.2). Same math, different execution model:

  * per-point covariances from k=20 nearest neighbours with plane
    regularization — eigenvalues replaced by (1, 1, 1e-3)
    (fast_gicp_impl.hpp:244-290); kNN is a brute-force distance reduction
    + top-k instead of a kd-tree (ops.nn);
  * correspondences: nearest neighbour of each transformed source point
    (fast_gicp_impl.hpp:118-155) by the same brute-force search;
  * Mahalanobis weighting M = (C_B + R C_A R^T)^-1 with closed-form 3x3
    inverse;
  * Gauss-Newton on se(3) under ``lax.fori_loop`` (the reference's LM loop
    with early exit becomes a fixed-trip masked iteration — SURVEY.md
    hard-part (d)); convergence thresholds match lsq_registration_impl.hpp:82;
  * fitness = mean squared nearest-neighbour distance (PCL getFitnessScore
    semantics, consumed at semantic_graph_localization.cpp:702-720).

Everything vmaps over a candidate axis for the multi-candidate rerank.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sgtd_tpu.config import GicpConfig
from sgtd_tpu.geom import se3
from sgtd_tpu.ops.nn import knn, nn1
from sgtd_tpu.ops.linalg3 import inv3x3, matmul, sym_eig3x3
from sgtd_tpu.refine.lsq import gn_solve, lm_solve

_BIG = jnp.float32(1e30)


def _bsum_mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched (..., i, j) @ (..., j, k) as broadcast-multiply-sum.

    Huge batches of tiny (3x3) products fuse into plain elementwise work
    this way, exact in float32, instead of becoming batched dot_generals.
    """
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


class GicpResult(NamedTuple):
    """transform: (4, 4) refined src -> tgt.
    fitness:      () mean squared NN distance over all valid source points
                  (PCL getFitnessScore default semantics — dominated by
                  view-overlap geometry when the fields of view differ).
    num_inliers:  () correspondences within fitness_radius_m.
    fitness_gated:() mean squared NN distance over ONLY the
                  fitness_radius_m inliers — measures local surface
                  alignment, independent of overlap.
    inlier_frac:  () inlier fraction of valid source points — measures
                  overlap/coverage. The rerank pick combines the two gated
                  measures; raw fitness is kept for reference parity."""

    transform: jnp.ndarray
    fitness: jnp.ndarray
    num_inliers: jnp.ndarray
    fitness_gated: jnp.ndarray
    inlier_frac: jnp.ndarray


def _fitness_stats(sqd: jnp.ndarray, valid: jnp.ndarray, cfg: GicpConfig):
    """Raw + gated fitness statistics from final NN squared distances.

    Raw fitness is PCL getFitnessScore over all valid pairs (consumed at
    semantic_graph_localization.cpp:702-720); the gated pair
    (fitness_gated, inlier_frac) separates surface alignment from view
    overlap for the rerank pick (see GicpResult docstring)."""
    sqd = jnp.maximum(sqd, 0.0)  # f32 cancellation at exact matches
    n_valid = jnp.maximum(jnp.sum(valid.astype(jnp.float32)), 1.0)
    fitness = jnp.sum(jnp.where(valid, sqd, 0.0)) / n_valid
    r2 = jnp.float32(cfg.fitness_radius) ** 2
    inl = valid & (sqd < r2)
    n_inl = jnp.sum(inl.astype(jnp.float32))
    fitness_gated = jnp.sum(jnp.where(inl, sqd, 0.0)) / jnp.maximum(n_inl, 1.0)
    inlier_frac = n_inl / n_valid
    return fitness, n_inl.astype(jnp.int32), fitness_gated, inlier_frac


def knn_indices(points: jnp.ndarray, mask: jnp.ndarray, k: int) -> jnp.ndarray:
    """k nearest neighbours (self included) within one masked cloud: (N, k).

    Masking is done by DISPLACING masked points to a far coordinate rather
    than editing the distance matrix, so the distance expression feeds the
    reduction directly. Padding points cluster among themselves at the far
    coordinate; their outputs are gated by ``mask`` downstream.
    """
    pts_eff = jnp.where(mask[:, None], points, jnp.float32(1e6))
    return knn(pts_eff, pts_eff, k)


def point_covariances(
    points: jnp.ndarray, mask: jnp.ndarray, cfg: GicpConfig
) -> jnp.ndarray:
    """Plane-regularized per-point covariances (fast_gicp_impl.hpp:244-290)."""
    idx = knn_indices(points, mask, cfg.num_neighbors)
    neigh = points[idx]  # (N, k, 3)
    mu = jnp.mean(neigh, axis=1, keepdims=True)
    d = neigh - mu
    # Outer-product accumulation as broadcast-sum (see _bsum_mm).
    cov = jnp.sum(d[..., :, None] * d[..., None, :], axis=-3) / cfg.num_neighbors
    # Replace eigenvalues with (eps, 1, 1) ascending (PLANE regularization).
    _, vecs = sym_eig3x3(cov)
    vals_reg = jnp.asarray([cfg.plane_eps, 1.0, 1.0], cov.dtype)
    cov_reg = _bsum_mm(vecs * vals_reg[None, None, :], jnp.swapaxes(vecs, -1, -2))
    return jnp.where(mask[:, None, None], cov_reg, jnp.eye(3, dtype=cov.dtype))


def gicp_align(
    src: jnp.ndarray,
    src_mask: jnp.ndarray,
    tgt: jnp.ndarray,
    tgt_mask: jnp.ndarray,
    init_transform: jnp.ndarray,
    cfg: GicpConfig = GicpConfig(),
    src_cov: jnp.ndarray | None = None,
    tgt_cov: jnp.ndarray | None = None,
) -> GicpResult:
    """Align src onto tgt starting from init_transform (4, 4)."""
    if src_cov is None:
        src_cov = point_covariances(src, src_mask, cfg)
    if tgt_cov is None:
        tgt_cov = point_covariances(tgt, tgt_mask, cfg)

    # Masked target points displaced far away (see knn_indices).
    tgt_eff = jnp.where(tgt_mask[:, None], tgt, jnp.float32(1e6))
    n = src.shape[0]

    def nn_of(transformed):
        """Nearest target index + sq dist for each (transformed) src point."""
        return nn1(transformed, tgt_eff)

    def linearize(T):
        """linearize (fast_gicp_impl.hpp:118-176): correspondences + H, g.

        Small matmuls as broadcast-sums, reductions over points as ONE
        (6, 3N) x (3N, 6) matmul at full float32 precision.
        """
        R = T[:3, :3]
        moved = matmul(src, R.T) + T[:3, 3]
        nn, nn_sqd = nn_of(moved)
        b_pts = tgt[nn]
        cb = tgt_cov[nn]
        # Mahalanobis (C_B + R C_A R^T)^-1 (fast_gicp_impl.hpp:148-153).
        rn = jnp.broadcast_to(R, (n, 3, 3))
        rcr = cb + _bsum_mm(_bsum_mm(rn, src_cov), jnp.swapaxes(rn, -1, -2))
        M = inv3x3(rcr)
        r = b_pts - moved  # (N, 3)
        valid = src_mask & tgt_mask[nn]
        # Correspondence distance gate (ref corr_dist_threshold_,
        # fast_gicp_impl.hpp:139: gated pairs are dropped from H, b and the
        # cost). Infinite by default, matching the reference node.
        if np.isfinite(cfg.max_corr_dist_m):
            valid = valid & (nn_sqd < jnp.float32(cfg.max_corr_dist_m) ** 2)
        w = valid.astype(src.dtype)
        # J = [-I | skew(moved)] (3, 6) per point.
        sk = se3.hat(moved)  # (N, 3, 3)
        J = jnp.concatenate(
            [-jnp.broadcast_to(jnp.eye(3, dtype=src.dtype), sk.shape), sk],
            axis=-1,
        )  # (N, 3, 6)
        MJ = _bsum_mm(M, J)  # (N, 3, 6)
        Jw = (J * w[:, None, None]).reshape(n * 3, 6)
        H = matmul(Jw.T, MJ.reshape(n * 3, 6))  # (6, 6)
        Mr = jnp.sum(M * r[:, None, :], axis=-1)  # (N, 3) = M r
        g = matmul(Jw.T, Mr.reshape(n * 3))  # (6,)
        y0 = jnp.sum(w * jnp.sum(r * Mr, axis=-1))
        # aux carries the GATHERED target points, not the indices: error()
        # runs 8x per outer iteration inside LM's trust region, and
        # re-gathering tgt[nn] there would cost ~320k random rows per query
        # at rerank shapes; the 12 KB of gathered points are free to keep.
        return H, g, y0, (b_pts, M, w)

    def error(T, aux):
        """compute_error: same correspondences + Mahalanobis terms, new T
        (the reference reuses mahalanobis_ from the last linearization,
        fast_gicp_impl.hpp:178-200)."""
        b_pts, M, w = aux
        moved = matmul(src, T[:3, :3].T) + T[:3, 3]
        r = b_pts - moved
        Mr = jnp.sum(M * r[:, None, :], axis=-1)
        return jnp.sum(w * jnp.sum(r * Mr, axis=-1))

    T0 = init_transform.astype(src.dtype)
    if cfg.optimizer == "lm":
        res = lm_solve(
            linearize, error, T0,
            max_iterations=cfg.max_iterations,
            lm_inner=cfg.lm_max_inner,
            rot_eps=cfg.rot_eps,
            trans_eps=cfg.trans_eps,
            init_lambda_factor=cfg.lm_init_lambda_factor,
        )
    else:
        res = gn_solve(
            linearize, T0,
            max_iterations=cfg.max_iterations,
            rot_eps=cfg.rot_eps,
            trans_eps=cfg.trans_eps,
            damping=cfg.gn_damping,
        )
    T_final = res.transform

    moved = matmul(src, T_final[:3, :3].T) + T_final[:3, 3]
    nn, sqd = nn_of(moved)
    valid = src_mask & tgt_mask[nn]
    fitness, n_inl, fitness_gated, inlier_frac = _fitness_stats(
        sqd, valid, cfg
    )
    return GicpResult(
        transform=T_final,
        fitness=fitness,
        num_inliers=n_inl,
        fitness_gated=fitness_gated,
        inlier_frac=inlier_frac,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def gicp_rerank(
    src: jnp.ndarray,
    src_mask: jnp.ndarray,
    tgts: jnp.ndarray,
    tgt_masks: jnp.ndarray,
    init_transforms: jnp.ndarray,
    cfg: GicpConfig = GicpConfig(),
    tgt_covs: jnp.ndarray | None = None,
) -> GicpResult:
    """Multi-candidate GICP rerank (ref candidate loop,
    semantic_graph_localization.cpp:672-722): align the query cloud against
    K candidate map clouds, batched; the caller picks min fitness / applies
    the best_fitness early-accept. Source covariances are shared.

    src: (S, 3); tgts: (K, T, 3); init_transforms: (K, 4, 4).
    ``tgt_covs`` (K, T, 3, 3): precomputed target covariances — map
    keyframe clouds are fixed, so computing them once at map load removes
    the per-query kNN+eig over every candidate cloud (its dominant cost).
    """
    src_cov = point_covariances(src, src_mask, cfg)

    def one(tgt, tmask, T0, tcov):
        return gicp_align(
            src, src_mask, tgt, tmask, T0, cfg,
            src_cov=src_cov, tgt_cov=tcov,
        )

    if tgt_covs is None:
        tgt_covs = jax.vmap(
            lambda t, m: point_covariances(t, m, cfg)
        )(tgts, tgt_masks)
    return jax.vmap(one)(tgts, tgt_masks, init_transforms, tgt_covs)
