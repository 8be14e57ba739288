"""Geometric verification: batched SVD pose hypotheses + inlier voting.

JAX re-design of ``STDescManager::candidate_verify`` and
``triangle_solver`` (src/sgtd/src/STDesc.cpp:462-571). The reference loops
over sampled match pairs under OpenMP, solving one 3x3 SVD per hypothesis and
counting inliers serially; here all candidates x hypotheses x pairs are one
batched tensor program (the data-dependent early-exit becomes a masked argmax,
SURVEY.md hard-part (d)).

Semantics:
  * hypothesis sampling with skip_len = n_pairs // 50 + 1 (STDesc.cpp:467);
  * rigid solve: SVD of the centred vertex cross-covariance with det fix
    (STDesc.cpp:549-571);
  * inlier = all three transformed vertices within 3 m (STDesc.cpp:469,498);
  * accept when the best hypothesis has >= 4 votes; the verify score is the
    inlier count under the best hypothesis, else -1 (STDesc.cpp:515-543).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sgtd_tpu.config import SearchConfig
from sgtd_tpu.db.database import DescriptorDB
from sgtd_tpu.desc.triangles import Descriptors
from sgtd_tpu.match.search import CandidateSet
from sgtd_tpu.ops.linalg3 import kabsch


class VerifyResult(NamedTuple):
    """Per-candidate verification output (vote-order, same as CandidateSet).

    scores:  (C,) float32 — inlier count, or -1 when rejected.
    rot:     (C, 3, 3) float32 — query-frame -> map-keyframe rotation.
    trans:   (C, 3) float32.
    inliers: (C, P) bool — inlier mask over the candidate's pair list.
    """

    scores: jnp.ndarray
    rot: jnp.ndarray
    trans: jnp.ndarray
    inliers: jnp.ndarray


def triangle_solver(src_verts: jnp.ndarray, ref_verts: jnp.ndarray):
    """Rigid transform mapping src triangle onto ref triangle.

    src_verts/ref_verts: (..., 3, 3) with rows A, B, C.
    Returns (rot (..., 3, 3), t (..., 3)) such that rot @ src + t ~= ref.
    Same optimum as the reference's SVD + reflection fix (STDesc.cpp:549-571)
    computed with the quaternion Kabsch (always a proper rotation): a
    closed form instead of XLA's iterative batched SVD for tiny matrices
    (see sgtd_tpu.ops.linalg3).
    """
    return kabsch(src_verts, ref_verts)


def hypothesis_votes(
    rot_h: jnp.ndarray,
    t_h: jnp.ndarray,
    vq: jnp.ndarray,
    vdb: jnp.ndarray,
    pair_valid: jnp.ndarray,
    thr: float,
) -> jnp.ndarray:
    """Inlier vote count of every (candidate, hypothesis): (C, H) int32.

    rot_h (C, H, 3, 3); t_h (C, H, 3); vq/vdb (C, P, 3, 3) vertex rows
    A,B,C; pair_valid (C, P) bool. A pair votes for hypothesis h when all
    three of its transformed query vertices lie within ``thr`` metres of
    the DB vertices (ref STDesc.cpp:487-502).

    The contraction over the 3 coordinates is written out as products and
    sums, not as a dot: XLA then fuses transform, distance, threshold and
    count into one reduction over P with no (C, H, P) tensor in memory, and
    no matrix unit runs the metric coordinates at reduced precision.
    """
    thr2 = jnp.float32(thr) ** 2
    r = rot_h[:, :, None, None, :, :]  # (C, H, 1, 1, 3, 3)
    t = t_h[:, :, None, None, :]  # (C, H, 1, 1, 3)
    v = vq[:, None, :, :, None, :]  # (C, 1, P, 3, 1, 3)
    moved = (
        r[..., 0] * v[..., 0] + r[..., 1] * v[..., 1] + r[..., 2] * v[..., 2]
    ) + t  # (C, H, P, 3 vertices, 3 coords)
    diff = moved - vdb[:, None]
    d2 = diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2
    inlier = (
        (d2[..., 0] < thr2) & (d2[..., 1] < thr2) & (d2[..., 2] < thr2)
        & pair_valid[:, None, :]
    )  # (C, H, P), fused into the count below
    return jnp.sum(inlier.astype(jnp.int32), axis=-1)


@functools.partial(jax.jit, static_argnames=("search",))
def verify_candidates(
    db: DescriptorDB,
    query: Descriptors,
    cand: CandidateSet,
    search: SearchConfig = SearchConfig(),
) -> VerifyResult:
    vq = query.vertices[cand.pair_qidx]  # (C, P, 3, 3)
    vdb = db.vertices[cand.pair_row]  # (C, P, 3, 3)
    return verify_pairs(vq, vdb, cand.pair_valid, cand.valid, search)


def verify_pairs(
    vq: jnp.ndarray,
    vdb: jnp.ndarray,
    pair_valid: jnp.ndarray,
    cand_valid: jnp.ndarray,
    search: SearchConfig = SearchConfig(),
) -> VerifyResult:
    """Core verification on gathered vertex triples.

    vq/vdb: (C, P, 3, 3) query/DB triangle vertices per match pair.
    pair_valid: (C, P); valid pairs must form a prefix of each row
    (hypothesis sampling indexes by pair position, ref STDesc.cpp:482).
    """
    c, p = pair_valid.shape
    h = search.max_hypotheses
    n_pairs = jnp.sum(pair_valid.astype(jnp.int32), axis=-1)  # (C,)

    # Hypothesis sampling (ref skip_len subsampling, STDesc.cpp:467-482).
    skip = n_pairs // h + 1  # (C,)
    use_size = n_pairs // skip
    h_idx = jnp.arange(h, dtype=jnp.int32)[None, :] * skip[:, None]  # (C, H)
    h_valid = jnp.arange(h, dtype=jnp.int32)[None, :] < use_size[:, None]
    h_idx = jnp.minimum(h_idx, p - 1)

    take_h = lambda x: jnp.take_along_axis(
        x, h_idx[..., None, None], axis=1
    )  # (C, H, 3, 3)
    rot_h, t_h = triangle_solver(take_h(vq), take_h(vdb))  # (C, H, 3, 3)

    # Inlier voting: all three vertices within dis_threshold
    # (STDesc.cpp:487-502).
    votes_h = hypothesis_votes(
        rot_h, t_h, vq, vdb, pair_valid, search.verify_dis_threshold
    )  # (C, H) int32
    votes_h = jnp.where(h_valid, votes_h, -1)

    best_h = jnp.argmax(votes_h, axis=-1)  # (C,)
    max_vote = jnp.max(votes_h, axis=-1)

    def take_best(x):
        idx = best_h.reshape((c,) + (1,) * (x.ndim - 1))
        return jnp.take_along_axis(x, idx, axis=1)[:, 0]
    rot_b = take_best(rot_h)  # (C, 3, 3)
    t_b = take_best(t_h)  # (C, 3)
    # Inlier mask re-derived for the best hypothesis ONLY: O(C, P) instead
    # of carrying the full (C, H, P) mask out of the vote pass.
    moved_b = (
        jnp.sum(rot_b[:, None, None] * vq[:, :, :, None, :], axis=-1)
        + t_b[:, None, None, :]
    )  # (C, P, 3, 3)
    d_b = jnp.linalg.norm(moved_b - vdb, axis=-1)  # (C, P, 3)
    inl_b = (
        jnp.all(d_b < jnp.float32(search.verify_dis_threshold), axis=-1)
        & pair_valid
    )  # (C, P)

    accepted = (max_vote >= search.min_hypothesis_votes) & cand_valid
    score = jnp.where(
        accepted, jnp.sum(inl_b.astype(jnp.float32), axis=-1), -1.0
    )

    # Pose polish the reference lacks: re-estimate the rigid transform by
    # weighted Kabsch over ALL inlier vertex correspondences instead of the
    # single best triangle pair (the reference returns the one-triangle SVD,
    # STDesc.cpp:516-521, leaving refinement to GICP). This costs one more
    # batched 3x3 SVD and substantially tightens the descriptor-only pose.
    w = inl_b.astype(jnp.float32)[..., None]  # (C, P, 1)
    w3 = jnp.repeat(w, 3, axis=-1).reshape(c, -1)  # (C, 3P) per-vertex weight
    fq = vq.reshape(c, -1, 3)
    fdb = vdb.reshape(c, -1, 3)
    rot_r, t_r = kabsch(fq, fdb, weights=w3)
    # Fall back to the sampled hypothesis when refinement is degenerate
    # (< 2 inlier pairs cannot over-determine the transform).
    n_inl = jnp.sum(inl_b.astype(jnp.int32), axis=-1)
    use_ref = (accepted & (n_inl >= 2))[:, None]
    rot_f = jnp.where(use_ref[..., None], rot_r, rot_b)
    t_f = jnp.where(use_ref, t_r, t_b)

    return VerifyResult(
        scores=score,
        rot=rot_f,
        trans=t_f,
        inliers=inl_b & accepted[:, None],
    )
