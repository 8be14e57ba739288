"""End-to-end one-shot localization pipeline (jittable).

JAX analog of ``STDescManager::SearchLoop`` plus the surrounding main
loop of the localization node (src/sgtd/src/STDesc.cpp:84-147,
src/sgtd/src/semantic_graph_localization.cpp:567-646): build the query's
triangle descriptors, vote for candidate keyframes, geometrically verify every
candidate, and return the score-sorted candidate list (the reference's
``match_result_list``) with rigid transforms.

The whole function is one jit program; batching over query scans is a vmap.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sgtd_tpu.config import SGTDConfig
from sgtd_tpu.db.database import DescriptorDB
from sgtd_tpu.desc.triangles import Descriptors, build_descriptors
from sgtd_tpu.geom import se3
from sgtd_tpu.graph.types import SemanticGraph
from sgtd_tpu.match.search import candidate_search
from sgtd_tpu.match.verify import verify_candidates
from sgtd_tpu.ops.linalg3 import matmul


class LocalizationResult(NamedTuple):
    """Score-sorted candidate list for one query scan.

    found:        () bool — best score exceeded icp_threshold
                  (ref STDesc.cpp:138).
    best_frame:   () int32 — top candidate keyframe id (-1 if none).
    best_score:   () float32.
    frames:       (C,) int32 — candidates sorted by verify score desc
                  (ref match_result_list sort,
                  semantic_graph_localization.cpp:603).
    scores:       (C,) float32.
    votes:        (C,) float32 — selector votes of the sorted candidates.
    rot:          (C, 3, 3) float32 — query-sensor -> map-keyframe-sensor.
    trans:        (C, 3) float32.
    poses:        (C, 4, 4) float32 — estimated world poses of the query
                  (frame_pose[c] @ T_loop[c],
                  ref semantic_graph_localization.cpp:747 without GICP).
    num_descriptors: () int32.
    truncated:    () int32 bitmask (search.TRUNC_SCAN | search.TRUNC_PAIRS):
                  nonzero when a static capacity cap clipped this query's
                  probe scan or pair lists — see
                  :func:`localize_exact` for the uncapped fallback.
    """

    found: jnp.ndarray
    best_frame: jnp.ndarray
    best_score: jnp.ndarray
    frames: jnp.ndarray
    scores: jnp.ndarray
    votes: jnp.ndarray
    rot: jnp.ndarray
    trans: jnp.ndarray
    poses: jnp.ndarray
    num_descriptors: jnp.ndarray
    truncated: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("config",))
def localize(
    db: DescriptorDB,
    graph: SemanticGraph,
    config: SGTDConfig = SGTDConfig(),
) -> LocalizationResult:
    query = build_descriptors(graph, config.desc, config.caps)
    return localize_descriptors(db, query, config)


@functools.partial(jax.jit, static_argnames=("config",))
def localize_descriptors(
    db: DescriptorDB,
    query: Descriptors,
    config: SGTDConfig = SGTDConfig(),
) -> LocalizationResult:
    cand = candidate_search(db, query, config.desc, config.search, config.caps)
    ver = verify_candidates(db, query, cand, config.search)

    order = jnp.argsort(-ver.scores, stable=True)
    frames = cand.frames[order]
    scores = ver.scores[order]
    votes = cand.votes[order]
    rot = ver.rot[order]
    trans = ver.trans[order]

    t_loop = se3.rt_to_mat(rot, trans)  # (C, 4, 4)
    poses = matmul(db.frame_poses[frames], t_loop)

    best_score = scores[0]
    found = best_score > jnp.float32(config.search.icp_threshold)
    best_frame = jnp.where(found, frames[0], -1)

    return LocalizationResult(
        found=found,
        best_frame=best_frame,
        best_score=best_score,
        frames=frames,
        scores=scores,
        votes=votes,
        rot=rot,
        trans=trans,
        poses=poses,
        num_descriptors=query.count,
        truncated=cand.truncated,
    )


def localize_exact(
    db: DescriptorDB,
    graph: SemanticGraph,
    config: SGTDConfig = SGTDConfig(),
) -> LocalizationResult:
    """Uncapped fallback for queries flagged ``truncated`` by :func:`localize`.

    Host-driven (not jittable as one program): first measures the query's
    true ragged-scan total, then re-runs the pipeline with
    ``caps.max_scan_slots`` raised to cover it exactly (one cached recompile
    per distinct cap) and with candidate-major pair extraction
    (``extract_pairs_by_frame`` — per-frame pair lists bounded only by
    ``pairs_per_candidate``, the reference's own subsampling bound,
    STDesc.cpp:467-468) instead of the per-descriptor ``hits_per_descriptor``
    cap. No silent vote or pair loss remains.
    """
    import dataclasses

    import numpy as np

    from sgtd_tpu.match.search import (
        build_probe_table,
        extract_pairs_by_frame,
        probe_and_hits,
        probe_ranges,
        select_candidates,
    )
    from sgtd_tpu.match.verify import verify_pairs

    query = build_descriptors(graph, config.desc, config.caps)
    s, e, ok = probe_ranges(db, query, config.desc)
    total = int(np.asarray(jnp.sum(jnp.where(ok, e - s, 0))))
    slots = 8192
    while slots < total:
        slots *= 2
    caps = dataclasses.replace(config.caps, max_scan_slots=slots)
    cfg = config.replace(caps=caps)

    ph = probe_and_hits(db, query, cfg.desc, cfg.search, cfg.caps)
    cand_votes, cand_frames, cand_valid = select_candidates(
        ph.votes, cfg.search
    )
    pkeys, pdesc = build_probe_table(query, cfg.desc)
    pair_qidx, pair_row, pair_valid = extract_pairs_by_frame(
        db, query, pkeys, pdesc, cand_frames, cand_valid, cfg.search, cfg.caps
    )
    vq = query.vertices[pair_qidx]
    vdb = db.vertices[pair_row]
    ver = verify_pairs(vq, vdb, pair_valid, cand_valid, cfg.search)

    order = jnp.argsort(-ver.scores, stable=True)
    frames = cand_frames[order]
    scores = ver.scores[order]
    rot = ver.rot[order]
    trans = ver.trans[order]
    t_loop = se3.rt_to_mat(rot, trans)
    poses = matmul(db.frame_poses[frames], t_loop)
    best_score = scores[0]
    found = best_score > jnp.float32(cfg.search.icp_threshold)
    return LocalizationResult(
        found=found,
        best_frame=jnp.where(found, frames[0], -1),
        best_score=best_score,
        frames=frames,
        scores=scores,
        votes=cand_votes[order],
        rot=rot,
        trans=trans,
        poses=poses,
        num_descriptors=query.count,
        truncated=jnp.int32(0),
    )


def localize_batch(
    db: DescriptorDB,
    graphs: SemanticGraph,
    config: SGTDConfig = SGTDConfig(),
) -> LocalizationResult:
    """vmap of :func:`localize` over a leading batch of query graphs."""
    fn = functools.partial(localize, config=config)
    return jax.vmap(fn, in_axes=(None, 0))(db, graphs)


class RefinedResult(NamedTuple):
    """LocalizationResult plus the GICP-refined world pose.

    pose:     (4, 4) float32 — final pose (refined when accepted, else the
              descriptor pose), ref semantic_graph_localization.cpp:747.
    refined:  () bool — GICP result was accepted (found, converged nearby).
    fitness:  () float32 — fitness of the picked candidate.
    result:   the underlying LocalizationResult.
    """

    pose: jnp.ndarray
    refined: jnp.ndarray
    fitness: jnp.ndarray
    result: LocalizationResult


@functools.partial(jax.jit, static_argnames=("config", "rerank_k"))
def localize_refined(
    db: DescriptorDB,
    graph: SemanticGraph,
    query_cloud: jnp.ndarray,
    query_mask: jnp.ndarray,
    map_clouds: jnp.ndarray,
    map_masks: jnp.ndarray,
    map_covs: jnp.ndarray | None = None,
    config: SGTDConfig = SGTDConfig(),
    rerank_k: int = 4,
    map_vmaps=None,
) -> RefinedResult:
    """One-shot localization INCLUDING multi-candidate GICP rerank, as one
    XLA program — the analog of the reference's full headline configuration
    (SG-STD-gicp-multi: candidate loop semantic_graph_localization.cpp:651-723).

    The reference runs GICP serially per candidate with an early break; here
    the top ``rerank_k`` candidates align batched (compute is cheap once
    lowered properly, BENCH_NOTES.md) and the pick reproduces the early-
    accept semantics: first candidate in score order with fitness below
    best_fitness, else the minimum-fitness candidate (ref :703-720).

    map_clouds (F, P, 3) / map_masks (F, P) / map_covs (F, P, 3, 3) are the
    per-keyframe clouds + precomputed GICP covariances pinned on device.
    ``map_vmaps``: prebuilt per-keyframe Gaussian voxel maps
    (refine.vgicp.build_voxel_maps, leading F axis) — with
    ``engine == "vgicp"`` the rerank then needs no per-query voxel-map
    build and no map_covs (pass None): pure gathers into the voxel tables.
    """
    from sgtd_tpu.refine.gicp import gicp_rerank
    from sgtd_tpu.refine.vgicp import vgicp_rerank

    res = localize(db, graph, config)
    frames_k = res.frames[:rerank_k]  # (K,) score-sorted
    inits = se3.rt_to_mat(res.rot[:rerank_k], res.trans[:rerank_k])
    if config.gicp.engine == "vgicp" and map_vmaps is not None:
        vm_k = jax.tree_util.tree_map(lambda x: x[frames_k], map_vmaps)
        out = vgicp_rerank(
            query_cloud, query_mask, query_cloud, query_mask, inits,
            config.gicp, voxel_maps=vm_k,
        )
    else:
        tgts = map_clouds[frames_k]
        tmasks = map_masks[frames_k]
        tcovs = None if map_covs is None else map_covs[frames_k]
        rerank = vgicp_rerank if config.gicp.engine == "vgicp" else gicp_rerank
        out = rerank(
            query_cloud, query_mask, tgts, tmasks, inits, config.gicp,
            tgt_covs=tcovs,
        )
    pick, use, refined_poses = rerank_pick(
        out.fitness_gated, out.inlier_frac,
        matmul(db.frame_poses[frames_k], out.transform),
        res.poses[:rerank_k], res.found, config.gicp,
    )
    return RefinedResult(
        pose=jnp.where(use, refined_poses[pick], res.poses[0]),
        refined=use,
        fitness=out.fitness[pick],
        result=res,
    )


def rerank_pick(fitness_gated, inlier_frac, refined_poses, init_poses,
                found, gcfg):
    """Candidate pick + divergence guard for the GICP rerank.

    The reference picks the candidate with minimum RAW fitness (mean
    squared NN distance over ALL points) with a best_fitness early break
    (semantic_graph_localization.cpp:703-720). Two deliberate departures,
    both measured on the aliased hard workload (tools/diag_rescue.py):

    1. OVERLAP-NORMALIZED score. Raw fitness is dominated by view-overlap
       geometry when query and keyframe fields of view differ: the CORRECT
       candidate routinely shows 2-10x the raw fitness of a wrong aliased
       candidate purely because its keyframe disc is offset further
       (measured: correct fit=71.8 vs aliased-wrong fit=31.1 → the raw
       pick teleports the pose 100 m). The pick instead maximises
       ``inlier_frac - 0.1 * fitness_gated``: the fraction of query points
       finding surface within cfg.fitness_radius (which a wrong aliased
       frame cannot match — it lacks the query's unique structure), with
       gated alignment error as tie-break.

    2. PER-CANDIDATE divergence guard. Each refined pose is compared (both
       translation and rotation) against that candidate's OWN
       geometrically-verified descriptor pose; a refinement that leaves
       its own init's neighbourhood is a wrong-basin ICP on repetitive
       structure and is excluded. Guarding per candidate (not against the
       top-1 pose, as rounds 2-4 did) is what makes FRAME RESCUE possible:
       when the top-1 is the wrong keyframe, the correct candidate's
       refined pose is necessarily far from top-1's pose, and a
       top-1-relative guard structurally rejected every rescue (VERDICT
       r4 weak #1 — SR_gicp was pinned to SR_desc with ~8 points in R@5).

    fitness_gated/inlier_frac: (K,); refined_poses/init_poses: (K, 4, 4);
    found: () bool. Returns (pick () int32, use () bool, refined_poses).
    """
    shift = jnp.linalg.norm(
        refined_poses[:, :3, 3] - init_poses[:, :3, 3], axis=-1
    )
    # Rotation shift: angle of R_refined R_init^T. Wrong-basin refinements
    # on low-structure clouds can rotate grossly while translating little,
    # so the guard gates both components.
    dR = matmul(
        refined_poses[:, :3, :3], jnp.swapaxes(init_poses[:, :3, :3], -1, -2)
    )
    tr = jnp.clip((jnp.trace(dR, axis1=-2, axis2=-1) - 1.0) * 0.5, -1.0, 1.0)
    rot_deg = jnp.degrees(jnp.arccos(tr))
    guard_ok = (shift <= jnp.float32(gcfg.max_refine_shift_m)) & (
        rot_deg <= jnp.float32(gcfg.max_refine_rot_deg)
    )
    score = jnp.where(
        guard_ok,
        inlier_frac - jnp.float32(0.1) * fitness_gated,
        -jnp.float32(jnp.inf),
    )
    pick = jnp.argmax(score)
    use = found & jnp.any(guard_ok)
    return pick, use, refined_poses
