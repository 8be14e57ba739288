"""Ablation of the rerank pick heuristics in localize_refined.

The shipped pick (round 5, match.pipeline.rerank_pick) deviates from the
reference's literal serial early-break candidate loop
(semantic_graph_localization.cpp:703-720) in two measured ways: the score
is OVERLAP-NORMALIZED (inlier_frac - 0.1 * fitness_gated instead of raw
mean-squared-NN fitness) and a PER-CANDIDATE divergence guard
(translation + rotation vs each candidate's own descriptor pose) excludes
wrong-basin refinements. This evaluates every pick variant from ONE set
of rerank outputs on the bench workload (planar surface clouds):

  prod        = overlap-score argmax + per-candidate guard (shipped)
  raw-fitness = the reference's early-accept on raw fitness + guard
                (the round-2..4 pick)
  no-guard    = overlap-score argmax, guard disabled
  argmin-raw  = pure min-raw-fitness pick + guard (reference pick proper)
  descriptor  = no GICP refinement at all

Run: python tools/ablate_heuristics.py
"""

import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    from sgtd_tpu import SGTDConfig
    from sgtd_tpu.data.synthetic import make_map_and_queries, render_planar_cloud
    from sgtd_tpu.db.device_build import build_database_calibrated
    from sgtd_tpu.db.database import tuned_config
    from sgtd_tpu.eval.metrics import rpe
    from sgtd_tpu.eval.runner import build_descriptors_chunked, stack_graphs as stack
    from sgtd_tpu.geom import se3
    from sgtd_tpu.match.pipeline import localize
    from sgtd_tpu.match.search import fit_scan_slots
    from sgtd_tpu.ops.voxel import load_query_cloud
    from sgtd_tpu.refine.gicp import gicp_rerank, point_covariances

    cfg = SGTDConfig()
    num_map, num_q, K = 200, 64, 4
    maps, queries, world = make_map_and_queries(
        cfg, seed=2026, num_map_frames=num_map, num_queries=num_q,
        center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05,
    )
    map_batch = stack(maps)
    map_descs = build_descriptors_chunked(map_batch, cfg)
    qall = stack(queries)
    sample_descs = build_descriptors_chunked(
        jax.tree_util.tree_map(lambda x: x[:16], qall), cfg
    )
    db, report, totals = build_database_calibrated(
        map_descs, map_batch.pose, sample_descs, cfg.desc
    )
    cfg = tuned_config(cfg, report)
    cfg = fit_scan_slots(int(np.asarray(totals).max()), cfg)
    print(f"[abl] rows={report.num_rows}", file=sys.stderr)

    rng = np.random.default_rng(77)
    m = [render_planar_cloud(world, p, rng, max_points=4096)
         for p in world.map_poses]
    map_clouds = jnp.asarray(np.stack([c for c, _ in m]))
    map_masks = jnp.asarray(np.stack([k for _, k in m]))
    map_covs = jax.jit(
        jax.vmap(functools.partial(point_covariances, cfg=cfg.gicp))
    )(map_clouds, map_masks)
    q = []
    for p_ in world.query_poses:
        c, mk = render_planar_cloud(world, p_, rng, max_points=4096)
        q.append(load_query_cloud(c[mk], cfg.gicp.leaf_size, 1024))
    qc = jnp.asarray(np.stack([c for c, _ in q]))
    qm = jnp.asarray(np.stack([k for _, k in q]))

    chunk = 16
    loc = jax.jit(jax.vmap(functools.partial(localize, config=cfg),
                           in_axes=(None, 0)))
    rr = jax.jit(jax.vmap(
        lambda s, sm, t, tm, T0, tc: gicp_rerank(
            s, sm, t, tm, T0, cfg.gicp, tgt_covs=tc
        )
    ))

    frames_all, fits_all, fitg_all, frac_all = [], [], [], []
    tfs_all, desc_poses, init_poses = [], [], []
    for i in range(0, num_q, chunk):
        g = jax.tree_util.tree_map(lambda x: x[i:i + chunk], qall)
        res = jax.block_until_ready(loc(db, g))
        fk = res.frames[:, :K]
        inits = jax.vmap(se3.rt_to_mat)(res.rot[:, :K], res.trans[:, :K])
        out = jax.block_until_ready(rr(
            qc[i:i + chunk], qm[i:i + chunk],
            map_clouds[fk], map_masks[fk], inits, map_covs[fk],
        ))
        frames_all.append(np.asarray(fk))
        fits_all.append(np.asarray(out.fitness))
        fitg_all.append(np.asarray(out.fitness_gated))
        frac_all.append(np.asarray(out.inlier_frac))
        tfs_all.append(np.asarray(out.transform))
        desc_poses.append(np.asarray(res.poses[:, 0]))
        init_poses.append(np.asarray(res.poses[:, :K]))
    frames_all = np.concatenate(frames_all)
    fits_all = np.concatenate(fits_all)
    fitg_all = np.concatenate(fitg_all)
    frac_all = np.concatenate(frac_all)
    tfs_all = np.concatenate(tfs_all)
    desc_poses = np.concatenate(desc_poses)
    init_poses = np.concatenate(init_poses)
    frame_poses = np.asarray(db.frame_poses)

    def guard_mask(i):
        refined = frame_poses[frames_all[i]] @ tfs_all[i]  # (K, 4, 4)
        shift = np.linalg.norm(
            refined[:, :3, 3] - init_poses[i][:, :3, 3], axis=-1
        )
        dR = refined[:, :3, :3] @ np.swapaxes(init_poses[i][:, :3, :3], -1, -2)
        tr = np.clip((np.trace(dR, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
        rot = np.degrees(np.arccos(tr))
        return (shift <= cfg.gicp.max_refine_shift_m) & (
            rot <= cfg.gicp.max_refine_rot_deg
        ), refined

    def sr_of(variant):
        n_succ, errs = 0, []
        for i, g in enumerate(queries):
            best = desc_poses[i]
            if variant == "descriptor":
                pose = best
            else:
                guard, refined = guard_mask(i)
                if variant == "no-guard":
                    guard = np.ones(K, bool)
                score = frac_all[i] - 0.1 * fitg_all[i]
                if variant in ("prod", "no-guard"):
                    eff = np.where(guard, score, -np.inf)
                    pick = int(eff.argmax())
                elif variant == "raw-fitness":
                    good = guard & (fits_all[i] < cfg.gicp.best_fitness)
                    fe = np.where(guard, fits_all[i], np.inf)
                    pick = int(good.argmax()) if good.any() else int(fe.argmin())
                else:  # argmin-raw
                    fe = np.where(guard, fits_all[i], np.inf)
                    pick = int(fe.argmin())
                pose = refined[pick] if guard.any() else best
            t_err, r_err = rpe(np.asarray(g.pose), pose)
            errs.append(t_err)
            if t_err < cfg.success_trans_m and r_err < cfg.success_rot_deg:
                n_succ += 1
        return n_succ / num_q, float(np.sqrt(np.mean(np.square(errs))))

    for v in ("descriptor", "prod", "raw-fitness", "no-guard", "argmin-raw"):
        sr, rmse = sr_of(v)
        print(f"[abl] {v:12s} SR={sr:.4f} RMSE_T={rmse:.3f} m")


if __name__ == "__main__":
    main()
