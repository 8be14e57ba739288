"""Accuracy-discriminating evaluation on the aliased hard world.

The plain synthetic bench saturates SR at 1.000, so no accuracy regression
is detectable there. This harness runs the full
reference-style table (SR_5 / RMSE_P / RMSE_R / Recall@1/5/10 / ms per
query — the readme.txt:294-313 columns) on `data.synthetic.make_hard_world`:
repeated block motifs alias the descriptor space (SR lands in the
reference's 0.90-0.98 regime) and deterministic planar surfaces give GICP a
true optimum (refined RMSE < descriptor RMSE).

Runs descriptor-only and GICP-refined configurations through
eval.runner.evaluate (the reference-node analog), then checks pipeline
found/best-frame agreement against the NumPy reference oracle on a query
subsample. Prints the result table as JSON.

Run:  timeout 1150 python -u tools/hard_eval.py [num_map] [num_q]
"""

import dataclasses
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    from sgtd_tpu import SGTDConfig
    from sgtd_tpu.config import GicpConfig
    from sgtd_tpu.data.synthetic import (
        make_hard_world,
        observe,
        render_planar_cloud,
    )
    from sgtd_tpu.eval.runner import build_map_index, evaluate

    import os

    num_map = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    num_q = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    n_motifs = int(os.environ.get("HARD_MOTIFS", "4"))
    q_noise = float(os.environ.get("HARD_NOISE", "0.20"))
    q_drop = float(os.environ.get("HARD_DROPOUT", "0.25"))
    q_corrupt = float(os.environ.get("HARD_CORRUPT", "0.10"))
    unique_pb = int(os.environ.get("HARD_UNIQUE", "5"))
    skip_gicp = os.environ.get("HARD_SKIP_GICP", "") == "1"
    rng = np.random.default_rng(411)
    cfg = SGTDConfig()

    t0 = time.time()
    world = make_hard_world(
        rng, num_map_frames=num_map, num_queries=num_q,
        n_motifs=n_motifs, unique_per_block=unique_pb,
    )
    # Map side: clean-ish observations (the reference builds maps from
    # predicted labels too, but with local-map densification smoothing).
    maps = [observe(world, p, cfg, rng, center_noise_m=0.05) for p in world.map_poses]
    # Query side: the hard regime — heavy instance dropout, label
    # corruption (the reference's label_deter_rate), large centroid noise
    # so the descriptor pose has real error for GICP to remove.
    queries = [
        observe(
            world, p, cfg, rng,
            center_noise_m=q_noise, dropout=q_drop,
            label_corrupt_rate=q_corrupt,
        )
        for p in world.query_poses
    ]
    print(f"[hard] world+graphs: {time.time()-t0:.1f}s "
          f"({len(world.instance_xyz)} instances)", file=sys.stderr)

    index = build_map_index(maps, cfg)
    print(f"[hard] db: rows={index.report.num_rows} "
          f"build={index.build_seconds:.1f}s", file=sys.stderr)

    # --- descriptor-only table ---
    t0 = time.time()
    out_desc = evaluate(index, queries, batch_size=16)
    print(f"[hard] descriptor eval: {time.time()-t0:.1f}s", file=sys.stderr)

    if skip_gicp:
        agree = oracle_agreement(index, maps, queries[: min(8, num_q)], cfg)
        print(json.dumps({"descriptor_only": out_desc,
                          "oracle_subsample": agree}, indent=2))
        print(f"[hard] SR_desc={out_desc['success_rate']:.3f} "
              f"oracle SR={agree['oracle_sr']:.3f} vs "
              f"pipeline SR={agree['pipeline_sr']:.3f}", file=sys.stderr)
        return

    # --- GICP-refined table (planar clouds; reference cloud prep) ---
    # leaf_size is the reference's per-dataset-tuned SG_data knob
    # (SG_localization.yaml per-dataset comment blocks); at the headline 3.0
    # the voxel quantisation floors GICP around ~0.5 m — fine for the
    # reference's SR-rescue role, but the polished descriptor pose here is
    # already ~0.1 m, so demonstrating refinement value needs the finer
    # leaf (default 1.0, HARD_LEAF to override).
    # Measured on this workload (round-4 diagnostics): leaf 0.5 + a 1.0 m
    # correspondence gate put the GICP optimum at ~3 cm; leaf 3.0 floors it
    # around ~0.5-1.9 m (voxel quantisation + partial-overlap drag between
    # 50 m view discs ~18 m apart).
    leaf = float(os.environ.get("HARD_LEAF", "0.5"))
    gate = float(os.environ.get("HARD_CORR_GATE", "1.0"))
    gcfg = index.config.replace(
        gicp=GicpConfig(
            enable=True, engine="gicp", max_points=1024, leaf_size=leaf,
            max_corr_dist_m=gate,
        )
    )
    index.config = gcfg

    from sgtd_tpu.ops.voxel import load_query_cloud

    def q_fn(i):
        pts, m = render_planar_cloud(
            world, world.query_poses[i], np.random.default_rng(7000 + i),
            max_points=4096,
        )
        return load_query_cloud(pts[m], gcfg.gicp.leaf_size, 1024)

    def m_fn(fid):
        return render_planar_cloud(
            world, world.map_poses[fid], np.random.default_rng(8000 + fid),
            max_points=4096,
        )

    t0 = time.time()
    out_gicp = evaluate(
        index, queries, batch_size=16,
        query_cloud_fn=q_fn, map_cloud_fn=m_fn,
        rerank_k=int(os.environ.get("HARD_RERANK_K", "5")),
    )
    print(f"[hard] gicp eval: {time.time()-t0:.1f}s", file=sys.stderr)

    # --- oracle agreement on a subsample ---
    n_sub = min(8, num_q)
    agree = oracle_agreement(index, maps, queries[:n_sub], cfg)

    result = {
        "workload": {
            "num_map": num_map, "num_q": num_q,
            "query_center_noise_m": q_noise, "dropout": q_drop,
            "label_corrupt_rate": q_corrupt, "motifs": n_motifs,
            "unique_per_block": unique_pb, "gicp_leaf": leaf, "gicp_corr_gate_m": gate,
            "rerank_k": int(os.environ.get("HARD_RERANK_K", "5")),
        },
        "descriptor_only": out_desc,
        "gicp_refined": out_gicp,
        "oracle_subsample": agree,
    }
    print(json.dumps(result, indent=2))

    sr = out_desc["success_rate"]
    ok = 0.80 <= sr < 1.0
    improve = out_gicp["rmse_trans_m"] < out_desc["rmse_trans_m"]
    print(
        f"[hard] SR_desc={sr:.3f} (discriminating band: {ok}) "
        f"RMSE desc={out_desc['rmse_trans_m']:.3f} -> "
        f"gicp={out_gicp['rmse_trans_m']:.3f} (improves: {improve}) "
        f"oracle SR={agree['oracle_sr']:.3f} vs pipeline "
        f"SR={agree['pipeline_sr']:.3f} "
        f"(frame agree {agree['n_frame_agree']}/{agree['n']})",
        file=sys.stderr,
    )


def oracle_agreement(index, maps, queries, cfg):
    """Pipeline vs NumPy reference-oracle SearchLoop on a query subsample.

    The discriminating gate is pipeline SR >= oracle SR on the subsample:
    both sides localize, success = the usual 5 m/10 deg pose gate. Equality
    is not required — the pipeline's all-inlier pose polish and its strided
    pair/hypothesis sampling differ from the oracle's (both documented,
    both neutral-or-better), so on aliased near-ties either side can win a
    coin-flip frame; what the gate must catch is the pipeline LOSING
    accuracy to a capacity cap or ranking bug (exactly how the round-4
    frame-biased clipping bug was found: pipeline 0.75 vs oracle 1.0).
    Exact best-frame agreement is also reported (informative only).
    """
    import functools
    import jax

    from sgtd_tpu.eval.metrics import rpe
    from sgtd_tpu.eval.oracle import OracleManager
    from sgtd_tpu.eval.runner import stack_graphs
    from sgtd_tpu.match.pipeline import localize

    mgr = OracleManager(
        cfg.desc, cfg.search, dtype=np.float32, fixed_point_filter=True
    )
    for g in maps:
        pts = np.asarray(g.centers)[np.asarray(g.mask)]
        labs = np.asarray(g.labels)[np.asarray(g.mask)]
        mgr.add_stds(mgr.build(pts, labs))
    frame_poses = [np.asarray(g.pose) for g in maps]

    loc = jax.jit(
        jax.vmap(
            functools.partial(localize, config=index.config),
            in_axes=(None, 0),
        )
    )
    res = loc(index.db, stack_graphs(list(queries)))
    found = np.asarray(res.found)
    frames = np.asarray(res.best_frame)
    poses = np.asarray(res.poses[:, 0])

    n_frame_agree, o_succ, p_succ = 0, 0, 0
    detail = []
    for i, g in enumerate(queries):
        pts = np.asarray(g.centers)[np.asarray(g.mask)]
        labs = np.asarray(g.labels)[np.asarray(g.mask)]
        best_f, best_s, (rot_o, t_o), _ = mgr.search_loop(mgr.build(pts, labs))
        gt = np.asarray(g.pose)
        o_ok = False
        if best_f >= 0:
            T_loop = np.eye(4, dtype=np.float64)
            T_loop[:3, :3] = rot_o
            T_loop[:3, 3] = t_o
            o_pose = frame_poses[best_f] @ T_loop
            te, re_ = rpe(gt, o_pose)
            o_ok = te < cfg.success_trans_m and re_ < cfg.success_rot_deg
        p_ok = False
        if found[i]:
            te, re_ = rpe(gt, poses[i])
            p_ok = te < cfg.success_trans_m and re_ < cfg.success_rot_deg
        o_succ += int(o_ok)
        p_succ += int(p_ok)
        fa = (best_f >= 0) == bool(found[i]) and (
            best_f < 0 or best_f == int(frames[i])
        )
        n_frame_agree += int(fa)
        detail.append(
            {"q": i, "oracle_frame": int(best_f), "oracle_ok": bool(o_ok),
             "pipeline_frame": int(frames[i]) if found[i] else -1,
             "pipeline_ok": bool(p_ok), "frame_agree": bool(fa)}
        )
    n = len(list(queries))
    return {
        "n": n,
        "oracle_sr": o_succ / n,
        "pipeline_sr": p_succ / n,
        "n_frame_agree": n_frame_agree,
        "detail": detail,
    }


if __name__ == "__main__":
    main()
