"""Command-line tools — the analog of the reference's ROS nodes.

  build-map   : raw .bin+.label scans -> per-scan semantic graph JSONs
                (the ``create_semantic_graph`` node, src/sgtd/src/get_json.cpp).
  localize    : map graph dir + query graph dir -> SR/RMSE/Recall metrics
                (the ``semantic_graph_localization`` node).
  eval-synth  : self-contained synthetic-world evaluation (no dataset needed).

Run as ``python -m sgtd_tpu.cli <command> ...``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _cmd_build_map(args):
    import jax.numpy as jnp

    from sgtd_tpu.config import DcvcConfig, SGTDConfig
    from sgtd_tpu.graph.build import build_graph
    from sgtd_tpu.io import readers
    from sgtd_tpu.io.graph_json import write_graph_json

    cfg = SGTDConfig()
    dcvc = DcvcConfig()
    scans = readers.list_scans(args.scans, ".bin")
    labels = readers.list_scans(args.labels, ".label")
    assert len(scans) == len(labels), (len(scans), len(labels))

    poses = None
    if args.poses:
        if args.dataset == "mulran":
            stamps, pose_mats = readers.read_mulran_poses(args.poses)
            pose_mats = readers.apply_mulran_utm_offset(pose_mats, args.sequence or "")
            scan_stamps = np.asarray(
                [int(os.path.splitext(os.path.basename(s))[0]) for s in scans],
                dtype=np.int64,
            )
            idx = readers.associate_by_timestamp(scan_stamps, stamps)
            poses = pose_mats[idx]
        else:
            poses = readers.read_kitti_poses(args.poses, args.calib)

    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(0)
    n_max = dcvc.max_points

    if args.local_map_radius > 0:
        # Multi-frame densified keyframes (ref local_map.cpp; the map
        # variant behind the headline "multi" results).
        from sgtd_tpu.graph.local_map import build_local_map_graphs
        from sgtd_tpu.io.graph_json import write_graph_json as _wg
        from sgtd_tpu import native

        if poses is None:
            raise SystemExit("--local-map-radius requires --poses")

        def load_scan(j):
            xyz, sem_j, inst_j = native.load_scan(scans[j], labels[j])
            if args.dataset == "kitti":
                sem_j = readers.to_reference_train_ids(
                    readers.remap_semantic_kitti(sem_j)
                )
            return xyz, sem_j, inst_j

        graphs = build_local_map_graphs(
            load_scan, poses.astype(np.float32), args.local_map_radius,
            cfg.caps, dcvc,
        )
        for i, g in enumerate(graphs):
            base = os.path.splitext(os.path.basename(scans[i]))[0]
            _wg(os.path.join(args.out, base + ".json"), g)
        print(f"[build-map] wrote {len(graphs)} local-map graphs to {args.out}")
        return

    # Wild-Places profile (ref get_json_wild.cpp — the variant the reference
    # declares but never builds, CMakeLists.txt:180-182): 3-float .bin
    # stride, 13-class identity routing.
    from sgtd_tpu.graph.build import MULRAN_ROUTING, WILD_ROUTING

    routing = WILD_ROUTING if args.dataset == "wild" else MULRAN_ROUTING

    for i, (sp, lp) in enumerate(zip(scans, labels)):
        if args.dataset == "wild":
            pts = readers.read_bin_wild(sp)
        else:
            pts = readers.read_bin(sp)[:, :3]
        sem, inst = readers.read_label(lp)
        if args.dataset == "kitti":
            sem = readers.to_reference_train_ids(readers.remap_semantic_kitti(sem))
        if args.label_corrupt_rate > 0:
            sem = readers.corrupt_labels(sem, args.label_corrupt_rate, rng)
        n = min(len(pts), n_max)
        mask = np.zeros(n_max, bool)
        mask[:n] = True
        p = np.zeros((n_max, 3), np.float32)
        p[:n] = pts[:n]
        s = np.zeros(n_max, np.int32)
        s[:n] = sem[:n]
        ii = np.zeros(n_max, np.int32)
        ii[:n] = inst[:n]
        pose = poses[i] if poses is not None else np.eye(4, dtype=np.float32)
        g = build_graph(
            jnp.asarray(p), jnp.asarray(s), jnp.asarray(ii), jnp.asarray(mask),
            pose.astype(np.float32), cfg.caps, dcvc, routing,
        )
        base = os.path.splitext(os.path.basename(sp))[0]
        write_graph_json(os.path.join(args.out, base + ".json"), g)
        if i % 50 == 0:
            print(f"[build-map] {i}/{len(scans)}", file=sys.stderr)
    print(f"[build-map] wrote {len(scans)} graphs to {args.out}")


def _cmd_localize(args):
    import dataclasses

    from sgtd_tpu.config import SGTDConfig
    from sgtd_tpu.eval.runner import build_map_index, evaluate
    from sgtd_tpu.io.graph_json import read_graph_dir

    cfg = SGTDConfig()
    if args.enable_gicp:
        cfg = cfg.replace(
            gicp=dataclasses.replace(
                cfg.gicp,
                enable=True,
                engine=args.engine,
                leaf_size=args.leaf_size,
                max_points=args.gicp_max_points,
            )
        )
    map_graphs = read_graph_dir(args.map_graphs, cfg)
    query_graphs = read_graph_dir(args.query_graphs, cfg)
    print(
        f"[localize] map={len(map_graphs)} queries={len(query_graphs)}",
        file=sys.stderr,
    )

    # GICP rerank cloud loaders (ref semantic_graph_localization.cpp:651-723:
    # the query .bin is origin-filtered + voxel-downsampled at leaf_size, the
    # candidate keyframe .bins are used as-is). Scan files pair with graphs
    # by sorted basename, exactly like the reference's path construction.
    query_cloud_fn = map_cloud_fn = None
    if args.enable_gicp:
        from sgtd_tpu.io import readers
        from sgtd_tpu.ops.voxel import load_query_cloud

        if not (args.query_scans and args.map_scans):
            raise SystemExit("--enable-gicp requires --query-scans/--map-scans")
        q_bins = readers.list_scans(args.query_scans, ".bin")
        m_bins = readers.list_scans(args.map_scans, ".bin")
        if len(q_bins) != len(query_graphs) or len(m_bins) != len(map_graphs):
            raise SystemExit(
                f"scan/graph count mismatch: {len(q_bins)} query bins vs "
                f"{len(query_graphs)} graphs, {len(m_bins)} map bins vs "
                f"{len(map_graphs)} graphs"
            )

        # Query scans stream through the native prefetching loader (C++
        # background threads, sgtd_tpu/native/loader.cpp) so disk reads
        # overlap device compute; map scans are loaded once each and cached
        # by the runner (pose-independent map data).
        from sgtd_tpu.native import PrefetchingLoader

        q_loader = PrefetchingLoader(q_bins)

        def query_cloud_fn(i):
            pts = q_loader.get(i)[0]
            return load_query_cloud(pts, cfg.gicp.leaf_size, cfg.gicp.max_points)

        def map_cloud_fn(fid):
            # Map clouds are not downsampled (ref :703-711, commented out).
            pts = readers.read_bin(m_bins[fid])[:, :3]
            return load_query_cloud(pts, 0.0, cfg.gicp.max_points)

    index = build_map_index(map_graphs, cfg)

    # Persistent map artifacts (keyframe clouds + GICP covariances + vgicp
    # voxel maps): built once, saved beside the DB, loaded as a device_put
    # on later runs — the query path then does zero per-query target
    # covariance/voxel work (the reference redoes both per setInputTarget,
    # fast_gicp_impl.hpp:60-72).
    artifacts = None
    if args.enable_gicp and args.map_artifacts:
        from sgtd_tpu.db.artifacts import (
            build_map_artifacts,
            load_map_artifacts,
            save_map_artifacts,
        )

        if os.path.exists(args.map_artifacts):
            # Consistency-validated load: frame count + GICP fingerprint
            # must match the freshly built DB (a stale file would be
            # silently mis-gathered under jit, ADVICE r4 medium).
            artifacts = load_map_artifacts(
                args.map_artifacts,
                expect_frames=index.db.frame_poses.shape[0],
                expect_gicp=cfg.gicp,
            )
            print(f"[localize] loaded map artifacts: {args.map_artifacts}",
                  file=sys.stderr)
        else:
            artifacts = build_map_artifacts(
                map_cloud_fn, len(map_graphs), cfg.gicp,
                f_pad=index.db.frame_poses.shape[0],
            )
            save_map_artifacts(args.map_artifacts, artifacts, cfg.gicp)
            print(f"[localize] built+saved map artifacts: "
                  f"{args.map_artifacts}", file=sys.stderr)

    out = evaluate(
        index,
        query_graphs,
        batch_size=args.batch_size,
        query_cloud_fn=query_cloud_fn,
        map_cloud_fn=map_cloud_fn,
        rerank_k=args.rerank_k,
        map_artifacts=artifacts,
    )
    if args.viz_dir:
        out["viz"] = _write_candidate_viz(
            args.viz_dir, index, query_graphs, args.viz_queries
        )
    print(json.dumps(out, indent=2))


def _cmd_eval_synth(args):
    from sgtd_tpu.config import SGTDConfig
    from sgtd_tpu.data.synthetic import make_map_and_queries
    from sgtd_tpu.eval.runner import build_map_index, evaluate

    cfg = SGTDConfig()
    maps, queries, _ = make_map_and_queries(
        cfg,
        seed=args.seed,
        num_map_frames=args.map_frames,
        num_queries=args.queries,
        center_noise_m=0.05,
        dropout=0.1,
        label_corrupt_rate=args.label_corrupt_rate,
    )
    index = build_map_index(maps, cfg)
    out = evaluate(index, queries, batch_size=min(16, args.queries))
    if args.viz_dir:
        out["viz"] = _write_candidate_viz(
            args.viz_dir, index, queries, args.viz_queries
        )
    if args.plot:
        from sgtd_tpu.eval.plotting import plot_localization

        # Re-run localization for the plot (cheap at this scale).
        import functools
        import jax
        from sgtd_tpu.eval.runner import stack_graphs
        from sgtd_tpu.match.pipeline import localize

        loc = jax.jit(jax.vmap(functools.partial(localize, config=index.config), in_axes=(None, 0)))
        res = loc(index.db, stack_graphs(queries))
        gt = np.stack([np.asarray(g.pose) for g in queries])
        est = np.asarray(res.poses[:, 0])
        succ = np.asarray(res.found)
        path = plot_localization(args.plot, np.stack([np.asarray(g.pose) for g in maps]), gt, est, succ)
        out["plot"] = path
    print(json.dumps(out, indent=2))


def _write_candidate_viz(viz_dir, index, query_graphs, n):
    """Per-query candidate/match PNGs (ref rviz marker topics,
    semantic_graph_localization.cpp:784-953) — one artifact per eval run."""
    from sgtd_tpu.eval.plotting import plot_query_candidates

    os.makedirs(viz_dir, exist_ok=True)
    paths = []
    for i, g in enumerate(query_graphs[: max(n, 0)]):
        p = plot_query_candidates(
            os.path.join(viz_dir, f"query_{i:04d}.png"),
            index.db, g, index.config, title=f"query {i}",
        )
        if p:
            paths.append(p)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sgtd_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build-map", help="raw scans -> semantic graph JSONs")
    b.add_argument("--scans", required=True)
    b.add_argument("--labels", required=True)
    b.add_argument("--poses", default=None)
    b.add_argument("--calib", default=None)
    b.add_argument("--dataset", choices=["kitti", "mulran", "raw", "wild"],
                   default="kitti")
    b.add_argument("--sequence", default=None)
    b.add_argument("--label-corrupt-rate", type=float, default=0.0)
    b.add_argument("--local-map-radius", type=float, default=0.0,
                   help="merge scans within this radius into each keyframe "
                        "(multi-frame densified maps; 0 = single-scan)")
    b.add_argument("--out", required=True)
    b.set_defaults(fn=_cmd_build_map)

    l = sub.add_parser("localize", help="map+query graph dirs -> metrics")
    l.add_argument("--map-graphs", required=True)
    l.add_argument("--query-graphs", required=True)
    l.add_argument("--batch-size", type=int, default=16)
    l.add_argument("--enable-gicp", action="store_true",
                   help="multi-candidate registration rerank from raw scans "
                        "(the reference's enable_gicp headline path)")
    l.add_argument("--engine", choices=["gicp", "vgicp"], default="gicp")
    l.add_argument("--query-scans", default=None,
                   help=".bin dir pairing with --query-graphs by sort order")
    l.add_argument("--map-scans", default=None,
                   help=".bin dir pairing with --map-graphs by sort order")
    l.add_argument("--leaf-size", type=float, default=3.0,
                   help="query-cloud voxel downsample leaf (ref SG_data)")
    l.add_argument("--gicp-max-points", type=int, default=8192)
    l.add_argument("--rerank-k", type=int, default=4)
    l.add_argument("--map-artifacts", default=None,
                   help="path to the persistent keyframe-cloud/covariance/"
                        "voxel-map .npz (built+saved on first run, loaded "
                        "afterwards)")
    l.add_argument("--viz-dir", default=None,
                   help="write per-query candidate/match PNGs here (the "
                        "off-ROS analog of the reference's marker topics)")
    l.add_argument("--viz-queries", type=int, default=4,
                   help="how many queries to visualize")
    l.set_defaults(fn=_cmd_localize)

    e = sub.add_parser("eval-synth", help="synthetic-world evaluation")
    e.add_argument("--map-frames", type=int, default=100)
    e.add_argument("--queries", type=int, default=32)
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--label-corrupt-rate", type=float, default=0.05)
    e.add_argument("--plot", default=None, help="write a trajectory PNG here")
    e.add_argument("--viz-dir", default=None,
                   help="write per-query candidate/match PNGs here")
    e.add_argument("--viz-queries", type=int, default=4)
    e.set_defaults(fn=_cmd_eval_synth)

    args = ap.parse_args(argv)
    from sgtd_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
