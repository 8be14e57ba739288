#!/usr/bin/env python3
"""Smoke run of the localization path on one GPU, at real sizes.

    python chip_smoke.py                 # one card: kernels, bench, scale
    python chip_smoke.py --devices 4     # four cards: sharded + ring sweep
    python chip_smoke.py --cpu-rehearsal # tiny sizes on the CPU, no result

Phases (one card):
  kernels  each plain-XLA operation that replaced a hand-written kernel,
           at real widths, against an independent NumPy float64 reference;
  bench    the bench world (200 keyframes, ~400k rows, 64 queries, seed
           2026): localize_refined in 16-query chunks, the eval-synth path
           (eval.runner.build_map_index + evaluate), votes against the NumPy
           oracle (eval/oracle.py), descriptor poses against the same
           program on the host CPU;
  scale    5,000 keyframes (~9.8M rows): 16 queries, votes against a NumPy
           re-tally of the probe.
With ``--devices 4`` only the multi-card paths run: the db-axis sharded
localizer and the ring sweep, votes against single-card ``localize``.

Every phase prints compile and steady seconds and memory figures; these
are not claims. Any failed check makes the exit code nonzero. The last
stdout line is the JSON result, printed only when every phase passed on a
GPU. Without a GPU the script exits nonzero before any phase.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
import traceback

import numpy as np

FULL = dict(
    vote_sizes=((106_496, 200), (1_835_008, 5000)),
    hyp=(50, 50, 512),
    nn_shapes=((1024, 4096), (1024, 1024)),
    bench_frames=200, bench_queries=64,
    scale_frames=5000, scale_queries=16,
    multi_queries=16,
)
REHEARSAL = dict(
    vote_sizes=((10_000, 200), (50_000, 5000)),
    hyp=(6, 50, 96),
    nn_shapes=((128, 512), (128, 128)),
    bench_frames=24, bench_queries=16,
    scale_frames=300, scale_queries=8,
    multi_queries=8,
)
CHUNK = 16  # queries per localize_refined dispatch
SCALE_CHUNK = 8  # bounds the (batch, L) probe workspace at scale
SR_GATE = 0.95
POSE_TOL_M = 1e-3
POSE_TOL_DEG = 0.01


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)
    log(f"  ok: {msg}")


def compile_and_time(label, fn, *args, reps: int = 2):
    """AOT-compile ``jax.jit(fn)`` for ``args``, run it ``reps`` times and
    print compile seconds, steady seconds and the compiled memory use."""
    import jax

    t0 = time.time()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.time() - t0
    out = jax.block_until_ready(compiled(*args))
    t0 = time.time()
    for _ in range(reps):
        out = compiled(*args)
    jax.block_until_ready(out)
    t_steady = (time.time() - t0) / reps
    m = compiled.memory_analysis()
    log(
        f"{label}: compile {t_compile:.2f}s steady {t_steady * 1e3:.3f} ms "
        f"| temp {m.temp_size_in_bytes} B args {m.argument_size_in_bytes} B "
        f"out {m.output_size_in_bytes} B"
    )
    return out, m


def peak_bytes(dev) -> str:
    stats = dev.memory_stats() or {}
    return str(stats.get("peak_bytes_in_use", "not reported"))


# ------------------------------------------------------------- references


def sq_dists64(q, r):
    q = np.asarray(q, np.float64)
    r = np.asarray(r, np.float64)
    return np.sum((q[:, None, :] - r[None, :, :]) ** 2, axis=-1)


def check_neighbours(label, idx, d64, k, dists=None):
    """Index equality except for ties within 1e-5 relative; returned
    squared distances within 1e-4 relative of float64."""
    idx = np.asarray(idx).reshape(d64.shape[0], k)
    ref = np.sort(d64, axis=1)[:, :k]
    got = np.take_along_axis(d64, idx, axis=1)
    scale = np.maximum(ref, 1e-12)
    tie_ok = np.abs(got - ref) <= 1e-5 * scale
    exact = np.argsort(d64, axis=1, kind="stable")[:, :k] == idx
    check(bool(np.all(exact | tie_ok)),
          f"{label}: indices equal up to ties within 1e-5 relative "
          f"({int((~exact).sum())} tied swaps)")
    if dists is not None:
        dists = np.asarray(dists).reshape(d64.shape[0], k)
        rel = np.abs(dists - ref) / scale
        check(float(rel.max()) <= 1e-4,
              f"{label}: squared distances within 1e-4 relative "
              f"(max {float(rel.max()):.2e})")


def numpy_probe_votes(db_host, sides, labels, mask, cfg):
    """Independent NumPy re-tally of one query's probe votes: the 27-cell
    probe with the 1.5-cell gate (STDesc.cpp:358-369), exact (cell, code)
    buckets of the key-sorted table, the 1/256 fixed-point rough filter
    (STDesc.cpp:356,378), np.bincount per frame."""
    from sgtd_tpu.desc.keys import _N_CODES, _OFFSETS, key_extent

    keys, packed2, frame_ids, f_pad = db_host
    ext = key_extent(cfg.desc)
    s = np.asarray(sides, np.float32)[mask]
    lab = np.clip(np.asarray(labels)[mask].astype(np.int64), 0, 12)
    vox = np.trunc(s[:, None, :] + _OFFSETS.astype(np.float32)).astype(np.int64)
    diff = s[:, None, :] - (vox.astype(np.float32) + np.float32(0.5))
    gate = np.sqrt(np.sum(diff * diff, axis=-1)) < np.float32(1.5)
    v = np.clip(vox, 0, ext - 1)
    code = (lab[:, 0] * 13 + lab[:, 1]) * 13 + lab[:, 2]
    key = ((v[..., 0] * ext + v[..., 1]) * ext + v[..., 2]) * _N_CODES
    key = key + code[:, None]
    lo = np.searchsorted(keys, key, "left")
    hi = np.searchsorted(keys, key, "right")
    n = np.where(gate, hi - lo, 0).ravel()
    desc = np.repeat(np.repeat(np.arange(len(s)), 27), n)
    starts = np.repeat(lo.ravel(), n)
    within = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    rows = starts + within
    qq = np.clip(np.round(s * np.float32(256.0)), 0, 32767).astype(np.int64)
    w = packed2[rows].astype(np.int64)
    rs = np.stack([w[:, 0] & 0xFFFF, w[:, 0] >> 16, w[:, 1] & 0xFFFF], -1)
    d = rs - qq[desc]
    dis2 = np.sum(d * d, axis=-1).astype(np.float32)
    qs2 = np.sum(qq[desc] ** 2, axis=-1).astype(np.float32)
    thr2 = qs2 * np.float32(cfg.search.rough_dis_threshold) ** 2
    hit = dis2 < thr2
    return np.bincount(frame_ids[rows[hit]], minlength=f_pad)


def oracle_votes(map_descs, query_desc, cfg):
    """Per-frame votes from the reference transliteration (eval/oracle.py),
    fed the same descriptors, with the pipeline's float32 arithmetic and
    fixed-point rough filter mirrored (its documented switches)."""
    from sgtd_tpu.eval.oracle import OracleManager, OracleSTD

    sides, labels, verts, mask = map_descs
    mgr = OracleManager(cfg.desc, cfg.search, dtype=np.float32,
                        fixed_point_filter=True)

    def stds(s, l, v, m, frame):
        return [
            OracleSTD(side_length=s[d], angle=None, A=v[d, 0], B=v[d, 1],
                      C=v[d, 2], center=None,
                      vertex_attached=tuple(int(x) for x in l[d]),
                      frame_id=frame, node_id=None)
            for d in np.nonzero(m)[0]
        ]

    for f in range(sides.shape[0]):
        mgr.add_stds(stds(sides[f], labels[f], verts[f], mask[f], f))
    votes, _ = mgr.candidate_selector(
        stds(*query_desc, frame=sides.shape[0])
    )
    return votes


def rpe_check(label, res_poses, found, queries, cfg):
    from sgtd_tpu.eval.metrics import rpe

    n_succ = 0
    for i, g in enumerate(queries):
        if not found[i]:
            continue
        t_err, r_err = rpe(np.asarray(g.pose), res_poses[i])
        n_succ += (t_err < cfg.success_trans_m) & (r_err < cfg.success_rot_deg)
    sr = n_succ / len(queries)
    check(sr >= SR_GATE, f"{label}: SR {sr:.4f} >= {SR_GATE}")
    return sr


def trunc_check(label, truncated):
    from sgtd_tpu.match.search import TRUNC_SCAN

    n = int(np.sum((np.asarray(truncated) & TRUNC_SCAN) != 0))
    check(n == 0, f"{label}: zero TRUNC_SCAN queries ({n} of {len(truncated)})")


# ------------------------------------------------------------------ worlds


def build_world(maps, queries, cfg):
    """DB + tuned config (eval.benchworld.build_index), with its log line."""
    from sgtd_tpu.eval.benchworld import build_index

    t0 = time.time()
    cfg, db, qall, descs, report = build_index(maps, queries, cfg)
    log(f"  DB: {report.num_rows} rows, {report.num_frames} keyframes, "
        f"scan_slots {cfg.caps.max_scan_slots}, build {time.time() - t0:.1f}s")
    return db, cfg, qall, descs, report


def chunks_of(tree, size):
    import jax

    n = jax.tree_util.tree_leaves(tree)[0].shape[0]
    return [jax.tree_util.tree_map(lambda x: x[i: i + size], tree)
            for i in range(0, n, size)]


def concat(outs):
    import jax

    return jax.tree_util.tree_map(
        lambda *xs: np.concatenate([np.asarray(x) for x in xs]), *outs
    )


# ------------------------------------------------------------------ phases


def phase_kernels(S, dev):
    import jax
    import jax.numpy as jnp

    from sgtd_tpu.match.search import frame_votes
    from sgtd_tpu.match.verify import hypothesis_votes
    from sgtd_tpu.ops import nn

    rng = np.random.default_rng(1)
    log("vote tally: int32 scatter-add vs np.bincount, bit-exact")
    for l, f_pad in S["vote_sizes"]:
        hit = rng.uniform(size=l) < 0.3
        frame = rng.integers(0, f_pad + 1, size=l, dtype=np.int32)
        got, _ = compile_and_time(
            f"frame_votes L={l} f_pad={f_pad}",
            functools.partial(frame_votes, f_pad=f_pad),
            jnp.asarray(hit), jnp.asarray(frame),
        )
        keep = hit & (frame < f_pad)
        want = np.bincount(frame[keep], minlength=f_pad)
        check(np.array_equal(np.asarray(got), want.astype(np.float32)),
              f"frame_votes L={l} f_pad={f_pad} bit-exact")

    c, h, p = S["hyp"]
    log("hypothesis_votes: float32 on device vs NumPy float64, exact except "
        "pairs within 1e-4 m of the threshold")
    thr = 3.0
    q = rng.normal(size=(c * h, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(c, h, 3, 3).astype(np.float32)
    t = rng.normal(0, 5, (c, h, 3)).astype(np.float32)
    vq = (rng.normal(0, 20, (c, p, 3, 3)) + 150.0).astype(np.float32)
    vdb = np.empty_like(vq)
    for ci in range(c):  # every pair consistent with some hypothesis
        hi = rng.integers(0, h, p)
        moved = np.einsum("pij,pkj->pki", rot[ci, hi], vq[ci]) + t[ci, hi][:, None]
        vdb[ci] = moved + rng.normal(0, 1.2, moved.shape)
    valid = rng.uniform(size=(c, p)) > 0.1
    got, mem = compile_and_time(
        f"hypothesis_votes C={c} H={h} P={p}",
        functools.partial(hypothesis_votes, thr=thr),
        *(jnp.asarray(a) for a in (rot, t, vq, vdb, valid)),
    )
    r64 = np.einsum("chij,cpkj->chpki", rot.astype(np.float64),
                    vq.astype(np.float64)) + t[:, :, None, None, :]
    dist = np.linalg.norm(r64 - vdb[:, None].astype(np.float64), axis=-1)
    ref = (np.all(dist < thr, -1) & valid[:, None]).sum(-1)
    near = (np.any(np.abs(dist - thr) < 1e-4, -1) & valid[:, None]).sum(-1)
    got = np.asarray(got)
    check(bool(np.all(np.abs(got - ref) <= near)),
          f"hypothesis_votes equal to float64 (near-threshold pairs: "
          f"{int(near.sum())}, mean votes {ref.mean():.1f})")
    msg = (f"hypothesis_votes holds no (C, H, P) buffer "
           f"(temp {mem.temp_size_in_bytes} B < {c * h * p * 4} B)")
    if dev.platform == "gpu":
        check(mem.temp_size_in_bytes < c * h * p * 4, msg)
    else:  # XLA:CPU fuses differently; the claim is about the GPU program
        log(f"  not checked on {dev.platform}: {msg}")

    log("nn1 / knn(k=20): float32 difference form on device vs float64")
    for n_q, n_r in S["nn_shapes"]:
        base = np.array([180.0, -240.0, 12.0])
        qp = (base + rng.uniform(-50, 50, (n_q, 3))).astype(np.float32)
        rp = (base + rng.uniform(-50, 50, (n_r, 3))).astype(np.float32)
        d64 = sq_dists64(qp, rp)
        (i1, dd), _ = compile_and_time(
            f"nn1 {n_q}x{n_r}", nn.nn1, jnp.asarray(qp), jnp.asarray(rp)
        )
        check_neighbours(f"nn1 {n_q}x{n_r}", i1, d64, 1, dd)
        ik, _ = compile_and_time(
            f"knn {n_q}x{n_r}",
            functools.partial(nn.knn, k=20), jnp.asarray(qp), jnp.asarray(rp),
        )
        check_neighbours(f"knn {n_q}x{n_r}", ik, d64, 20)
    log(f"kernels peak_bytes_in_use {peak_bytes(dev)} ({dev.device_kind})")


def phase_bench(S, dev):
    import jax

    from sgtd_tpu import SGTDConfig
    from sgtd_tpu.data.synthetic import make_map_and_queries
    from sgtd_tpu.desc.triangles import build_descriptors
    from sgtd_tpu.eval.benchworld import bench_clouds
    from sgtd_tpu.eval.runner import build_map_index, evaluate
    from sgtd_tpu.match.pipeline import localize, localize_refined
    from sgtd_tpu.match.search import probe_and_hits

    cfg0 = SGTDConfig()
    t0 = time.time()
    maps, queries, world = make_map_and_queries(
        cfg0, seed=2026, num_map_frames=S["bench_frames"],
        num_queries=S["bench_queries"], center_noise_m=0.05, dropout=0.1,
        label_corrupt_rate=0.05,
    )
    log(f"  world: {time.time() - t0:.1f}s")
    db, cfg, qall, descs, report = build_world(maps, queries, cfg0)
    clouds = bench_clouds(world, cfg)
    map_clouds, map_masks, map_covs, q_clouds, q_masks = clouds

    log(f"localize_refined (rerank_k=4) in {CHUNK}-query chunks")
    loc_fn = jax.vmap(
        functools.partial(localize_refined, config=cfg, rerank_k=4),
        in_axes=(None, 0, 0, 0, None, None, None),
    )
    g_chunks = chunks_of(qall, CHUNK)
    c_chunks = chunks_of(q_clouds, CHUNK)
    m_chunks = chunks_of(q_masks, CHUNK)
    args0 = (db, g_chunks[0], c_chunks[0], m_chunks[0],
             map_clouds, map_masks, map_covs)
    _, _ = compile_and_time(f"localize_refined chunk of {CHUNK}", loc_fn, *args0,
                            reps=1)
    fused = jax.jit(loc_fn)
    t0 = time.time()
    outs = [fused(db, g, c, m, map_clouds, map_masks, map_covs)
            for g, c, m in zip(g_chunks, c_chunks, m_chunks)]
    jax.block_until_ready(outs)
    dt = time.time() - t0
    log(f"  {len(queries)} queries steady {dt:.3f}s "
        f"({dt / len(queries) * 1e3:.2f} ms/query pipelined)")
    res = concat(outs)
    trunc_check("localize_refined", res.result.truncated)
    rpe_check("localize_refined", res.pose, res.result.found, queries, cfg)

    log("eval-synth path: build_map_index + evaluate")
    index = build_map_index(maps, cfg0)
    summary = evaluate(index, queries, batch_size=CHUNK)
    log(f"  evaluate: SR {summary['success_rate']:.4f} "
        f"R@1 {summary['recall_at_1']:.4f} compile "
        f"{summary['compile_seconds']:.1f}s steady "
        f"{summary['mean_time_ms']:.3f} ms/query")
    check(summary["success_rate"] >= SR_GATE,
          f"evaluate SR {summary['success_rate']:.4f} >= {SR_GATE}")

    log("votes vs the NumPy oracle (eval/oracle.py), bit-exact")
    host_descs = tuple(np.asarray(a) for a in
                       (descs.sides, descs.labels, descs.vertices, descs.mask))
    one_desc = jax.jit(functools.partial(build_descriptors, cfg=cfg.desc,
                                         caps=cfg.caps))
    full_votes = jax.jit(lambda d, q: probe_and_hits(
        d, q, cfg.desc, cfg.search, cfg.caps, with_sel=False).votes)
    f_real = len(maps)
    for i in range(2):
        g = jax.tree_util.tree_map(lambda x: x[i], qall)
        qd = one_desc(g)
        got = np.asarray(full_votes(db, qd))
        t0 = time.time()
        want = oracle_votes(
            host_descs,
            tuple(np.asarray(a) for a in
                  (qd.sides, qd.labels, qd.vertices, qd.mask)),
            cfg,
        )
        want_arr = np.array([want.get(f, 0) for f in range(f_real)])
        check(np.array_equal(got[:f_real], want_arr) and not got[f_real:].any(),
              f"query {i}: {int(want_arr.sum())} votes over {f_real} frames "
              f"equal to the oracle (oracle {time.time() - t0:.1f}s)")
        cand = res.result
        for f, v in zip(cand.frames[i], cand.votes[i]):
            if v > 0 and want.get(int(f), 0) != int(v):
                raise CheckFailed(f"query {i}: candidate frame {f} vote {v} "
                                  f"!= oracle {want.get(int(f), 0)}")

    log(f"descriptor poses vs the same program on the host CPU "
        f"(tolerance {POSE_TOL_M * 1e3:g} mm / {POSE_TOL_DEG}°)")
    cpu = jax.devices("cpu")[0]
    loc1 = jax.jit(jax.vmap(functools.partial(localize, config=cfg),
                            in_axes=(None, 0)))
    g8 = jax.tree_util.tree_map(lambda x: x[:8], qall)
    r_dev = jax.tree_util.tree_map(np.asarray, loc1(db, g8))
    t0 = time.time()
    r_cpu = jax.tree_util.tree_map(
        np.asarray, loc1(jax.device_put(db, cpu), jax.device_put(g8, cpu))
    )
    log(f"  CPU run (compile included): {time.time() - t0:.1f}s")
    check(np.array_equal(r_dev.best_frame, r_cpu.best_frame),
          "same best frame on device and CPU for 8 queries")
    p_dev, p_cpu = r_dev.poses[:, 0], r_cpu.poses[:, 0]
    dt_m = np.linalg.norm(p_dev[:, :3, 3] - p_cpu[:, :3, 3], axis=-1)
    # Angle between the rotations from ||R1 - R2||_F = 2 sqrt(2) sin(a/2):
    # well-conditioned near zero, unlike arccos of the trace.
    fro = np.linalg.norm((p_dev[:, :3, :3] - p_cpu[:, :3, :3]).astype(
        np.float64), axis=(1, 2))
    ang = np.degrees(2 * np.arcsin(np.minimum(fro / (2 * np.sqrt(2)), 1.0)))
    check(float(dt_m.max()) <= POSE_TOL_M and float(ang.max()) <= POSE_TOL_DEG,
          f"pose agreement: max {dt_m.max() * 1e3:.4f} mm, "
          f"{ang.max():.5f}°")
    log(f"bench peak_bytes_in_use {peak_bytes(dev)} ({dev.device_kind})")


def phase_scale(S, dev):
    import dataclasses

    import jax

    from sgtd_tpu import SGTDConfig
    from sgtd_tpu.desc.triangles import build_descriptors
    from sgtd_tpu.eval.benchworld import make_scale_graphs
    from sgtd_tpu.match.pipeline import localize
    from sgtd_tpu.match.search import probe_and_hits

    cfg0 = SGTDConfig()
    # Deep buckets at scale need a larger ragged-scan budget than the
    # default; calibration only lowers it, so raise it before building.
    cfg0 = cfg0.replace(caps=dataclasses.replace(cfg0.caps,
                                                 max_scan_slots=1 << 23))
    t0 = time.time()
    maps, queries, _ = make_scale_graphs(S["scale_frames"],
                                         S["scale_queries"], cfg0)
    log(f"  world: {time.time() - t0:.1f}s")
    db, cfg, qall, _, report = build_world(maps, queries, cfg0)
    use_sel = cfg.caps.max_scan_slots <= cfg.caps.sel_max_scan_slots
    log(f"  pair extraction: {'sel' if use_sel else 'candidate-major'}")

    loc_fn = jax.vmap(functools.partial(localize, config=cfg), in_axes=(None, 0))
    g_chunks = chunks_of(qall, SCALE_CHUNK)
    compile_and_time(f"localize chunk of {SCALE_CHUNK} at "
                     f"{report.num_rows} rows", loc_fn, db, g_chunks[0], reps=1)
    fused = jax.jit(loc_fn)
    t0 = time.time()
    outs = [fused(db, g) for g in g_chunks]
    jax.block_until_ready(outs)
    dt = time.time() - t0
    log(f"  {len(queries)} queries steady {dt:.3f}s "
        f"({dt / len(queries) * 1e3:.2f} ms/query pipelined)")
    res = concat(outs)
    trunc_check("scale localize", res.truncated)
    rpe_check("scale localize", res.poses[:, 0], res.found, queries, cfg)

    log("votes vs a NumPy re-tally of the probe, bit-exact")
    db_host = (np.asarray(db.keys), np.asarray(db.packed2),
               np.asarray(db.frame_ids), db.frame_poses.shape[0])
    one_desc = jax.jit(functools.partial(build_descriptors, cfg=cfg.desc,
                                         caps=cfg.caps))
    full_votes = jax.jit(lambda d, q: probe_and_hits(
        d, q, cfg.desc, cfg.search, cfg.caps, with_sel=False).votes)
    for i in range(2):
        g = jax.tree_util.tree_map(lambda x: x[i], qall)
        qd = one_desc(g)
        got = np.asarray(full_votes(db, qd))
        want = numpy_probe_votes(db_host, np.asarray(qd.sides),
                                 np.asarray(qd.labels), np.asarray(qd.mask), cfg)
        want[len(maps):] = 0
        check(np.array_equal(got, want.astype(np.float32)),
              f"query {i}: {int(want.sum())} votes equal to the NumPy re-tally")
    log(f"scale peak_bytes_in_use {peak_bytes(dev)} ({dev.device_kind})")


def phase_multi(S, n_dev):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from sgtd_tpu import SGTDConfig
    from sgtd_tpu.data.synthetic import make_map_and_queries
    from sgtd_tpu.db.database import DescriptorDB
    from sgtd_tpu.match.pipeline import localize
    from sgtd_tpu.parallel.mesh import db_sharding, make_mesh, shard_database
    from sgtd_tpu.parallel.ring_sweep import make_ring_localizer
    from sgtd_tpu.parallel.sharded_match import make_sharded_localizer

    devs = jax.devices()
    check(len(devs) >= n_dev, f"{len(devs)} devices >= {n_dev}")
    cfg0 = SGTDConfig()
    maps, queries, _ = make_map_and_queries(
        cfg0, seed=2026, num_map_frames=S["bench_frames"],
        num_queries=S["multi_queries"], center_noise_m=0.05, dropout=0.1,
        label_corrupt_rate=0.05,
    )
    db, cfg, qall, _, _ = build_world(maps, queries, cfg0)

    loc1 = jax.jit(jax.vmap(functools.partial(localize, config=cfg),
                            in_axes=(None, 0)))
    ref = jax.tree_util.tree_map(np.asarray, loc1(db, qall))
    log(f"  single card ({devs[0]}) reference: found "
        f"{int(ref.found.sum())}/{len(queries)}")

    def bytes_per_device(tree):
        per = {}
        for leaf in jax.tree_util.tree_leaves(tree):
            for sh in leaf.addressable_shards:
                per[sh.device.id] = per.get(sh.device.id, 0) + sh.data.nbytes
        return per

    def compare(label, res):
        res = jax.tree_util.tree_map(np.asarray, res)
        for i in range(len(queries)):
            if not np.array_equal(np.sort(res.votes[i]), np.sort(ref.votes[i])):
                raise CheckFailed(f"{label}: query {i} votes differ")
            floor = ref.votes[i].min()
            a = {(int(f), v) for f, v in zip(ref.frames[i], ref.votes[i]) if v > floor}
            b = {(int(f), v) for f, v in zip(res.frames[i], res.votes[i]) if v > floor}
            if a != b:
                raise CheckFailed(f"{label}: query {i} candidate frames differ")
        check(True, f"{label}: candidate votes bit-identical to one card "
                    f"for {len(queries)} queries")
        trunc_check(label, res.truncated)
        rpe_check(label, res.poses[:, 0], res.found, queries, cfg)

    log(f"db-axis sharded localizer (dp=1 x db={n_dev})")
    mesh = make_mesh(dp=1, db=n_dev, devices=devs[:n_dev])
    sdb = shard_database(db, mesh)
    per = bytes_per_device(sdb.keys)
    log(f"  DB row bytes per device (keys): {per}")
    log(f"  DB bytes per device (all fields): {bytes_per_device(sdb)}")
    check(len(per) == n_dev and len(set(per.values())) == 1,
          f"DB rows spread evenly over {n_dev} devices")
    res, _ = compile_and_time("sharded localize", make_sharded_localizer(mesh, cfg),
                              sdb, qall, reps=1)
    compare("sharded", res)

    log(f"ring sweep (dp={n_dev})")
    rmesh = Mesh(np.asarray(devs[:n_dev]).reshape(n_dev, 1), ("dp", "db"))
    rows = {"keys", "codes", "packed2", "vertices", "frame_ids"}
    shard = DescriptorDB(*(
        NamedSharding(rmesh, P("dp") if f in rows else s.spec)
        for f, s in zip(DescriptorDB._fields, db_sharding(rmesh))
    ))
    rdb = DescriptorDB(*(jax.device_put(x, s) for x, s in zip(db, shard)))
    log(f"  DB row bytes per device (keys): {bytes_per_device(rdb.keys)}")
    log(f"  DB bytes per device (all fields): {bytes_per_device(rdb)}")
    res, _ = compile_and_time("ring localize", make_ring_localizer(rmesh, cfg),
                              rdb, qall, reps=1)
    compare("ring", res)
    for d in devs[:n_dev]:
        log(f"  {d}: peak_bytes_in_use {peak_bytes(d)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card paths")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny sizes on the CPU; prints no device result")
    ap.add_argument("--phases", default="kernels,bench,scale",
                    help="comma-separated one-card phases to run")
    args = ap.parse_args(argv)

    import jax

    from sgtd_tpu.utils.compile_cache import enable_compile_cache
    from sgtd_tpu.utils.device import card_line

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.cpu_rehearsal:
        print(f"[smoke] FAIL: no GPU (JAX's first device is {dev.platform}); "
              "nothing was run", file=sys.stderr)
        return 2
    S = REHEARSAL if args.cpu_rehearsal else FULL
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__} | {dev.platform} {dev.device_kind} "
        f"x{len(jax.devices())} | compile cache {enable_compile_cache()}")

    if args.devices > 1:
        phases = [("multi", lambda: phase_multi(S, args.devices))]
    else:
        table = {"kernels": phase_kernels, "bench": phase_bench,
                 "scale": phase_scale}
        phases = [(p, functools.partial(table[p], S, dev))
                  for p in args.phases.split(",")]
    failed = []
    for name, fn in phases:
        log(f"=== phase {name} ===")
        t0 = time.time()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failed.append(name)
            log(f"phase {name} FAILED after {time.time() - t0:.1f}s")
        else:
            log(f"phase {name} passed in {time.time() - t0:.1f}s")
    if failed:
        print(f"[smoke] FAIL: phases {failed}", file=sys.stderr)
        return 1
    if args.cpu_rehearsal:
        log("CPU rehearsal passed (not a device result)")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
