"""The bench.py workload as a reusable builder.

bench.py, the bench-scale multichip validation (tests/
test_sharded_benchscale.py, __graft_entry__.dryrun_multichip) and the
scale tools all need the SAME world: 200 keyframes / ~400k descriptor
rows / calibrated scan budget. This builds it once, with the chunked
descriptor builder (one small compile at any map size).
"""

from __future__ import annotations

import jax
import numpy as np

from sgtd_tpu.config import SGTDConfig
from sgtd_tpu.data.synthetic import make_map_and_queries
from sgtd_tpu.db.database import tuned_config
from sgtd_tpu.db.device_build import build_database_calibrated
from sgtd_tpu.eval.runner import build_descriptors_chunked, stack_graphs
from sgtd_tpu.match.search import fit_scan_slots


def build_index(maps, queries, config: SGTDConfig, calibrate_n: int = 16):
    """Descriptor DB of ``maps`` and the config tuned to it: bucket cap
    fitted to the DB, scan slots calibrated on the first ``calibrate_n``
    queries (one merged assemble + calibrate program).

    Returns (tuned_config, db, query_graph_batch, map_descriptors, report).
    """
    batch = stack_graphs(maps)
    descs = build_descriptors_chunked(batch, config)
    qall = stack_graphs(queries)
    sample = jax.tree_util.tree_map(lambda x: x[:calibrate_n], qall)
    db, report, totals = build_database_calibrated(
        descs, batch.pose, build_descriptors_chunked(sample, config),
        config.desc,
    )
    cfg = tuned_config(config, report)
    cfg = fit_scan_slots(int(np.asarray(totals).max()), cfg)
    return cfg, db, qall, descs, report


def build_bench_world(
    num_map: int = 200,
    num_q: int = 16,
    seed: int = 2026,
    config: SGTDConfig | None = None,
    calibrate_n: int = 16,
):
    """Returns (tuned_config, db, query_graph_batch, report, world).

    Same seed/noise profile as bench.py's headline workload; the query
    batch is a stacked SemanticGraph (leading axis num_q).
    """
    cfg = config or SGTDConfig()
    maps, queries, world = make_map_and_queries(
        cfg, seed=seed, num_map_frames=num_map, num_queries=num_q,
        center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05,
    )
    cfg, db, qall, _, report = build_index(maps, queries, cfg, calibrate_n)
    return cfg, db, qall, report, world


def bench_clouds(world, cfg: SGTDConfig, cloud_pts: int = 4096,
                 src_pts: int = 1024, seed: int = 77):
    """Keyframe and query clouds of the bench workload, on device.

    Returns (map_clouds (F, cloud_pts, 3), map_masks, map_covs
    (F, cloud_pts, 3, 3), query_clouds (Q, src_pts, 3), query_masks).
    Reference preprocessing (semantic_graph_localization.cpp:653-688): the
    query cloud is voxel-downsampled at SG_data/leaf_size before GICP, the
    map keyframe cloud is used raw. Clouds are deterministic-surface renders
    (panels + ground), so map and query clouds sample the same surfaces.
    ``src_pts`` caps the downsampled query cloud (849 voxels at most over
    the bench's 64 queries); load_query_cloud thins deterministically
    beyond it. Map covariances are precomputed once, as at map load.
    """
    import jax.numpy as jnp

    from sgtd_tpu.data.synthetic import render_planar_cloud
    from sgtd_tpu.ops.voxel import load_query_cloud
    from sgtd_tpu.refine.gicp import point_covariances

    rng = np.random.default_rng(seed)
    m_clouds, m_masks = zip(
        *(render_planar_cloud(world, p, rng, max_points=cloud_pts)
          for p in world.map_poses)
    )
    map_clouds = jnp.asarray(np.stack(m_clouds))
    map_masks = jnp.asarray(np.stack(m_masks))
    # 16 clouds at a time: each brute-force kNN holds a (P, P) distance
    # matrix, 13 GB per 200 keyframes at P=4096 if all run at once.
    map_covs = jax.jit(lambda c, m: jax.lax.map(
        lambda cm: point_covariances(cm[0], cm[1], cfg.gicp),
        (c, m), batch_size=16,
    ))(map_clouds, map_masks)
    q_clouds, q_masks = [], []
    for p in world.query_poses:
        c, m = render_planar_cloud(world, p, rng, max_points=cloud_pts)
        qc, qm = load_query_cloud(c[m], cfg.gicp.leaf_size, src_pts)
        q_clouds.append(qc)
        q_masks.append(qm)
    return (map_clouds, map_masks, map_covs,
            jnp.asarray(np.stack(q_clouds)), jnp.asarray(np.stack(q_masks)))


def make_scale_graphs(num_map: int, num_q: int, config: SGTDConfig,
                      seed: int = 2027):
    """Map and query graphs of the large-map workload.

    The world's area grows with the keyframe count at fixed keyframe
    spacing, so keyframes do not all alias to the same cells. Returns
    (maps, queries, world).
    """
    from sgtd_tpu.data.synthetic import make_world, observe

    rng = np.random.default_rng(seed)
    extent = max(400.0, 8.0 * np.sqrt(num_map) * 4.0)
    world = make_world(
        rng, extent_m=extent, num_map_frames=num_map, num_queries=num_q
    )
    maps = [observe(world, p, config, rng) for p in world.map_poses]
    queries = [
        observe(world, p, config, rng, center_noise_m=0.05, dropout=0.1)
        for p in world.query_poses
    ]
    return maps, queries, world
