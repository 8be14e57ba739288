"""Multi-device localization: DB rows sharded, queries data-parallel.

The reference is strictly single-process (SURVEY.md section 2.3); its map
capacity is bounded by one host's RAM and MAX_FRAME_N. Here the descriptor
table shards across the ``db`` mesh axis and query scans across ``dp``:

  per-shard bucket probes + rough filter     (local rows only)
  -> psum vote tallies over 'db'             (exact global votes)
  -> identical top-K candidate selection on every shard
  -> local pair extraction (per-shard quota) + vertex gather
  -> all_gather pair lists over 'db'         (small: C x P x 3 x 3)
  -> replicated batched verification.

The heavy, map-sized work (bucket scans, votes) scales with shard count;
only candidate-pair lists cross between devices. Numerically the result is identical to
the single-device pipeline up to the per-shard pair quota split.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from sgtd_tpu.config import SGTDConfig
from sgtd_tpu.db.database import DescriptorDB
from sgtd_tpu.desc.triangles import Descriptors, build_descriptors
from sgtd_tpu.geom import se3
from sgtd_tpu.graph.types import SemanticGraph
from sgtd_tpu.match.pipeline import LocalizationResult
from sgtd_tpu.match.search import extract_pairs, probe_and_hits, select_candidates
from sgtd_tpu.match.verify import verify_pairs
from sgtd_tpu.ops.linalg3 import matmul


def _compact_valid_first(pair_valid, *arrays):
    """Reorder each candidate's gathered pairs so valid ones form a prefix
    (verify_pairs' hypothesis sampling indexes by position)."""
    order = jnp.argsort(~pair_valid, axis=-1, stable=True)  # (C, P)
    out = [jnp.take_along_axis(pair_valid, order, axis=-1)]
    for a in arrays:
        idx = order.reshape(order.shape + (1,) * (a.ndim - 2))
        out.append(jnp.take_along_axis(a, idx, axis=1))
    return out


def _localize_one_sharded(db_local: DescriptorDB, query: Descriptors, config: SGTDConfig):
    """Body run per (dp, db) shard for a single query scan."""
    n_db = jax.lax.axis_size("db")
    p_total = config.caps.pairs_per_candidate
    p_local = max(p_total // n_db, 1)

    # This shard holds rows [offset, offset + m_local) of the global table;
    # the replicated cell_start / frame_rows offsets are clipped into that
    # range.
    m_local = db_local.keys.shape[0]
    offset = jax.lax.axis_index("db").astype(jnp.int32) * m_local
    ph = probe_and_hits(
        db_local, query, config.desc, config.search, config.caps,
        row_offset=offset,
    )
    sel_row, sel_frame = ph.sel_row, ph.sel_frame
    votes = jax.lax.psum(ph.votes, "db")
    truncated = jax.lax.pmax(
        ph.scan_overflow.astype(jnp.int32) * 1
        + ph.pair_overflow.astype(jnp.int32) * 2,
        "db",
    )
    cand_votes, cand_frames, cand_valid = select_candidates(votes, config.search)
    pq, pr, pv = extract_pairs(
        sel_row, sel_frame, cand_frames, cand_valid, p_local,
        f_pad=db_local.frame_poses.shape[0],
    )

    # Gather vertex triples locally (pair rows are shard-local indices),
    # then concatenate pair lists across shards.
    vq = query.vertices[pq]  # (C, Pl, 3, 3)
    vdb = db_local.vertices[pr]
    vq_all = jax.lax.all_gather(vq, "db", axis=1, tiled=True)  # (C, S*Pl, 3, 3)
    vdb_all = jax.lax.all_gather(vdb, "db", axis=1, tiled=True)
    pv_all = jax.lax.all_gather(pv, "db", axis=1, tiled=True)

    pv_c, vq_c, vdb_c = _compact_valid_first(pv_all, vq_all, vdb_all)
    ver = verify_pairs(vq_c, vdb_c, pv_c, cand_valid, config.search)

    order = jnp.argsort(-ver.scores, stable=True)
    frames = cand_frames[order]
    scores = ver.scores[order]
    t_loop = se3.rt_to_mat(ver.rot[order], ver.trans[order])
    poses = matmul(db_local.frame_poses[frames], t_loop)
    best_score = scores[0]
    found = best_score > jnp.float32(config.search.icp_threshold)
    return LocalizationResult(
        found=found,
        best_frame=jnp.where(found, frames[0], -1),
        best_score=best_score,
        frames=frames,
        scores=scores,
        votes=cand_votes[order],
        rot=ver.rot[order],
        trans=ver.trans[order],
        poses=poses,
        num_descriptors=query.count,
        truncated=truncated,
    )


def make_sharded_localizer(mesh: Mesh, config: SGTDConfig = SGTDConfig()):
    """Build a jitted (sharded_db, query_graph_batch) -> LocalizationResult.

    The query batch leading axis is sharded over 'dp'; DB rows over 'db'.
    Use :func:`sgtd_tpu.parallel.mesh.shard_database` to place the DB.
    """
    db_specs = DescriptorDB(
        keys=P("db"),
        codes=P("db"),
        packed2=P("db", None),
        vertices=P("db", None, None),
        frame_ids=P("db"),
        cell_start=P(None),
        frame_rows=P(None),
        frame_start=P(None),
        frame_poses=P(None, None, None),
        frame_valid=P(None),
        bucket_table=P(None),
        cell_remap=P(None),
        code_remap=P(None),
        table_stride=P(None),
    )
    graph_specs = SemanticGraph(
        centers=P("dp", None, None),
        labels=P("dp", None),
        density=P("dp", None),
        mask=P("dp", None),
        pose=P("dp", None, None),
    )

    def _batch(db_local, graphs):
        def one(graph):
            query = build_descriptors(graph, config.desc, config.caps)
            return _localize_one_sharded(db_local, query, config)

        return jax.vmap(one)(graphs)

    out_specs = jax.tree_util.tree_map(
        lambda _: P("dp"), LocalizationResult(*range(len(LocalizationResult._fields)))
    )
    fn = shard_map(
        _batch,
        mesh=mesh,
        in_specs=(db_specs, graph_specs),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)
