"""Ring-sweep localization: DB blocks rotate, queries stay put.

The scaling mode for maps exceeding aggregate-per-device HBM budgets (the
"long-context analog" of SURVEY.md §5.7): the mesh is one ``dp`` axis with
query scans sharded across it and the descriptor DB split into one block per
device. Over n ring steps every device scans every block —
``jax.lax.ppermute`` rotates the block row arrays between devices while per-block
partial votes accumulate locally (structurally identical to ring attention):

  step s: device d holds block b = (d + s) mod n
          votes    += probe_and_hits(block, my queries)
          hit rows' vertices/frames are banked locally (so verification
          never needs a block that has rotated away)
          block    -> neighbour d+1

After the sweep: top-K candidates from the summed votes, pair lists from the
banked hits, batched verification — identical results to the single-device
pipeline up to per-block hit quotas.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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


class _RingBlock(NamedTuple):
    """The DB row arrays that travel around the ring."""

    keys: jnp.ndarray
    codes: jnp.ndarray
    packed2: jnp.ndarray
    vertices: jnp.ndarray
    frame_ids: jnp.ndarray


def _localize_ring(db_local: DescriptorDB, graphs: SemanticGraph, config: SGTDConfig):
    n_dev = jax.lax.axis_size("dp")
    my = jax.lax.axis_index("dp").astype(jnp.int32)
    m_block = db_local.keys.shape[0]
    caps = config.caps
    u = caps.hits_per_descriptor
    d_max = caps.max_descriptors
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    block0 = _RingBlock(
        keys=db_local.keys,
        codes=db_local.codes,
        packed2=db_local.packed2,
        vertices=db_local.vertices,
        frame_ids=db_local.frame_ids,
    )

    def one_query(graph):
        query = build_descriptors(graph, config.desc, caps)

        def ring_step(s, state):
            block, votes, bank_frame, bank_verts, truncated = state
            # Which global block does this device hold at step s? Blocks
            # travel towards d+1, so d receives from d-1: b = (d - s) mod n.
            b = jnp.mod(my - s, n_dev)
            sub_db = db_local._replace(
                keys=block.keys,
                codes=block.codes,
                packed2=block.packed2,
                vertices=block.vertices,
                frame_ids=block.frame_ids,
            )
            ph = probe_and_hits(
                sub_db, query, config.desc, config.search, caps,
                row_offset=b * m_block,
            )
            sel_row, sel_frame = ph.sel_row, ph.sel_frame
            votes = votes + ph.votes
            trunc = (
                ph.scan_overflow.astype(jnp.int32) * 1
                + ph.pair_overflow.astype(jnp.int32) * 2
            )
            bank_frame = jax.lax.dynamic_update_slice(
                bank_frame, sel_frame[None], (s, 0, 0)
            )
            bank_verts = jax.lax.dynamic_update_slice(
                bank_verts, block.vertices[sel_row][None], (s, 0, 0, 0, 0)
            )
            block = _RingBlock(
                *(jax.lax.ppermute(x, "dp", perm) for x in block)
            )
            return block, votes, bank_frame, bank_verts, truncated | trunc

        f_pad = db_local.frame_poses.shape[0]
        votes0 = jnp.zeros((f_pad,), jnp.float32)
        bank_frame0 = jnp.full((n_dev, d_max, u), f_pad, jnp.int32)
        bank_verts0 = jnp.zeros((n_dev, d_max, u, 3, 3), jnp.float32)
        _, votes, bank_frame, bank_verts, truncated = jax.lax.fori_loop(
            0, n_dev, ring_step,
            (block0, votes0, bank_frame0, bank_verts0, jnp.int32(0)),
        )

        cand_votes, cand_frames, cand_valid = select_candidates(
            votes, config.search
        )
        # Banked hits across all blocks: (D, n*U); "rows" index the flat
        # bank so verification gathers from banked vertices.
        sel_frame_all = jnp.transpose(bank_frame, (1, 0, 2)).reshape(d_max, -1)
        flat_ids = jnp.arange(d_max * n_dev * u, dtype=jnp.int32).reshape(
            d_max, -1
        )
        pq, pslot, pv = extract_pairs(
            flat_ids, sel_frame_all, cand_frames, cand_valid,
            caps.pairs_per_candidate, f_pad=f_pad,
        )
        verts_flat = jnp.transpose(bank_verts, (1, 0, 2, 3, 4)).reshape(
            d_max * n_dev * u, 3, 3
        )
        vq = query.vertices[pq]
        vdb = verts_flat[pslot]
        ver = verify_pairs(vq, vdb, pv, cand_valid, config.search)

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

    return jax.vmap(one_query)(graphs)


def make_ring_localizer(mesh: Mesh, config: SGTDConfig = SGTDConfig()):
    """(sharded_db, query_batch sharded on 'dp') -> LocalizationResult.

    The mesh must be 1-D ('dp' only, e.g. ``make_mesh(dp=n, db=1)`` reshaped)
    — every device holds one DB block and a slice of the query batch.
    """
    db_specs = DescriptorDB(
        keys=P("dp"),
        codes=P("dp"),
        packed2=P("dp", None),
        vertices=P("dp", None, None),
        frame_ids=P("dp"),
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
    out_specs = jax.tree_util.tree_map(
        lambda _: P("dp"), LocalizationResult(*range(len(LocalizationResult._fields)))
    )
    fn = shard_map(
        functools.partial(_localize_ring, config=config),
        mesh=mesh,
        in_specs=(db_specs, graph_specs),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)
