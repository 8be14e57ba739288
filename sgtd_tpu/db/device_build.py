"""On-device descriptor-database assembly.

The host-side build (db.database.build_database_stacked) pulls every
descriptor field to the host and back. This path assembles the same DescriptorDB entirely on device — one
sort + gathers + a searchsorted cell table — so nothing crosses the wire
except the bucket-stat scalars used for config tuning.

Row capacity is static: F x max_descriptors rows with padding rows keyed
PAD_KEY and sorted to the end (same layout the host build produces, so the
two paths are interchangeable).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sgtd_tpu.config import DescriptorConfig
from sgtd_tpu.db.database import (
    DBBuildReport,
    DescriptorDB,
    MAX_TABLE_ROWS,
    PAD_KEY,
    _build_bucket_table_np,
)
from sgtd_tpu.desc.keys import validate_key_space, _N_CODES
from sgtd_tpu.desc.triangles import Descriptors


@functools.partial(jax.jit, static_argnames=("cfg", "table_slots"))
def _assemble(
    descs: Descriptors,
    poses: jnp.ndarray,
    cfg: DescriptorConfig,
    table_slots: int,
):
    extent = validate_key_space(cfg)
    f_n, d_n = descs.mask.shape
    m = f_n * d_n

    sides = descs.sides.reshape(m, 3)
    labels = descs.labels.reshape(m, 3)
    verts = descs.vertices.reshape(m, 3, 3)
    frames = jnp.repeat(jnp.arange(f_n, dtype=jnp.int32), d_n)
    valid = descs.mask.reshape(m)

    q = jnp.clip(jnp.floor(sides + 0.5).astype(jnp.int32), 0, extent - 1)
    l = jnp.clip(labels, 0, 12)
    code = (l[:, 0] * 13 + l[:, 1]) * 13 + l[:, 2]
    key = ((q[:, 0] * extent + q[:, 1]) * extent + q[:, 2]) * _N_CODES + code
    key = jnp.where(valid, key, jnp.int32(PAD_KEY))

    order = jnp.argsort(key)
    key_s = key[order]
    sides_s = sides[order]
    verts_s = verts[order]
    frames_s = frames[order]
    valid_s = valid[order]

    codes = jnp.where(valid_s, key_s % _N_CODES, -1)
    qs = jnp.clip(jnp.round(sides_s * 256.0), 0, 65535).astype(jnp.uint32)
    # Frame ids beyond 16 bits are unpackable; wide-frame DBs are served by
    # the frame_ids gather instead (search._frame_of_rows).
    packed2 = jnp.stack(
        [qs[:, 0] | (qs[:, 1] << 16),
         qs[:, 2] | ((frames_s.astype(jnp.uint32) & 0xFFFF) << 16)],
        axis=-1,
    )

    n_cells_total = extent * extent * extent
    cells = jnp.where(valid_s, key_s // _N_CODES, n_cells_total)
    cell_start = jnp.searchsorted(
        cells, jnp.arange(n_cells_total + 1, dtype=jnp.int32)
    ).astype(jnp.int32)

    # Frame-major index: key-sorted row ids grouped by owning keyframe
    # (candidate-major pair extraction scans these contiguously).
    f_pad = max(-(-f_n // 8) * 8, 8)
    frame_sort_key = jnp.where(valid_s, frames_s, jnp.int32(f_pad))
    frame_rows = jnp.argsort(frame_sort_key, stable=True).astype(jnp.int32)
    frame_start = jnp.searchsorted(
        frame_sort_key[frame_rows], jnp.arange(f_pad + 1, dtype=jnp.int32)
    ).astype(jnp.int32)

    # Bucket stats on device: run lengths over the sorted keys.
    is_first = jnp.concatenate(
        [jnp.ones((1,), bool), key_s[1:] != key_s[:-1]]
    ) & valid_s
    group = jnp.cumsum(is_first.astype(jnp.int32)) - 1
    counts = jax.ops.segment_sum(
        valid_s.astype(jnp.int32), jnp.maximum(group, 0), num_segments=m
    )
    max_bucket = jnp.max(counts)
    n_buckets = jnp.sum(is_first.astype(jnp.int32))
    cfirst = jnp.concatenate(
        [jnp.ones((1,), bool), cells[1:] != cells[:-1]]
    ) & valid_s
    cgroup = jnp.cumsum(cfirst.astype(jnp.int32)) - 1
    ccounts = jax.ops.segment_sum(
        valid_s.astype(jnp.int32), jnp.maximum(cgroup, 0), num_segments=m
    )
    max_cell = jnp.max(ccounts)
    n_cells = jnp.sum(cfirst.astype(jnp.int32))
    n_rows = jnp.sum(valid_s.astype(jnp.int32))

    fp = jnp.tile(jnp.eye(4, dtype=jnp.float32), (f_pad, 1, 1))
    fp = fp.at[:f_n].set(poses.astype(jnp.float32))
    fv = jnp.zeros(f_pad, bool).at[:f_n].set(True)

    # Direct-addressed bucket table: one scatter per bucket first-row. The
    # slot index uses the dynamic (traced) code stride; overflow slots and
    # sentinel rows scatter out of bounds and are dropped — the host wrapper
    # validates the packing limits and empties the table on violation.
    mark = (
        jnp.zeros(_N_CODES, jnp.int32)
        .at[jnp.where(valid_s, codes, _N_CODES)]
        .set(1, mode="drop")
    )
    code_remap = jnp.where(mark > 0, jnp.cumsum(mark) - 1, -1).astype(jnp.int32)
    stride = jnp.sum(mark)
    cell_remap = (
        jnp.full(n_cells_total, -1, jnp.int32)
        .at[jnp.where(valid_s, cells, n_cells_total)]
        .set(cgroup.astype(jnp.int32), mode="drop")
    )
    rowi = jnp.arange(m, dtype=jnp.uint32)
    blen = counts[jnp.maximum(group, 0)].astype(jnp.uint32)
    word2 = jnp.stack([rowi, blen], axis=-1)  # (m, 2)
    dcode = code_remap[jnp.clip(codes, 0, _N_CODES - 1)]
    slot = jnp.where(
        is_first & valid_s, cgroup * stride + dcode, jnp.int32(table_slots)
    )
    bucket_table = (
        jnp.zeros((table_slots, 2), jnp.uint32).at[slot].set(word2, mode="drop")
    )

    db = DescriptorDB(
        keys=key_s,
        codes=codes.astype(jnp.int32),
        packed2=packed2,
        vertices=verts_s,
        frame_ids=frames_s,
        cell_start=cell_start,
        frame_rows=frame_rows,
        frame_start=frame_start,
        frame_poses=fp,
        frame_valid=fv,
        bucket_table=bucket_table,
        cell_remap=cell_remap,
        code_remap=code_remap,
        table_stride=stride[None].astype(jnp.int32),
    )
    stats = jnp.stack([n_rows, n_buckets, max_bucket, n_cells, max_cell, stride])
    return db, stats


def build_database_on_device(
    descs: Descriptors,
    poses: jnp.ndarray,
    cfg: DescriptorConfig = DescriptorConfig(),
    bucket_cap_for_report: int = 256,
    table_slots: int = 1 << 23,
) -> Tuple[DescriptorDB, DBBuildReport]:
    """Assemble the DB from stacked (F, D, ...) descriptors without bulk
    device->host transfers. ``poses``: (F, 4, 4)."""
    db, stats = _assemble(descs, jnp.asarray(poses), cfg, table_slots)
    n_rows, n_buckets, max_bucket, n_cells, max_cell, stride = (
        int(x) for x in np.asarray(stats)
    )
    # (No per-cell capacity ceiling: the bisection fallback sizes its step
    # count from the static table length, search._bucket_lookup.)
    # Direct-table packing limits: fall back to bisection when exceeded.
    m_pad = db.keys.shape[0]
    if m_pad >= MAX_TABLE_ROWS or n_cells * stride > table_slots:
        db = db._replace(
            bucket_table=jnp.zeros((0, 2), jnp.uint32),
            cell_remap=jnp.zeros(0, jnp.int32),
            code_remap=jnp.zeros(0, jnp.int32),
        )
    report = DBBuildReport(
        num_rows=n_rows,
        num_frames=int(descs.mask.shape[0]),
        num_cells=n_cells,
        max_bucket=max_bucket,
        rows_beyond_cap=0 if max_bucket <= bucket_cap_for_report else -1,
        max_cell_bucket=max_cell,
    )
    return db, report


@functools.partial(jax.jit, static_argnames=("cfg", "table_slots"))
def _assemble_and_totals(
    descs: Descriptors,
    poses: jnp.ndarray,
    s_sides: jnp.ndarray,
    s_labels: jnp.ndarray,
    s_mask: jnp.ndarray,
    cfg: DescriptorConfig,
    table_slots: int,
):
    """_assemble + the scan-slot calibration totals in ONE program.

    One program instead of two saves a compilation at map load."""
    from sgtd_tpu.desc.keys import probe_cells
    from sgtd_tpu.match.search import _bucket_lookup

    db, stats = _assemble(descs, poses, cfg, table_slots)

    def one(s, lab, msk):
        cells, code, gate = probe_cells(s, lab, cfg)
        st, en, ok = _bucket_lookup(db, cells, code, gate & msk[:, None], None)
        return jnp.sum(jnp.where(ok, en - st, 0))

    totals = jax.vmap(one)(s_sides, s_labels, s_mask)
    return db, stats, totals


def build_database_calibrated(
    descs: Descriptors,
    poses: jnp.ndarray,
    sample_descs: Descriptors,
    cfg: DescriptorConfig = DescriptorConfig(),
    bucket_cap_for_report: int = 256,
    table_slots: int = 1 << 23,
) -> Tuple[DescriptorDB, DBBuildReport, jnp.ndarray]:
    """build_database_on_device plus per-sample-query probe-scan totals
    (feed ``totals.max()`` to ``match.search.fit_scan_slots``)."""
    db, stats, totals = _assemble_and_totals(
        descs, jnp.asarray(poses), sample_descs.sides, sample_descs.labels,
        sample_descs.mask, cfg, table_slots,
    )
    n_rows, n_buckets, max_bucket, n_cells, max_cell, stride = (
        int(x) for x in np.asarray(stats)
    )
    m_pad = db.keys.shape[0]
    if m_pad >= MAX_TABLE_ROWS or n_cells * stride > table_slots:
        db = db._replace(
            bucket_table=jnp.zeros((0, 2), jnp.uint32),
            cell_remap=jnp.zeros(0, jnp.int32),
            code_remap=jnp.zeros(0, jnp.int32),
        )
    report = DBBuildReport(
        num_rows=n_rows,
        num_frames=int(descs.mask.shape[0]),
        num_cells=n_cells,
        max_bucket=max_bucket,
        rows_beyond_cap=0 if max_bucket <= bucket_cap_for_report else -1,
        max_cell_bucket=max_cell,
    )
    return db, report, totals


def append_database(
    db: DescriptorDB,
    new_descs: Descriptors,
    new_poses: jnp.ndarray,
    cfg: DescriptorConfig = DescriptorConfig(),
) -> Tuple[DescriptorDB, DBBuildReport]:
    """Append new keyframes to an existing DB (the analog of the
    reference's incremental structures: ikd-Tree insertion / AddSTDescs).

    There is no incremental mutation — the merged table is re-sorted
    on device in one pass (~ms for millions of rows), which is the faster
    *and* simpler design (SURVEY.md §2.2 ikd-Tree row). ``new_descs`` is a
    stacked (F_new, D, ...) pytree; new frame ids continue after the
    existing frames.
    """
    f_old = int(jnp.sum(db.frame_valid))
    return _append_assemble(db, new_descs, new_poses, cfg, f_old)


def _append_assemble(db, new_descs, new_poses, cfg, f_old):
    extent = validate_key_space(cfg)
    f_new, d_n = new_descs.mask.shape
    m_new = f_new * d_n

    sides = new_descs.sides.reshape(m_new, 3)
    labels = jnp.clip(new_descs.labels.reshape(m_new, 3), 0, 12)
    verts = new_descs.vertices.reshape(m_new, 3, 3)
    frames = jnp.repeat(
        jnp.arange(f_new, dtype=jnp.int32), d_n
    ) + jnp.int32(f_old)
    valid = new_descs.mask.reshape(m_new)

    q = jnp.clip(jnp.floor(sides + 0.5).astype(jnp.int32), 0, extent - 1)
    code = (labels[:, 0] * 13 + labels[:, 1]) * 13 + labels[:, 2]
    key = ((q[:, 0] * extent + q[:, 1]) * extent + q[:, 2]) * _N_CODES + code
    key = jnp.where(valid, key, jnp.int32(PAD_KEY))
    qs = jnp.clip(jnp.round(sides * 256.0), 0, 65535).astype(jnp.uint32)
    p2 = jnp.stack(
        [qs[:, 0] | (qs[:, 1] << 16),
         qs[:, 2] | ((frames.astype(jnp.uint32) & 0xFFFF) << 16)],
        axis=-1,
    )
    codes = jnp.where(valid, code, -1)

    all_key = jnp.concatenate([db.keys, key])
    order = jnp.argsort(all_key)
    key_s = all_key[order]
    take = lambda a, b: jnp.concatenate([a, b])[order]
    codes_s = take(db.codes, codes)
    p2_s = take(db.packed2, p2)
    verts_s = take(db.vertices, verts)
    frames_s = take(db.frame_ids, frames)
    valid_s = key_s != jnp.int32(PAD_KEY)

    n_cells_total = extent * extent * extent
    cells = jnp.where(valid_s, key_s // _N_CODES, n_cells_total)
    cell_start = jnp.searchsorted(
        cells, jnp.arange(n_cells_total + 1, dtype=jnp.int32)
    ).astype(jnp.int32)

    f_total = f_old + f_new
    f_pad = max(-(-f_total // 8) * 8, 8)
    fp = jnp.tile(jnp.eye(4, dtype=jnp.float32), (f_pad, 1, 1))
    fp = fp.at[:f_old].set(db.frame_poses[:f_old])
    fp = fp.at[f_old:f_total].set(jnp.asarray(new_poses, jnp.float32))
    fv = jnp.zeros(f_pad, bool).at[:f_total].set(True)

    frame_sort_key = jnp.where(valid_s, frames_s, jnp.int32(f_pad))
    frame_rows = jnp.argsort(frame_sort_key, stable=True).astype(jnp.int32)
    frame_start = jnp.searchsorted(
        frame_sort_key[frame_rows], jnp.arange(f_pad + 1, dtype=jnp.int32)
    ).astype(jnp.int32)

    # Stats + direct table on host (append is a map-maintenance op, not a
    # hot path).
    keys_np = np.asarray(key_s)
    real = keys_np != PAD_KEY
    uniq, counts = np.unique(keys_np[real], return_counts=True)
    _, cellc = np.unique(keys_np[real] // _N_CODES, return_counts=True)
    table, cell_remap, code_remap, stride = _build_bucket_table_np(
        keys_np[real],
        extent,
        int(db.bucket_table.shape[0]) or (1 << 23),
        keys_np.size,
        int(counts.max()) if counts.size else 0,
    )
    new_db = DescriptorDB(
        keys=key_s, codes=codes_s, packed2=p2_s,
        vertices=verts_s, frame_ids=frames_s, cell_start=cell_start,
        frame_rows=frame_rows, frame_start=frame_start,
        frame_poses=fp, frame_valid=fv,
        bucket_table=jnp.asarray(table),
        cell_remap=jnp.asarray(cell_remap),
        code_remap=jnp.asarray(code_remap),
        table_stride=jnp.asarray(stride),
    )
    report = DBBuildReport(
        num_rows=int(real.sum()),
        num_frames=f_total,
        num_cells=int(len(np.unique(keys_np[real] // _N_CODES))),
        max_bucket=int(counts.max()) if counts.size else 0,
        rows_beyond_cap=0,
        max_cell_bucket=int(cellc.max()) if cellc.size else 0,
    )
    return new_db, report
