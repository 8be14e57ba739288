"""Dense sorted descriptor database with a direct-addressed cell table.

JAX replacement for the reference's in-memory hash DB
``std::unordered_map<STDesc_LOC, std::vector<STDesc>>`` filled by
``STDescManager::AddSTDescs`` (src/sgtd/src/STDesc.cpp:149-172, STDesc.h:370).

Design: all map keyframes' descriptors are flattened into one table sorted by
the packed geometric key (cell * 2197 + label-code). Lookup is O(1), not a
binary search: a dense ``cell_start`` offset table over the quantised
side-length grid (extent^3 + 1 int32 entries) maps a probe cell directly to
its contiguous row range; the label-code equality check — the reference
encodes it in the hash key — happens during the (vectorised) bucket scan.
This removes the dependent binary-search gathers from the hot path.

The build runs host-side in NumPy (a one-off, ~seconds — the reference also
rebuilds its DB from JSON at startup, src/readme.txt:5) and the result is a
pytree of device arrays. Serialization is a plain ``.npz`` so loading a map
is a ``device_put``, not a rebuild.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from sgtd_tpu.config import CapacityConfig, DescriptorConfig
from sgtd_tpu.desc.keys import validate_key_space, _N_CODES
from sgtd_tpu.desc.triangles import Descriptors

# Sentinel key for padding rows: larger than any real packed key.
PAD_KEY = np.int32(2**31 - 1)

# Packed bucket-table word: row start in the high 20 bits, bucket length in
# the low 12. Limits (validated at build; builds beyond them fall back to the
# in-cell binary search): 2^20 rows per DB, 4095 rows per (cell, code) bucket.
# Direct bucket table rows: word 0 = start row, word 1 = bucket length —
# a (T, 2) uint32 table gathered as one 8-byte slice per probe (same
# per-row gather economics as packed2). No packing limits below 2^31 rows;
# the former single-word (start << 12 | len) layout capped the table at
# 2^20 rows and 4095-deep buckets, knocking scale-sized DBs (10M+ rows)
# back to the 16-step bisection path.
MAX_TABLE_ROWS = 1 << 31


class DescriptorDB(NamedTuple):
    """Sorted descriptor table + keyframe store.

    keys:        (M,) int32 ascending (cell*2197+code); padding rows PAD_KEY.
    codes:       (M,) int32 — packed vertex-label triple per row.
    packed2:     (M, 2) uint32 — per-row packed words, gathered as ONE
                 8-byte slice per probed row: word 0 = side lengths a|b in
                 16-bit fixed point (value = round(side * 256)), word 1 =
                 side c (low 16) | frame id (high 16). One 8-byte row
                 gather instead of two separate (M,) gathers.
    vertices:    (M, 3, 3) float32 — rows A, B, C (map-keyframe local frame).
    frame_ids:   (M,) int32 — owning keyframe.
    cell_start:  (extent^3 + 1,) int32 — row offset of each quantised cell;
                 rows of cell c are [cell_start[c], cell_start[c+1]).
    frame_rows:  (M,) int32 — key-sorted row ids grouped by keyframe
                 (candidate-major pair extraction scans them contiguously).
    frame_start: (F + 1,) int32 — offsets into frame_rows per keyframe.
    frame_poses: (F, 4, 4) float32 — keyframe poses (world from sensor).
    frame_valid: (F,) bool.

    Direct-addressed bucket table (O(1) probe -> bucket range; replaces the
    sequential 16-step in-cell binary search, which is the probe stage's
    latency bottleneck — 16 dependent gathers). Empty when the DB exceeds
    the packing limits (search falls back to bisection):

    bucket_table: (T, 2) uint32 — (row_start, length) of the
                  (dense_cell, dense_code) bucket at slot
                  dense_cell * table_stride + dense_code; (0, 0) = empty.
    cell_remap:   (extent^3,) int32 — quantised cell -> dense cell id, -1
                  when the cell holds no rows.
    code_remap:   (2197,) int32 — label-code -> dense code id, -1 when the
                  code appears nowhere in the DB.
    table_stride: (1,) int32 — number of distinct label codes in the DB.
    """

    keys: jnp.ndarray
    codes: jnp.ndarray
    packed2: jnp.ndarray
    vertices: jnp.ndarray
    frame_ids: jnp.ndarray
    cell_start: jnp.ndarray
    frame_rows: jnp.ndarray
    frame_start: jnp.ndarray
    frame_poses: jnp.ndarray
    frame_valid: jnp.ndarray
    bucket_table: jnp.ndarray
    cell_remap: jnp.ndarray
    code_remap: jnp.ndarray
    table_stride: jnp.ndarray

    @property
    def num_rows(self) -> int:
        return self.keys.shape[0]

    @property
    def num_frames(self) -> int:
        return self.frame_poses.shape[0]

    @property
    def has_direct_table(self) -> bool:
        return self.bucket_table.shape[0] > 0


@dataclasses.dataclass
class DBBuildReport:
    """Coverage stats — a DB build never truncates silently."""

    num_rows: int
    num_frames: int
    num_cells: int
    # Max rows sharing one (cell, code) bucket (the probe scan length).
    max_bucket: int
    # Rows beyond ``bucket_cap`` in their bucket: probes will not see them.
    rows_beyond_cap: int
    # Max rows sharing one quantised cell (the in-cell binary search's
    # depth scales as log2 of the table length, so this is diagnostic only).
    max_cell_bucket: int = 0

    def truncated_fraction(self) -> float:
        return self.rows_beyond_cap / max(self.num_rows, 1)

    @property
    def suggested_bucket_cap(self) -> int:
        """Smallest static bucket cap covering every cell of this DB.

        Probe cost scales linearly with the cap, so pass
        ``tuned_config(config, report)`` to avoid scanning padding (one
        recompile per DB, large speedup when buckets are shallow).
        """
        return max(8, -(-self.max_bucket // 8) * 8)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def build_database(
    desc_list: Sequence[Descriptors],
    poses: Sequence[np.ndarray],
    cfg: DescriptorConfig = DescriptorConfig(),
    caps: CapacityConfig = CapacityConfig(),
) -> Tuple[DescriptorDB, DBBuildReport]:
    """Assemble the sorted DB from per-keyframe descriptor sets.

    ``desc_list[i]`` are the descriptors of keyframe ``i`` (built with
    :func:`sgtd_tpu.desc.triangles.build_descriptors`), ``poses[i]`` its
    4x4 world-from-sensor pose.
    """
    stacked = stack_descriptor_arrays(desc_list)
    return build_database_stacked(stacked, poses, cfg, caps)


def stack_descriptor_arrays(desc_list: Sequence[Descriptors]):
    """Host-side (F, D, ...) stacking of per-frame descriptor sets.

    One device->host transfer per field (not per frame).
    """
    return Descriptors(
        sides=np.stack([np.asarray(d.sides) for d in desc_list]),
        angles=np.zeros((len(desc_list), 1)),
        vertices=np.stack([np.asarray(d.vertices) for d in desc_list]),
        labels=np.stack([np.asarray(d.labels) for d in desc_list]),
        node_ids=np.zeros((len(desc_list), 1), np.int32),
        center=np.zeros((len(desc_list), 1, 3)),
        mask=np.stack([np.asarray(d.mask) for d in desc_list]),
    )


def build_database_stacked(
    descs: Descriptors,
    poses: Sequence[np.ndarray],
    cfg: DescriptorConfig = DescriptorConfig(),
    caps: CapacityConfig = CapacityConfig(),
) -> Tuple[DescriptorDB, DBBuildReport]:
    """Assemble the DB from a stacked (F, D, ...) Descriptors pytree (device
    arrays allowed — each field is transferred once)."""
    extent = validate_key_space(cfg)

    m = np.asarray(descs.mask)  # (F, D)
    f_n, d_n = m.shape
    sides_a = np.asarray(descs.sides).reshape(f_n * d_n, 3)
    labels_a = np.asarray(descs.labels).reshape(f_n * d_n, 3)
    verts_a = np.asarray(descs.vertices).reshape(f_n * d_n, 3, 3)
    frames_a = np.repeat(np.arange(f_n, dtype=np.int32), d_n)
    flat_m = m.reshape(-1)

    sides = sides_a[flat_m].astype(np.float32)
    labels = labels_a[flat_m]
    verts = verts_a[flat_m].astype(np.float32)
    frames = frames_a[flat_m]

    # Insertion quantisation: round-half-up (ref STDesc.cpp:155-157).
    q = np.clip(np.floor(sides + 0.5).astype(np.int64), 0, extent - 1)
    l = np.clip(labels.astype(np.int64), 0, 12)
    code = (l[:, 0] * 13 + l[:, 1]) * 13 + l[:, 2]
    keys = (
        ((q[:, 0] * extent + q[:, 1]) * extent + q[:, 2]) * _N_CODES + code
    ).astype(np.int32)

    order = np.argsort(keys, kind="stable")
    keys, sides, verts, frames = keys[order], sides[order], verts[order], frames[order]
    cells = keys // _N_CODES

    # Bucket stats: per-(cell, code) buckets drive the probe scan length,
    # per-cell sizes bound the in-cell binary search.
    if keys.size:
        _, kcounts = np.unique(keys, return_counts=True)
        max_bucket = int(kcounts.max())
        beyond = int(np.maximum(kcounts - caps.bucket_cap, 0).sum())
        _, ccounts = np.unique(cells, return_counts=True)
        n_cells = int(ccounts.size)
        max_cell = int(ccounts.max())
        # No per-cell ceiling: the bisection fallback sizes its step count
        # from the static table length (search._bucket_lookup).
    else:
        max_bucket, beyond, n_cells, max_cell = 0, 0, 0, 0

    n = keys.shape[0]
    m_pad = max(_round_up(n, 128), 128)
    pad = m_pad - n
    keys_p = np.pad(keys, (0, pad), constant_values=PAD_KEY)
    sides = np.pad(sides, ((0, pad), (0, 0)))
    verts = np.pad(verts, ((0, pad), (0, 0), (0, 0)))
    frames = np.pad(frames, (0, pad))
    codes = np.where(keys_p == PAD_KEY, -1, keys_p % _N_CODES).astype(np.int32)

    # Direct-addressed cell table over the real (unpadded) rows.
    n_cells_total = extent * extent * extent
    cell_start = np.searchsorted(
        cells, np.arange(n_cells_total + 1, dtype=np.int64)
    ).astype(np.int32)

    f = f_n
    f_pad = max(_round_up(f, 8), 8)
    # Frame-major index over the padded table (padding rows -> bucket f_pad).
    frame_sort_key = np.where(keys_p == PAD_KEY, f_pad, frames).astype(np.int64)
    frame_rows = np.argsort(frame_sort_key, kind="stable").astype(np.int32)
    frame_start = np.searchsorted(
        frame_sort_key[frame_rows], np.arange(f_pad + 1)
    ).astype(np.int32)
    fp = np.tile(np.eye(4, dtype=np.float32), (f_pad, 1, 1))
    for i, p in enumerate(poses):
        fp[i] = np.asarray(p, dtype=np.float32).reshape(4, 4)
    fv = np.zeros(f_pad, dtype=bool)
    fv[:f] = True

    # 16-bit fixed-point side packing (resolution 1/256 = 0.004 cells, far
    # below the rough-match threshold).
    qs = np.clip(np.round(sides * 256.0), 0, 65535).astype(np.uint32)
    # Frame ids pack into word 1's high 16 bits; DBs beyond 65536
    # keyframes (f_pad > 65536 — the reference's MAX_FRAME_N=20000 ceiling
    # lifted) make the search gather frame_ids instead (search._frame_of_rows
    # keys off the static frame_poses shape), so the packed field is unused.
    packed2 = np.stack(
        [qs[:, 0] | (qs[:, 1] << 16),
         qs[:, 2] | ((frames.astype(np.uint32) & 0xFFFF) << 16)],
        axis=-1,
    )
    table, cell_remap, code_remap, stride = _build_bucket_table_np(
        keys, extent, caps.bucket_table_slots, m_pad, max_bucket
    )
    db = DescriptorDB(
        keys=jnp.asarray(keys_p),
        codes=jnp.asarray(codes),
        packed2=jnp.asarray(packed2),
        vertices=jnp.asarray(verts),
        frame_ids=jnp.asarray(frames),
        cell_start=jnp.asarray(cell_start),
        frame_rows=jnp.asarray(frame_rows),
        frame_start=jnp.asarray(frame_start),
        frame_poses=jnp.asarray(fp),
        frame_valid=jnp.asarray(fv),
        bucket_table=jnp.asarray(table),
        cell_remap=jnp.asarray(cell_remap),
        code_remap=jnp.asarray(code_remap),
        table_stride=jnp.asarray(stride),
    )
    report = DBBuildReport(
        num_rows=n,
        num_frames=f,
        num_cells=n_cells,
        max_bucket=max_bucket,
        rows_beyond_cap=beyond,
        max_cell_bucket=max_cell,
    )
    return db, report


def _build_bucket_table_np(
    keys: np.ndarray, extent: int, table_slots: int, m_pad: int, max_bucket: int
):
    """Direct-addressed (dense_cell, dense_code) -> packed (start, len) table.

    ``keys`` are the sorted real (unpadded) row keys. Returns zero-size
    arrays when the DB exceeds the limits (2^31 rows / table budget) —
    search then falls back to in-cell bisection.
    """
    empty = (
        np.zeros((0, 2), np.uint32),
        np.zeros(0, np.int32),
        np.zeros(0, np.int32),
        np.zeros(1, np.int32),
    )
    if m_pad >= MAX_TABLE_ROWS:
        return empty
    n_cells_total = extent * extent * extent
    if keys.size == 0:
        return (
            np.zeros((table_slots, 2), np.uint32),
            np.full(n_cells_total, -1, np.int32),
            np.full(_N_CODES, -1, np.int32),
            np.ones(1, np.int32),
        )
    uniq, starts, counts = np.unique(keys, return_index=True, return_counts=True)
    ucells = uniq // _N_CODES
    ucodes = uniq % _N_CODES
    used_cells = np.unique(ucells)
    used_codes = np.unique(ucodes)
    stride = int(used_codes.size)
    if int(used_cells.size) * stride > table_slots:
        return empty
    cell_remap = np.full(n_cells_total, -1, np.int32)
    cell_remap[used_cells] = np.arange(used_cells.size, dtype=np.int32)
    code_remap = np.full(_N_CODES, -1, np.int32)
    code_remap[used_codes] = np.arange(stride, dtype=np.int32)
    table = np.zeros((table_slots, 2), np.uint32)
    slots = cell_remap[ucells].astype(np.int64) * stride + code_remap[ucodes]
    table[slots, 0] = starts.astype(np.uint32)
    table[slots, 1] = counts.astype(np.uint32)
    return table, cell_remap, code_remap, np.asarray([stride], np.int32)


def tuned_config(config, report: DBBuildReport):
    """Return ``config`` with the bucket cap fitted to this DB (no silent
    truncation, minimal padded probe work)."""
    caps = dataclasses.replace(
        config.caps, bucket_cap=report.suggested_bucket_cap
    )
    return config.replace(caps=caps)


# On-disk .npz format version. Version 2 = the packed2/(T, 2)-bucket-table
# layout (round 3); files written before the version tag existed (and before
# the layout change) fail loading with a clear rebuild message instead of a
# bare KeyError (ADVICE r3).
DB_FORMAT_VERSION = 2


def save_database(path: str, db: DescriptorDB) -> None:
    np.savez_compressed(
        path,
        format_version=np.int32(DB_FORMAT_VERSION),
        **{k: np.asarray(v) for k, v in db._asdict().items()},
    )


_FIELD_DEFAULTS = {
    "bucket_table": np.zeros(0, np.uint32),
    "cell_remap": np.zeros(0, np.int32),
    "code_remap": np.zeros(0, np.int32),
    "table_stride": np.ones(1, np.int32),
}


def load_database(path: str) -> DescriptorDB:
    z = np.load(path)
    version = int(z["format_version"]) if "format_version" in z else 1
    missing = [
        k for k in DescriptorDB._fields if k not in z and k not in _FIELD_DEFAULTS
    ]
    if version != DB_FORMAT_VERSION or missing:
        raise ValueError(
            f"{path}: descriptor-DB file format v{version} "
            f"(missing fields: {missing or 'none'}) is incompatible with "
            f"this build (v{DB_FORMAT_VERSION}, packed2/(T,2)-table layout) "
            "— rebuild the map DB with `sgtd_tpu build-map` / save_database"
        )
    return DescriptorDB(
        **{
            k: jnp.asarray(z[k] if k in z else _FIELD_DEFAULTS[k])
            for k in DescriptorDB._fields
        }
    )
