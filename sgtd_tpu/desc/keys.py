"""Geometric-hash key generation for triangle descriptors.

JAX replacement for the reference's ``STDesc_LOC`` open hash keys
(src/sgtd/include/desc/STDesc.h:217-250) and the 12-bit semantic packing
``Combinatorial_Binary_Encoding`` (src/sgtd/src/STDesc.cpp:3-16): instead of
an unordered_map we pack (x, y, z, label-code) into a single sortable int32
so the database becomes a sorted dense table probed with ``searchsorted``.

Key semantics match the reference:
  * DB insertion quantises with round-half-up: x = int(side + 0.5)
    (STDesc.cpp:155-157).
  * Query probing quantises with C truncation over the 27-neighbourhood:
    x = (int)(side + dx), dx in {-1, 0, 1} (STDesc.cpp:359-361), gated by
    ||sides - (voxel + 0.5)|| < 1.5 (STDesc.cpp:366-369).
  * The label triple is packed injectively; the exact packing function
    differs from the reference's 4-bit concatenation but induces the same
    bucket partition (labels are the remapped node classes 0..12, so base-13
    packing is a bijection of the reference's encoding on its domain).

int32 budget: keys are ((x * X + y) * X + z) * 2197 + code13 with
X = floor(max_len * scale) + 2. The default config (max_len=50, resolution=1)
gives X = 52 -> max key 3.1e8 < 2^31. ``validate_key_space`` rejects configs
that would overflow.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from sgtd_tpu.config import DescriptorConfig

_N_CODES = 13 * 13 * 13  # 2197


def key_extent(cfg: DescriptorConfig) -> int:
    """Number of quantised side-length cells per axis."""
    return int(np.floor(cfg.max_len * cfg.scale)) + 2


def validate_key_space(cfg: DescriptorConfig) -> int:
    x = key_extent(cfg)
    max_key = x * x * x * _N_CODES
    if max_key >= 2**31:
        raise ValueError(
            f"descriptor key space {max_key} overflows int32; use a coarser "
            f"std_side_resolution (max_len*scale must stay <= ~96 cells)"
        )
    return x


def pack_label_code(labels) -> jnp.ndarray:
    """Injective base-13 packing of the (A, B, C) vertex label triple.

    Same role as Combinatorial_Binary_Encoding (STDesc.cpp:3-16); bijective
    with it on the node-label domain 0..12.
    """
    l = jnp.clip(labels.astype(jnp.int32), 0, 12)
    return (l[..., 0] * 13 + l[..., 1]) * 13 + l[..., 2]


def pack_key(x, y, z, code, extent: int) -> jnp.ndarray:
    x = jnp.clip(x, 0, extent - 1)
    y = jnp.clip(y, 0, extent - 1)
    z = jnp.clip(z, 0, extent - 1)
    return ((x * extent + y) * extent + z) * _N_CODES + code


def db_keys(sides: jnp.ndarray, labels: jnp.ndarray, cfg: DescriptorConfig) -> jnp.ndarray:
    """Insertion keys: round-half-up quantisation (ref STDesc.cpp:155-161)."""
    extent = key_extent(cfg)
    q = jnp.floor(sides + 0.5).astype(jnp.int32)
    code = pack_label_code(labels)
    return pack_key(q[..., 0], q[..., 1], q[..., 2], code, extent)


_OFFSETS = np.stack(
    np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"), axis=-1
).reshape(27, 3)


def probe_cells(
    sides: jnp.ndarray, labels: jnp.ndarray, cfg: DescriptorConfig
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Query cells over the 27-voxel neighbourhood + the 1.5-cell gate.

    Returns (cells (..., 27) int32 flat cell ids for the direct-addressed
    cell table, code (...,) int32 packed label triple, gate (..., 27) bool).
    Same probe semantics as :func:`probe_keys` but split into the (cell,
    code) pair the sorted DB is laid out by.
    """
    extent = key_extent(cfg)
    offs = jnp.asarray(_OFFSETS, dtype=jnp.float32)  # (27, 3)
    voxel = jnp.trunc(sides[..., None, :] + offs).astype(jnp.int32)
    center = voxel.astype(jnp.float32) + 0.5
    gate = jnp.linalg.norm(sides[..., None, :] - center, axis=-1) < 1.5
    v = jnp.clip(voxel, 0, extent - 1)
    cells = (v[..., 0] * extent + v[..., 1]) * extent + v[..., 2]
    return cells, pack_label_code(labels), gate


def probe_keys(
    sides: jnp.ndarray, labels: jnp.ndarray, cfg: DescriptorConfig
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Query keys over the 27-voxel neighbourhood plus the 1.5-cell gate.

    Returns (keys (..., 27) int32, gate (..., 27) bool). Mirrors the probe
    loop at STDesc.cpp:358-369: voxel = trunc(side + offset), and the probe
    is only taken when ||sides - (voxel + 0.5)|| < 1.5.
    """
    extent = key_extent(cfg)
    offs = jnp.asarray(_OFFSETS, dtype=jnp.float32)  # (27, 3)
    voxel = jnp.trunc(sides[..., None, :] + offs).astype(jnp.int32)  # (..., 27, 3)
    center = voxel.astype(jnp.float32) + 0.5
    gate = (
        jnp.linalg.norm(sides[..., None, :] - center, axis=-1) < 1.5
    )  # (..., 27)
    code = pack_label_code(labels)[..., None]
    keys = pack_key(voxel[..., 0], voxel[..., 1], voxel[..., 2], code, extent)
    return keys, gate
