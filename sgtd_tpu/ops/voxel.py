"""Voxel-grid centroid downsampling.

JAX analog of the PCL ``ApproximateVoxelGrid`` the reference applies
to the query cloud before GICP (leaf_size knob,
src/sgtd/src/semantic_graph_localization.cpp:357-359, 654-662): points are
binned by floor(p / leaf) and replaced by per-voxel centroids.

Deviation (an improvement): PCL's *Approximate* variant hashes voxels into a
small fixed table and MERGES distinct voxels on hash collisions; this
implementation is the exact voxel grid (sort + segment-mean over voxel keys,
the same machinery as the NDT / Gaussian voxel maps).

Two variants: a jittable fixed-shape one for on-device pipelines and a
host-side NumPy one for IO loaders.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_I64_MAX = np.int64(2**62)
_B = np.int64(1) << 20  # coordinate offset; 21 bits per axis


def _keys_np(points: np.ndarray, leaf: float) -> np.ndarray:
    c = np.floor(points / leaf).astype(np.int64)
    return ((c[:, 0] + _B) << 42) | ((c[:, 1] + _B) << 21) | (c[:, 2] + _B)


def voxel_downsample_np(
    points: np.ndarray, leaf_size: float
) -> np.ndarray:
    """Host-side exact voxel-grid centroids: (N, 3) -> (V, 3)."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    if pts.shape[0] == 0:
        return pts
    key = _keys_np(pts, leaf_size)
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.zeros((uniq.shape[0], 3), np.float64)
    np.add.at(sums, inv, pts)
    cnt = np.bincount(inv, minlength=uniq.shape[0]).astype(np.float64)
    return (sums / cnt[:, None]).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("max_out",))
def voxel_downsample(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    leaf_size,
    max_out: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Jittable voxel-grid centroids.

    points (N, 3) + mask (N,) -> (centroids (max_out, 3), out_mask
    (max_out,)). Voxels beyond ``max_out`` (in key order) are dropped;
    callers size max_out >= the expected voxel count (N is always safe).
    """
    # int32 packing, 10 bits per axis (JAX default disables int64): supports
    # |voxel coord| < 512, i.e. ranges up to 512 * leaf_size metres — beyond
    # any LiDAR range gate at practical leaf sizes.
    stride = 1024
    i32_max = np.int32(2**31 - 1)
    c = jnp.clip(
        jnp.floor(points / leaf_size).astype(jnp.int32) + stride // 2,
        0, stride - 1,
    )
    key = (c[:, 0] * stride + c[:, 1]) * stride + c[:, 2]
    key = jnp.where(mask, key, i32_max)

    order = jnp.argsort(key)
    skey = key[order]
    spts = points[order]
    first = jnp.concatenate(
        [jnp.ones((1,), bool), skey[1:] != skey[:-1]]
    ) & (skey != i32_max)
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1  # (N,) voxel id, -1 pad
    seg_c = jnp.where((seg >= 0) & (seg < max_out) & (skey != i32_max),
                      seg, max_out)
    ones = (seg_c < max_out).astype(jnp.float32)
    cnt = jax.ops.segment_sum(ones, seg_c, num_segments=max_out + 1)[:max_out]
    s = jax.ops.segment_sum(
        spts * ones[:, None], seg_c, num_segments=max_out + 1
    )[:max_out]
    out_mask = cnt > 0
    centroids = s / jnp.maximum(cnt, 1.0)[:, None]
    return jnp.where(out_mask[:, None], centroids, 0.0), out_mask


def load_query_cloud(
    points: np.ndarray,
    leaf_size: float,
    max_points: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference query-cloud preprocessing for GICP
    (semantic_graph_localization.cpp:654-662): drop near-origin invalid
    points (||p||^2 < 1e-3), voxel-downsample at leaf_size, pad to a fixed
    shape. Returns (cloud (max_points, 3) float32, mask (max_points,))."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    pts = pts[np.sum(pts * pts, axis=1) >= 1e-3]
    if leaf_size > 0:
        pts = voxel_downsample_np(pts, leaf_size)
    n = min(len(pts), max_points)
    if len(pts) > max_points:
        # Deterministic thinning (the reference relies on leaf_size alone;
        # the static shape needs a hard cap).
        stride = -(-len(pts) // max_points)
        pts = pts[::stride][:max_points]
        n = len(pts)
    out = np.zeros((max_points, 3), np.float32)
    m = np.zeros(max_points, bool)
    out[:n] = pts[:n]
    m[:n] = True
    return out, m
