"""Dynamic Curved-Voxel Clustering (DCVC) as a fixed-shape tensor program.

JAX re-design of the reference ``clusterManager``
(src/sgtd/include/cluster_manager.hpp:137-421). The reference builds a
polar-voxel hash map and propagates labels with a sequential union-find-ish
sweep (its hot loop, SURVEY.md 3.1), and is invoked once per semantic class
(get_json.cpp:160-226); here one fused pass clusters every class at once:

  1. cartesian -> (range, pitch, azimuth) conversion with the reference's
     gates (0.5 m < r < 120 m, cluster_manager.hpp:198),
  2. curved-voxel indices: radial bins of shrinking width
     bound_k = minPolar + k*startR - deltaR*k(k+1)/2
     (the closed form of the ``range += startR - step*deltaR`` loop,
     cluster_manager.hpp:214-220), pitch/azimuth bins of deltaP/deltaA deg;
     the per-point ``group`` id (semantic class) is packed into the voxel id,
     so clusters can never span classes — equivalent to the reference's
     per-class invocation but one kernel for the whole scan,
  3. occupied-voxel extraction by sort/unique,
  4. 26-connected components over occupied voxels via iterated min-label
     propagation with pointer jumping (converges in O(log diameter) sweeps,
     every sweep fully parallel — SURVEY.md hard-part (e)),
  5. per-cluster size filter (>= min_seg points, cluster_manager.hpp:408-409,
     with per-group thresholds) and centroid/density extraction.

Azimuth neighbours wrap around 360 deg like the reference's ``ax < 0`` case
(cluster_manager.hpp:374-377); the reference's asymmetric ``ax > 300`` clamp
is a bug we do not reproduce (it only mislinks the last azimuth column).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sgtd_tpu.config import DcvcConfig

_I32_MAX = np.int32(2**31 - 1)

# Packing strides for voxel ids: pitch < 128, polar < 512, azimuth < 512,
# group (semantic class) < 32: 7+9+9+5 = 30 bits.
_PITCH_MAX = 128
_POLAR_MAX = 512
_POLAR_STRIDE = _PITCH_MAX
_AZ_STRIDE = _POLAR_MAX * _PITCH_MAX
_GROUP_STRIDE = 512 * _AZ_STRIDE
_GROUP_MAX = 32


class ClusterResult(NamedTuple):
    """Padded clustering output.

    point_cluster: (N,) int32 — cluster slot per point (-1 = unclustered).
    centroids:     (C, 3) float32.
    counts:        (C,) int32 — points per cluster.
    density:       (C,) float32 — mean squared distance to centroid
                   (ref get_json.cpp:278-284).
    group:         (C,) int32 — the group (semantic class) of the cluster.
    valid:         (C,) bool — count >= the cluster's min_seg.
    """

    point_cluster: jnp.ndarray
    centroids: jnp.ndarray
    counts: jnp.ndarray
    density: jnp.ndarray
    group: jnp.ndarray
    valid: jnp.ndarray


# 26-neighbourhood offsets (excluding self) over (azimuth, polar, pitch).
_NEIGH = np.array(
    [
        (a, p, t)
        for a in (-1, 0, 1)
        for p in (-1, 0, 1)
        for t in (-1, 0, 1)
        if (a, p, t) != (0, 0, 0)
    ],
    dtype=np.int32,
)


def _voxel_coords(points: jnp.ndarray, mask: jnp.ndarray, cfg: DcvcConfig):
    """Point -> (azimuth, polar, pitch) integer voxel coordinates."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = jnp.linalg.norm(points, axis=-1)
    r_safe = jnp.maximum(r, 1e-6)
    pitch = jnp.rad2deg(jnp.arcsin(jnp.clip(z / r_safe, -1.0, 1.0)))
    az = jnp.rad2deg(jnp.arctan2(y, x))
    az = jnp.where(az < 0, az + 360.0, az)

    ok = mask & (r > cfg.min_range) & (r < cfg.max_range)

    big = jnp.float32(1e9)
    min_pitch = jnp.min(jnp.where(ok, pitch, big))
    min_polar = jnp.min(jnp.where(ok, r, big))

    # Radial bin: searchsorted over the closed-form shrinking bin bounds
    # bound_k = min_polar + (k+1)*startR - deltaR*(k+1)(k+2)/2.
    k_max = _POLAR_MAX
    ks = jnp.arange(1, k_max + 1, dtype=jnp.float32)
    bounds = min_polar + ks * cfg.start_r - cfg.delta_r * ks * (ks + 1) / 2.0
    polar_idx = jnp.searchsorted(bounds, r, side="right").astype(jnp.int32)
    polar_idx = jnp.clip(polar_idx, 0, k_max - 1)

    pitch_idx = jnp.round((pitch - min_pitch) / cfg.delta_p).astype(jnp.int32)
    az_idx = jnp.round(az / cfg.delta_a).astype(jnp.int32)
    width = jnp.int32(round(360.0 / cfg.delta_a) + 1)
    az_idx = jnp.clip(az_idx, 0, width - 1)
    pitch_idx = jnp.clip(pitch_idx, 0, _PITCH_MAX - 1)
    return az_idx, polar_idx, pitch_idx, ok, width


def _pack(az, polar, pitch):
    return az * _AZ_STRIDE + polar * _POLAR_STRIDE + pitch


@functools.partial(jax.jit, static_argnames=("cfg",))
def dcvc_cluster(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    min_seg: jnp.ndarray | int,
    cfg: DcvcConfig = DcvcConfig(),
    group: jnp.ndarray | None = None,
) -> ClusterResult:
    """Cluster the masked points of one scan.

    points: (N, 3) float32 (padded); mask: (N,) bool; min_seg: minimum
    cluster size — a scalar, or per-point values (per-class thresholds,
    ref get_json.cpp:162-186); group: optional (N,) int32 in [0, 32) —
    points of different groups never join one cluster.
    """
    n = points.shape[0]
    v_max = min(cfg.max_voxels, n)
    c_max = cfg.max_clusters

    az, polar, pitch, ok, width = _voxel_coords(points, mask, cfg)
    if group is None:
        group = jnp.zeros(n, jnp.int32)
    g = jnp.clip(group.astype(jnp.int32), 0, _GROUP_MAX - 1)
    vid = jnp.where(
        ok, g * _GROUP_STRIDE + _pack(az, polar, pitch), _I32_MAX
    )  # (N,)

    # --- occupied voxels: sort + unique -> dense voxel slots. ---
    svid = jnp.sort(vid)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), svid[1:] != svid[:-1]]
    ) & (svid != _I32_MAX)
    upos = jnp.where(first, jnp.arange(n, dtype=jnp.int32), n)
    sel = jnp.sort(upos)[:v_max]
    uvid = jnp.where(sel < n, svid[jnp.minimum(sel, n - 1)], _I32_MAX)  # (V,)
    v_valid = uvid != _I32_MAX

    # Voxel slot of each point.
    pslot = jnp.searchsorted(uvid, vid).astype(jnp.int32)
    pslot = jnp.where(ok, jnp.minimum(pslot, v_max - 1), v_max - 1)

    # --- neighbour slots per occupied voxel (26-connectivity, same group). ---
    ug = uvid // _GROUP_STRIDE
    urest = uvid % _GROUP_STRIDE
    ua = urest // _AZ_STRIDE
    up = (urest % _AZ_STRIDE) // _POLAR_STRIDE
    ut = urest % _POLAR_STRIDE
    offs = jnp.asarray(_NEIGH)  # (26, 3)
    na = ua[:, None] + offs[None, :, 0]
    na = jnp.where(na < 0, width - 1, na)  # azimuth wrap (ref :375-376)
    na = jnp.where(na >= width, 0, na)
    np_ = up[:, None] + offs[None, :, 1]
    nt = ut[:, None] + offs[None, :, 2]
    coord_ok = (np_ >= 0) & (np_ < _POLAR_MAX) & (nt >= 0) & (nt < _PITCH_MAX)
    nvid = ug[:, None] * _GROUP_STRIDE + _pack(
        na, jnp.clip(np_, 0, _POLAR_MAX - 1), jnp.clip(nt, 0, _PITCH_MAX - 1)
    )
    nslot = jnp.searchsorted(uvid, nvid).astype(jnp.int32)  # (V, 26)
    nslot_c = jnp.minimum(nslot, v_max - 1)
    n_ok = coord_ok & v_valid[:, None] & (uvid[nslot_c] == nvid)
    nslot = jnp.where(n_ok, nslot_c, jnp.arange(v_max, dtype=jnp.int32)[:, None])

    # --- connected components: min-label propagation + pointer jumping. ---
    init = jnp.arange(v_max, dtype=jnp.int32)

    def body(state):
        label, _ = state
        neigh_min = jnp.min(label[nslot], axis=1)  # (V,)
        new = jnp.minimum(label, neigh_min)
        new = jnp.minimum(new, new[new])  # pointer jumping
        new = jnp.minimum(new, new[new])
        return new, jnp.any(new != label)

    def cond(state):
        return state[1]

    label, _ = jax.lax.while_loop(cond, body, (init, jnp.bool_(True)))

    # --- compact component roots into cluster slots, largest first. ---
    # Slots are shared by the whole scan (the reference allocates per class),
    # so rank components by point count — singleton noise components must not
    # crowd out real clusters.
    pcount_v = jax.ops.segment_sum(
        ok.astype(jnp.float32), pslot, num_segments=v_max
    )  # (V,) points per voxel
    root_pts = jax.ops.segment_sum(pcount_v, label, num_segments=v_max)  # (V,)
    is_root = (label == init) & v_valid
    root_score = jnp.where(is_root, root_pts, -1.0)
    top_score, top_root = jax.lax.top_k(root_score, c_max)  # (C,)
    slot_of_root = (
        jnp.full(v_max, -1, jnp.int32)
        .at[top_root]
        .set(jnp.where(top_score > 0, jnp.arange(c_max, dtype=jnp.int32), -1))
    )
    vox_cluster = jnp.where(v_valid, slot_of_root[label], -1)

    pc = jnp.where(ok, vox_cluster[pslot], -1)  # (N,)

    # --- per-cluster stats. ---
    seg = jnp.where(pc >= 0, pc, c_max)  # overflow bucket
    ones = jnp.where(pc >= 0, 1.0, 0.0)
    counts = jax.ops.segment_sum(ones, seg, num_segments=c_max + 1)[:c_max]
    sums = jax.ops.segment_sum(
        points * ones[:, None], seg, num_segments=c_max + 1
    )[:c_max]
    denom = jnp.maximum(counts, 1.0)[:, None]
    centroids = sums / denom
    sq = jax.ops.segment_sum(
        jnp.sum(points * points, axis=-1) * ones, seg, num_segments=c_max + 1
    )[:c_max]
    density = sq / denom[:, 0] - jnp.sum(centroids * centroids, axis=-1)
    cgroup = jax.ops.segment_max(
        jnp.where(pc >= 0, g, 0), seg, num_segments=c_max + 1
    )[:c_max]

    min_seg_arr = jnp.broadcast_to(
        jnp.asarray(min_seg, jnp.float32), (n,)
    )
    c_min_seg = jax.ops.segment_max(
        jnp.where(pc >= 0, min_seg_arr, 0.0), seg, num_segments=c_max + 1
    )[:c_max]
    valid = (counts >= jnp.maximum(c_min_seg, 1.0)) & (counts > 0)

    keep = jnp.where(pc >= 0, valid[jnp.maximum(pc, 0)], False)
    pc = jnp.where(keep, pc, -1)

    return ClusterResult(
        point_cluster=pc.astype(jnp.int32),
        centroids=centroids.astype(jnp.float32),
        counts=counts.astype(jnp.int32),
        density=jnp.maximum(density, 0.0).astype(jnp.float32),
        group=cgroup.astype(jnp.int32),
        valid=valid,
    )
