"""Multi-frame local-map keyframes (map densification).

JAX analog of the reference's ``local_map`` tool
(src/sgtd/src/local_map.cpp:213-482): for each keyframe, every scan whose
pose lies within ``radius`` (15 m there, :266) is transformed into the
keyframe's sensor frame (T_i^-1 T_j, :300) and merged before clustering —
the map variant behind the headline "SG-STD-gicp-multi" results
(BASELINE.md). Queries remain single scans.

Host-side orchestration (scan selection is data-dependent IO); the merged
cloud feeds the jitted ``build_graph`` like any single scan.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

import jax.numpy as jnp

from sgtd_tpu.config import CapacityConfig, DcvcConfig
from sgtd_tpu.graph.build import build_graph
from sgtd_tpu.graph.types import SemanticGraph


def neighbor_indices(
    poses: np.ndarray, center: int, radius_m: float
) -> np.ndarray:
    """Scans within radius of the centre keyframe (ref local_map.cpp:266-270)."""
    t = poses[:, :3, 3]
    d = np.linalg.norm(t - t[center, None], axis=-1)
    return np.nonzero(d < radius_m)[0]


def merge_scans(
    load_scan: Callable[[int], Tuple[np.ndarray, np.ndarray, np.ndarray]],
    poses: np.ndarray,
    center: int,
    neighbor_ids: Sequence[int],
    max_points: int,
    subsample_stride: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Merge neighbour scans into the centre frame.

    load_scan(j) -> (points (N,3), sem (N,), inst (N,)) in scan j's frame.
    Returns padded (points, sem, inst, mask) of size max_points; when the
    merge exceeds the cap, points are uniformly strided (reported via the
    mask count, never silently biased to one scan).
    """
    T_c_inv = np.linalg.inv(poses[center])
    pts_all, sem_all, inst_all = [], [], []
    for j in neighbor_ids:
        pts, sem, inst = load_scan(int(j))
        T = T_c_inv @ poses[j]
        pts_all.append(pts @ T[:3, :3].T + T[:3, 3])
        sem_all.append(sem)
        inst_all.append(inst)
    pts = np.concatenate(pts_all).astype(np.float32)
    sem = np.concatenate(sem_all).astype(np.int32)
    inst = np.concatenate(inst_all).astype(np.int32)
    if subsample_stride > 1:
        pts, sem, inst = pts[::subsample_stride], sem[::subsample_stride], inst[::subsample_stride]
    if len(pts) > max_points:
        stride = -(-len(pts) // max_points)
        pts, sem, inst = pts[::stride], sem[::stride], inst[::stride]
    n = len(pts)
    pad = max_points - n
    mask = np.zeros(max_points, bool)
    mask[:n] = True
    return (
        np.pad(pts, ((0, pad), (0, 0))),
        np.pad(sem, (0, pad)),
        np.pad(inst, (0, pad)),
        mask,
    )


def build_local_map_graphs(
    load_scan: Callable[[int], Tuple[np.ndarray, np.ndarray, np.ndarray]],
    poses: np.ndarray,
    radius_m: float = 15.0,
    caps: CapacityConfig = CapacityConfig(),
    dcvc: DcvcConfig = DcvcConfig(),
    keyframe_ids: Sequence[int] | None = None,
) -> List[SemanticGraph]:
    """Densified keyframe graphs for the whole trajectory."""
    n = poses.shape[0]
    ids = list(keyframe_ids) if keyframe_ids is not None else list(range(n))
    out = []
    for i in ids:
        nb = neighbor_indices(poses, i, radius_m)
        pts, sem, inst, mask = merge_scans(
            load_scan, poses, i, nb, dcvc.max_points
        )
        out.append(
            build_graph(
                jnp.asarray(pts),
                jnp.asarray(sem),
                jnp.asarray(inst),
                jnp.asarray(mask),
                poses[i].astype(np.float32),
                caps,
                dcvc,
            )
        )
    return out
