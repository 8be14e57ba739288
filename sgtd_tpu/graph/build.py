"""Labeled point cloud -> semantic instance graph (jittable).

JAX re-design of the reference's per-scan graph builder ``gen_labels``
+ ``gen_graphs`` (src/sgtd/src/get_json.cpp:41-343). Class routing matches the
reference exactly (train-id label space, the spvnas/SemanticKITTI remap):

  * class 10 (sidewalk): kept whole as a single instance
    (get_json.cpp:120-136; class 9/parking is also kept whole there but is
    dropped at graph stage since it has no node remap, :295);
  * dynamic/unusable classes 0,1,2,3,6,7,8,14,19 dropped (:137); classes 4,5
    cluster to node label 0 in the reference and are likewise dropped
    (:10-12, 287-293) — we skip clustering them for the same outcome;
  * remaining classes (11,12,13,15,16,17,18): split by ground-truth instance
    ids when present (> 20 points per instance, :138-159), otherwise
    DCVC-clustered with per-class min segment sizes (:160-226: min_seg 5 for
    trunk/pole/traffic-sign {15,17,18}, 300 else);
  * node labels remapped via node_map {10:3, 11:4, ..., 18:11}, kept when in
    [3, 12] (:287-293); attributes: centroid + density (:266-293).

Where the reference loops classes and re-runs DCVC per class, the whole scan
is ONE clustering pass: the class id is packed into the curved-voxel key so
components never span classes, and GT-instance splitting is one grouping pass
keyed by (class, instance).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sgtd_tpu.cluster.dcvc import ClusterResult, dcvc_cluster
from sgtd_tpu.config import CapacityConfig, DcvcConfig
from sgtd_tpu.graph.types import SemanticGraph

_I32_MAX = np.int32(2**31 - 1)

GT_MIN_POINTS = 20


@dataclasses.dataclass(frozen=True)
class ClassRouting:
    """Static per-dataset class routing (hashable for jit)."""

    whole_classes: Tuple[int, ...]
    instance_classes: Tuple[int, ...]
    min_seg: Tuple[Tuple[int, int], ...]  # (class, min_seg) overrides
    default_min_seg: int
    node_map: Tuple[Tuple[int, int], ...]
    keep_lo: int
    keep_hi: int

    def tables(self):
        is_inst = np.zeros(32, dtype=bool)
        min_seg = np.zeros(32, dtype=np.float32)
        node_label = np.full(32, -1, dtype=np.int32)
        overrides = dict(self.min_seg)
        for c in self.instance_classes:
            is_inst[c] = True
            min_seg[c] = overrides.get(c, self.default_min_seg)
        for c, v in self.node_map:
            node_label[c] = v
        return is_inst, min_seg, node_label


# MulRan/SemanticKITTI train-id routing (ref get_json.cpp, module docstring).
MULRAN_ROUTING = ClassRouting(
    whole_classes=(10,),
    instance_classes=(11, 12, 13, 15, 16, 17, 18),
    min_seg=((15, 5), (17, 5), (18, 5)),
    default_min_seg=300,
    node_map=((10, 3), (11, 4), (12, 5), (13, 6), (14, 7), (15, 8), (16, 9), (17, 10), (18, 11)),
    keep_lo=3,
    keep_hi=12,
)

# Wild-Places forests routing (ref get_json_wild.cpp:10-31,119-180): 13
# remapped classes; class 1 (dirt) kept whole; sky/water already remapped to
# 255; tree-foliage (11) dropped; others DCVC with min 100; identity node map.
WILD_ROUTING = ClassRouting(
    whole_classes=(1,),
    instance_classes=(0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12),
    min_seg=(),
    default_min_seg=100,
    node_map=tuple((c, c) for c in range(13)),
    keep_lo=0,
    keep_hi=12,
)

# Back-compat module constants (MulRan profile).
WHOLE_CLASSES = MULRAN_ROUTING.whole_classes
INSTANCE_CLASSES = MULRAN_ROUTING.instance_classes
NODE_MAP = dict(MULRAN_ROUTING.node_map)


def _group_by_key(
    points: jnp.ndarray,
    key: jnp.ndarray,
    c_max: int,
    min_pts: float,
):
    """Group masked points by an int32 key (key == I32_MAX -> ignored).

    Returns (point_cluster (N,), centroids (C,3), counts (C,), density (C,),
    ukey (C,), valid (C,)).
    """
    n = points.shape[0]
    skey = jnp.sort(key)
    first = jnp.concatenate([jnp.ones((1,), bool), skey[1:] != skey[:-1]]) & (
        skey != _I32_MAX
    )
    upos = jnp.where(first, jnp.arange(n, dtype=jnp.int32), n)
    sel = jnp.sort(upos)[:c_max]
    ukey = jnp.where(sel < n, skey[jnp.minimum(sel, n - 1)], _I32_MAX)

    slot = jnp.searchsorted(ukey, key).astype(jnp.int32)
    pc = jnp.where((key != _I32_MAX) & (slot < c_max), slot, -1)

    seg = jnp.where(pc >= 0, pc, c_max)
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
    density = jnp.maximum(sq / denom[:, 0] - jnp.sum(centroids**2, axis=-1), 0.0)
    valid = (counts > min_pts) & (ukey != _I32_MAX)
    return pc, centroids, counts, density, ukey, valid


@functools.partial(jax.jit, static_argnames=("caps", "dcvc", "routing"))
def build_graph_arrays(
    points: jnp.ndarray,
    sem: jnp.ndarray,
    inst: jnp.ndarray,
    mask: jnp.ndarray,
    caps: CapacityConfig = CapacityConfig(),
    dcvc: DcvcConfig = DcvcConfig(),
    routing: ClassRouting = MULRAN_ROUTING,
):
    """Cluster one labeled scan into padded node arrays.

    points: (N, 3) float32; sem/inst: (N,) int32 (train-id semantics and raw
    instance ids); mask: (N,) bool for padding.
    Returns (centers (M, 3), labels (M,), density (M,), node_mask (M,)).
    """
    n = points.shape[0]
    is_inst_tab, min_seg_tab, node_label_tab = routing.tables()
    sem_c = jnp.clip(sem, 0, 31)
    is_inst_class = jnp.asarray(is_inst_tab)[sem_c] & mask
    min_seg_lut = jnp.asarray(min_seg_tab)
    node_label_lut = jnp.asarray(node_label_tab)

    # Which classes have GT instance ids in this scan? (ref :138)
    has_inst_point = is_inst_class & (inst != 0)
    class_has_inst = jax.ops.segment_max(
        has_inst_point.astype(jnp.int32), sem_c, num_segments=32
    ).astype(bool)
    use_gt = class_has_inst[sem_c] & is_inst_class

    # --- one DCVC pass over every instance class without GT ids. ---
    dcvc_res: ClusterResult = dcvc_cluster(
        points,
        is_inst_class & ~use_gt,
        min_seg_lut[sem_c],
        dcvc,
        group=sem_c,
    )
    dcvc_labels = node_label_lut[jnp.clip(dcvc_res.group, 0, 31)]

    # --- one grouping pass over (class, instance) for GT-labelled classes ---
    gt_key = jnp.where(
        use_gt, sem_c * 65536 + jnp.clip(inst, 0, 65535), _I32_MAX
    )
    _, gt_cent, gt_cnt, gt_den, gt_ukey, gt_valid = _group_by_key(
        points, gt_key, dcvc.max_clusters, float(GT_MIN_POINTS)
    )
    gt_labels = node_label_lut[jnp.clip(gt_ukey // 65536, 0, 31)]

    # --- whole-kept classes: one instance from all points of the class. ---
    whole = []
    node_map = dict(routing.node_map)
    for c in routing.whole_classes:
        cmask = mask & (sem_c == c)
        cnt = jnp.sum(cmask.astype(jnp.float32))
        denom = jnp.maximum(cnt, 1.0)
        centroid = jnp.sum(jnp.where(cmask[:, None], points, 0.0), axis=0) / denom
        sq = jnp.sum(jnp.where(cmask, jnp.sum(points**2, -1), 0.0)) / denom
        density = jnp.maximum(sq - jnp.sum(centroid**2), 0.0)
        whole.append(
            (
                centroid[None],
                jnp.full((1,), node_map[c], jnp.int32),
                density[None],
                (cnt > 0)[None],
            )
        )

    centers = jnp.concatenate(
        [w[0] for w in whole] + [dcvc_res.centroids, gt_cent]
    )
    labels = jnp.concatenate([w[1] for w in whole] + [dcvc_labels, gt_labels])
    density = jnp.concatenate([w[2] for w in whole] + [dcvc_res.density, gt_den])
    valid = jnp.concatenate([w[3] for w in whole] + [dcvc_res.valid, gt_valid])

    # Node labels must land in the keep range (ref :288).
    valid = valid & (labels >= routing.keep_lo) & (labels <= routing.keep_hi)

    # Compact to max_nodes, preserving (source, cluster-slot) order.
    m = caps.max_nodes
    total = valid.shape[0]
    prio = jnp.where(valid, jnp.arange(total, dtype=jnp.int32), total)
    sel = jnp.argsort(prio)[:m]
    node_mask = prio[sel] < total
    return (
        jnp.where(node_mask[:, None], centers[sel], 0.0),
        jnp.where(node_mask, labels[sel], 0),
        jnp.where(node_mask, density[sel], 0.0),
        node_mask,
    )


def build_graph(
    points: jnp.ndarray,
    sem: jnp.ndarray,
    inst: jnp.ndarray,
    mask: jnp.ndarray,
    pose: jnp.ndarray,
    caps: CapacityConfig = CapacityConfig(),
    dcvc: DcvcConfig = DcvcConfig(),
    routing: ClassRouting = MULRAN_ROUTING,
) -> SemanticGraph:
    centers, labels, density, node_mask = build_graph_arrays(
        points, sem, inst, mask, caps, dcvc, routing
    )
    return SemanticGraph(
        centers=centers,
        labels=labels,
        density=density,
        mask=node_mask,
        pose=jnp.asarray(pose, jnp.float32),
    )
