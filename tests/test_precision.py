"""Static checks on the traced main-path programs.

Every float32 dot_general in localize_refined, build_descriptors and
gicp_rerank must request HIGHEST precision: at default precision a GPU
may run it in TF32, which loses centimetres on metric coordinates. And no
Pallas kernel in them may run in interpret mode.
"""

import functools

import numpy as np
import jax
import jax.extend.core
import jax.numpy as jnp
import pytest

from sgtd_tpu.config import GicpConfig
from sgtd_tpu.data.synthetic import make_map_and_queries
from sgtd_tpu.db.database import build_database
from sgtd_tpu.desc.triangles import build_descriptors
from sgtd_tpu.match.pipeline import localize_refined
from sgtd_tpu.refine.gicp import gicp_rerank

_PTS = 64  # cloud size: shapes only need to be valid


def _subjaxprs(params):
    for v in params.values():
        for item in v if isinstance(v, (list, tuple)) else (v,):
            if isinstance(item, jax.extend.core.ClosedJaxpr):
                yield item.jaxpr
            elif isinstance(item, jax.extend.core.Jaxpr):
                yield item


def _eqns(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for sub in _subjaxprs(eqn.params):
            yield from _eqns(sub)


def _is_highest(precision) -> bool:
    if precision is None:
        return False
    ps = precision if isinstance(precision, tuple) else (precision, precision)
    return all(p == jax.lax.Precision.HIGHEST for p in ps)


@pytest.fixture(scope="module")
def world(small_config):
    cfg = small_config.replace(gicp=GicpConfig(enable=True, max_iterations=2))
    maps, queries, _ = make_map_and_queries(
        cfg, seed=5, num_map_frames=4, num_queries=1
    )
    descs = [build_descriptors(g, cfg.desc, cfg.caps) for g in maps]
    db, _ = build_database(
        descs, [np.asarray(g.pose) for g in maps], cfg.desc, cfg.caps
    )
    return cfg, db, queries[0]


def _program(name, world):
    cfg, db, graph = world
    f = db.frame_poses.shape[0]
    cloud = jnp.zeros((_PTS, 3), jnp.float32)
    mask = jnp.ones((_PTS,), bool)
    if name == "localize_refined":
        fn = functools.partial(localize_refined, config=cfg, rerank_k=2)
        args = (
            db, graph, cloud, mask,
            jnp.zeros((f, _PTS, 3), jnp.float32),
            jnp.ones((f, _PTS), bool),
            jnp.tile(jnp.eye(3, dtype=jnp.float32), (f, _PTS, 1, 1)),
        )
    elif name == "build_descriptors":
        fn = functools.partial(build_descriptors, cfg=cfg.desc, caps=cfg.caps)
        args = (graph,)
    else:
        fn = functools.partial(gicp_rerank, cfg=cfg.gicp)
        args = (
            cloud, mask, jnp.zeros((2, _PTS, 3), jnp.float32),
            jnp.ones((2, _PTS), bool), jnp.tile(jnp.eye(4), (2, 1, 1)),
        )
    return jax.make_jaxpr(fn)(*args).jaxpr


PROGRAMS = ["localize_refined", "build_descriptors", "gicp_rerank"]


@pytest.mark.parametrize("name", PROGRAMS)
def test_f32_dots_are_highest_precision(name, world):
    dots = [
        e for e in _eqns(_program(name, world))
        if e.primitive.name == "dot_general"
        and e.invars[0].aval.dtype == jnp.float32
    ]
    if name != "build_descriptors":
        assert dots, "expected pose/coordinate products in the program"
    bad = [str(e) for e in dots if not _is_highest(e.params["precision"])]
    assert not bad, "\n".join(bad)


def test_no_pallas_kernel_in_interpret_mode(world):
    calls = [
        e for name in PROGRAMS for e in _eqns(_program(name, world))
        if e.primitive.name == "pallas_call"
    ]
    assert not [e for e in calls if e.params.get("interpret")]
