"""Multi-device Schur-complement bundle adjustment.

The round-1 BA module promised that "the reduced system S is exactly what a
multi-host deployment psum-reduces across observation shards"
(sgtd_tpu/backend/ba.py docstring); this module is that deployment. The
observation table (and the landmarks it references) shards over a mesh axis;
keyframe poses — the small, globally-coupled state — stay replicated:

  per shard: linearize local observations         (L/D, O, ...) blocks
  -> psum reduced gradient g and the PCG matvec   (F, 6) vectors across devices
  -> identical preconditioned-CG solve on every shard (replicated dp)
  -> local landmark back-substitution             (L/D, 3), no comm

Per-step communication is O(F * 6) per CG iteration — independent of the
landmark/observation count, which is the axis that grows with map size.
The matrix-free matvec comes from backend.ba (`_schur_matvec`); S is never
materialized, so the same program handles thousands of keyframes.

Numerics: psum-reduced gradients/matvecs sum in a different association
order than the single-device scatter-adds, so results match the unsharded
``optimize_ba_cg`` to float tolerance (not bit-exactly).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from sgtd_tpu.backend.ba import (
    BAProblem,
    BAResult,
    _anchor_weights,
    _ba_blocks,
    _back_substitute,
    _diag_blocks,
    _reduced_gradient,
    _schur_matvec,
)
from sgtd_tpu.geom import se3


def optimize_ba_sharded(
    ba: BAProblem,
    mesh: Mesh,
    axis: str = "obs",
    iterations: int = 10,
    damping: float = 1e-5,
    cg_iterations: int = 100,
) -> BAResult:
    """Sharded matrix-free Schur BA. Landmark count must divide the axis
    size (pad with obs_valid=False rows otherwise)."""
    n_dev = mesh.shape[axis]
    l_n = ba.landmarks.shape[0]
    if l_n % n_dev:
        raise ValueError(
            f"landmark count {l_n} must divide the '{axis}' axis ({n_dev}); "
            "pad with obs_valid=False rows"
        )
    f_n = ba.poses.shape[0]

    def run(poses, anchor, lms, obs_frame, obs_local, obs_valid):
        ba_local = BAProblem(
            poses=poses, landmarks=lms, obs_frame=obs_frame,
            obs_local=obs_local, obs_valid=obs_valid, anchor=anchor,
        )

        def step(carry, _):
            poses, lms = carry
            b = _ba_blocks(poses, lms, ba_local, damping)
            cost = jax.lax.psum(b.cost, axis)
            g = jax.lax.psum(
                _reduced_gradient(b, obs_frame, f_n), axis
            )
            anchor_w = _anchor_weights(ba_local, damping, poses.dtype)
            # Local diagonal blocks carry no anchor term (it must be added
            # once globally, not once per shard).
            zero_w = jnp.zeros(f_n, poses.dtype)
            D = jax.lax.psum(_diag_blocks(b, obs_frame, zero_w, f_n), axis)
            D = D + anchor_w[:, None, None] * jnp.eye(6, dtype=poses.dtype)
            D_inv = jnp.linalg.inv(D)

            def matvec(x):
                y = jax.lax.psum(
                    _schur_matvec(b, obs_frame, zero_w, x), axis
                )
                return y + anchor_w[:, None] * x

            precond = lambda x: jnp.einsum("fij,fj->fi", D_inv, x)
            dp, _ = jax.scipy.sparse.linalg.cg(
                matvec, -g, tol=1e-8, maxiter=cg_iterations, M=precond
            )
            dl = _back_substitute(b, obs_frame, dp)  # local, no comm
            return (poses @ se3.se3_exp(dp), lms + dl), cost

        (poses, lms), costs = jax.lax.scan(
            step, (poses, lms), None, length=iterations
        )
        return poses, lms, costs

    sharded = shard_map(
        run,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(axis), P()),
        check_vma=False,
    )
    poses, lms, costs = jax.jit(sharded)(
        ba.poses, ba.anchor, ba.landmarks,
        ba.obs_frame, ba.obs_local, ba.obs_valid,
    )
    return BAResult(poses=poses, landmarks=lms, costs=costs)
