"""Levenberg-Marquardt / Gauss-Newton stepping on SE(3), shared by the
registration engines (GICP / VGICP / NDT).

JAX re-design of the reference's ``LsqRegistration`` optimizer
(src/sgtd/include/fast_gicp/gicp/impl/lsq_registration_impl.hpp:53-163):

  * ``step_gn``: one linearize + 6x6 solve per iteration (:106-120);
  * ``step_lm``: lambda trust region — lambda initialised to
    ``init_factor * max|diag H|`` on the first step (:128-130), inner loop
    solving (H + lambda I) d = -b, gain ratio
    ``rho = (y0 - yi) / d.(lambda d - b)`` (:142), rejection doubles
    lambda via nu, acceptance scales it by max(1/3, 1 - (2 rho - 1)^3)
    (:147-160);
  * convergence: elementwise ``max(|dR|/rot_eps, |dt|/trans_eps) < 1`` on
    the step's delta transform (:82-93).

The reference's early-exit loops become fixed-trip ``lax.scan`` with a
``done`` mask (SURVEY.md hard-part (d)): every iteration computes, converged
states stop updating. The engine supplies two callbacks:

  linearize(T) -> (H (6,6), g (6,), y0 (), aux)
      H = J^T M J, g = J^T M r accumulated over correspondences found at T
      (the reference's ``linearize``; correspondences live in ``aux``);
  error(T, aux) -> y ()
      cost at T re-using the correspondences/weights from ``aux`` — exactly
      like the reference's ``compute_error``, which reuses the Mahalanobis
      terms computed at linearization (fast_gicp_impl.hpp:118-155).

State convention: T <- se3_exp(d) @ T with d = [translation, rotation]
(the reference orders [rotation, translation]; the math is identical).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from sgtd_tpu.geom import se3
from sgtd_tpu.ops.linalg3 import HIGHEST, chol_solve6, matmul


class LsqResult(NamedTuple):
    transform: jnp.ndarray  # (4, 4)
    converged: jnp.ndarray  # () bool
    final_cost: jnp.ndarray  # () y at the last accepted linearization


def _is_converged(delta_T: jnp.ndarray, rot_eps: float, trans_eps: float):
    """lsq_registration_impl.hpp:82-93."""
    r = jnp.max(jnp.abs(delta_T[:3, :3] - jnp.eye(3, dtype=delta_T.dtype)))
    t = jnp.max(jnp.abs(delta_T[:3, 3]))
    return jnp.maximum(r / rot_eps, t / trans_eps) < 1.0


def gn_solve(
    linearize: Callable,
    T0: jnp.ndarray,
    *,
    max_iterations: int,
    rot_eps: float = 2e-3,
    trans_eps: float = 5e-4,
    damping: float = 1e-6,
) -> LsqResult:
    """Gauss-Newton (step_gn, lsq_registration_impl.hpp:106-120)."""
    eye6 = jnp.eye(6, dtype=T0.dtype)

    def cond(carry):
        i, T, done, y = carry
        # Early exit like the reference's `i < max_iterations_ &&
        # !converged_` (lsq_registration_impl.hpp:65); under vmap the
        # while_loop runs until every batched problem is done, so typical
        # 3-5-iteration convergences stop paying for the full trip count.
        return (i < max_iterations) & ~done

    def step(carry):
        i, T, done, y_last = carry
        H, g, y0, _ = linearize(T)
        # Unrolled SPD solve (ops.linalg3.chol_solve6) instead of
        # jnp.linalg.solve's pivoted-LU loop.
        d = chol_solve6(H + damping * eye6, -g)
        delta_T = se3.se3_exp(d)
        conv = _is_converged(delta_T, rot_eps, trans_eps)
        T_new = jnp.where(done, T, matmul(delta_T, T))
        y_new = jnp.where(done, y_last, y0)
        return (i + 1, T_new, done | conv, y_new)

    _, T, done, y = jax.lax.while_loop(
        cond, step,
        (jnp.int32(0), T0, jnp.asarray(False), jnp.asarray(jnp.inf, T0.dtype)),
    )
    return LsqResult(transform=T, converged=done, final_cost=y)


def lm_solve(
    linearize: Callable,
    error: Callable,
    T0: jnp.ndarray,
    *,
    max_iterations: int,
    lm_inner: int = 8,
    rot_eps: float = 2e-3,
    trans_eps: float = 5e-4,
    init_lambda_factor: float = 1e-9,
) -> LsqResult:
    """Levenberg-Marquardt (step_lm, lsq_registration_impl.hpp:123-163).

    ``lm_inner`` is the reference's ``lm_max_iterations_`` (default 10
    there; 8 here — each rejection doubles nu so lambda grows ~2^(k(k+1)/2),
    far past any useful trust region within 8 tries).
    """
    eye6 = jnp.eye(6, dtype=T0.dtype)
    dt = T0.dtype
    # The trust-region inner loop tries a DETERMINISTIC lambda ladder:
    # rejection k multiplies lambda by nu = 2^k (nu doubles each reject),
    # so candidate k uses lambda * 2^(k(k+1)/2). All lm_inner candidate
    # steps can therefore be solved and error-evaluated BATCHED in one
    # pass, and the sequential first-accept semantics recovered by an
    # argmax over the event mask — identical results, 1/lm_inner-th the
    # sequential-scan overhead (the inner loop was ~80 dependent scan
    # iterations per rerank at bench shapes).
    ladder = jnp.asarray(
        [2.0 ** (k * (k + 1) / 2.0) for k in range(lm_inner)], dt
    )

    def cond(carry):
        i, T, lam, done, y = carry
        # Reference early exit (lsq_registration_impl.hpp:65), batched:
        # see gn_solve.
        return (i < max_iterations) & ~done

    def outer(carry):
        i, T, lam, done, y_prev = carry
        H, g, y0, aux = linearize(T)
        # Lazy lambda init (lsq_registration_impl.hpp:128-130).
        lam = jnp.where(
            lam < 0.0,
            init_lambda_factor * jnp.max(jnp.abs(jnp.diagonal(H))),
            lam,
        )

        lam_k = lam * ladder  # (K,)
        Hk = H[None] + lam_k[:, None, None] * eye6[None]
        d_k = jax.vmap(lambda Hi: chol_solve6(Hi, -g))(Hk)  # (K, 6)
        delta_k = jax.vmap(se3.se3_exp)(d_k)  # (K, 4, 4)
        T_k = matmul(delta_k, T[None])
        y_k = jax.vmap(lambda Ti: error(Ti, aux))(T_k)  # (K,)
        rho_k = (y0 - y_k) / jnp.einsum(
            "kj,kj->k", d_k, lam_k[:, None] * d_k - g[None], precision=HIGHEST
        )  # :142
        accept_k = rho_k >= 0.0
        stepconv_k = jax.vmap(
            lambda D: _is_converged(D, rot_eps, trans_eps)
        )(delta_k)
        # Sequential events: at candidate k, accept (rho >= 0, :156-161)
        # or stop-as-converged on a converged rejection (:147-151);
        # otherwise grow lambda and continue. First event wins.
        event_k = accept_k | stepconv_k
        first = jnp.argmax(event_k)  # first True (argmax of bools)
        has_event = jnp.any(event_k)
        acc = has_event & accept_k[first]
        conv_stop = has_event & ~accept_k[first]  # converged rejection
        rho_f = rho_k[first]
        lam_acc = lam_k[first] * jnp.maximum(
            jnp.asarray(1.0 / 3.0, dt), 1.0 - (2.0 * rho_f - 1.0) ** 3
        )  # :159
        conv = (acc & stepconv_k[first]) | conv_stop
        T_new = jnp.where(acc, T_k[first], T)
        lam_new = jnp.where(acc, lam_acc, lam)
        # Inner exhaustion without acceptance = "lm not converged" break
        # (lsq_registration_impl.hpp computeTransformation :70-73).
        done_new = done | conv | ~has_event | conv_stop
        T_out = jnp.where(done, T, T_new)
        lam_out = jnp.where(done, lam, lam_new)
        y_out = jnp.where(done, y_prev, y0)
        return (i + 1, T_out, lam_out, done_new, y_out)

    _, T, _, done, y = jax.lax.while_loop(
        cond, outer,
        (jnp.int32(0), T0, jnp.asarray(-1.0, dt), jnp.asarray(False),
         jnp.asarray(jnp.inf, dt)),
    )
    # final_cost is the LINEARIZATION cost at entry to the final executed
    # iteration — one accepted step STALE relative to the returned
    # transform (the pre-round-4 scan version evaluated at the converged
    # T). Nothing downstream consumes it (the rerank pick uses the gated
    # fitness statistics, refine.gicp._fitness_stats); callers needing the
    # exact converged cost should evaluate error(T) once after the solve
    # (ADVICE r4 low, documented semantics).
    return LsqResult(transform=T, converged=done, final_cost=y)
