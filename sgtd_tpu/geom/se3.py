"""Batched, differentiable SO(3)/SE(3) operations in JAX.

JAX replacement for the reference's vendored Sophus header library
(/root/reference/Sophus/sophus/*.hpp) and so3_math.h — only the subset the
pipeline needs: exp/log/compose/inverse/apply, quaternion helpers, and the
rotation-angle metric used by the evaluation code
(ref src/sgtd/include/utility.hpp:110-123 ``compute_adj_rpe``).

All functions operate on the trailing dimensions and broadcast over leading
batch dimensions, so they compose with vmap/jit/shard_map.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sgtd_tpu.ops.linalg3 import HIGHEST, matmul

_EPS = 1e-9


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues' formula, numerically safe near 0: (..., 3) -> (..., 3, 3)."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = matmul(W, W)
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks.
    a = jnp.where(theta2 > 1e-8, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = jnp.where(
        theta2 > 1e-8, (1.0 - jnp.cos(theta)) / (theta2 + _EPS), 0.5 - theta2 / 24.0
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation-matrix log: (..., 3, 3) -> (..., 3). Safe for angles < pi."""
    trace = jnp.trace(R, axis1=-2, axis2=-1)
    cos_t = jnp.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    # vee of the antisymmetric part, scaled.
    w = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5
    sin_t = jnp.sin(theta)
    scale = jnp.where(jnp.abs(sin_t) > 1e-6, theta / (sin_t + _EPS), 1.0 + theta * theta / 6.0)
    return w * scale[..., None]


def rotation_angle_deg(R: jnp.ndarray) -> jnp.ndarray:
    """Angle of a rotation matrix in degrees (ref utility.hpp:117-122)."""
    trace = jnp.trace(R, axis1=-2, axis2=-1)
    cos_t = jnp.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    return jnp.rad2deg(jnp.arccos(cos_t))


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """se(3) exp: (..., 6) [v, w] -> (..., 4, 4) homogeneous transform."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = matmul(W, W)
    b = jnp.where(
        theta2 > 1e-8, (1.0 - jnp.cos(theta)) / (theta2 + _EPS), 0.5 - theta2 / 24.0
    )
    c = jnp.where(
        theta2 > 1e-8,
        (theta - jnp.sin(theta)) / (theta2 * theta + _EPS),
        1.0 / 6.0 - theta2 / 120.0,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = jnp.einsum("...ij,...j->...i", V, v, precision=HIGHEST)
    return rt_to_mat(R, t)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """SE(3) log: (..., 4, 4) -> (..., 6) [v, w]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = matmul(W, W)
    # V^{-1} = I - W/2 + (1/theta^2 - cot(theta/2)/(2 theta)) W^2
    half = theta / 2.0
    cot_term = jnp.where(
        theta2 > 1e-8,
        (1.0 - half * jnp.cos(half) / (jnp.sin(half) + _EPS)) / (theta2 + _EPS),
        1.0 / 12.0 + theta2 / 720.0,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    Vinv = eye - 0.5 * W + cot_term[..., None, None] * W2
    v = jnp.einsum("...ij,...j->...i", Vinv, t, precision=HIGHEST)
    return jnp.concatenate([v, w], axis=-1)


def rt_to_mat(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(R (...,3,3), t (...,3)) -> (..., 4, 4)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.zeros(batch + (1, 4), dtype=R.dtype).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def mat_inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form SE(3) inverse of (..., 4, 4)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return rt_to_mat(Rt, -jnp.einsum("...ij,...j->...i", Rt, t, precision=HIGHEST))


def transform_points(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply (..., 4, 4) to points (..., N, 3)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return jnp.einsum("...ij,...nj->...ni", R, pts, precision=HIGHEST) + t[..., None, :]


def relative_pose_error(gt: jnp.ndarray, est: jnp.ndarray):
    """Translation (m) and rotation (deg) error between two SE(3) transforms.

    Matches ref ``compute_adj_rpe`` (utility.hpp:110-123):
    delta = est^-1 @ gt; t_err = ||delta_t||; r_err = angle(delta_R).
    """
    delta = matmul(mat_inverse(est), gt)
    t_err = jnp.linalg.norm(delta[..., :3, 3], axis=-1)
    r_err = rotation_angle_deg(delta[..., :3, :3])
    return t_err, r_err
