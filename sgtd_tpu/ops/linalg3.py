"""Closed-form batched 3x3/4x4 linear algebra.

XLA's generic ``jnp.linalg.svd``/``eigh`` lower to iterative algorithms that
are slow for huge batches of tiny matrices (the shape this framework lives
on: per-triangle Kabsch solves, per-point covariance regularization). These
routines are branch-free closed forms made of elementwise operations:

  * ``sym_eig3x3`` — analytic eigenvalues (trigonometric Cardano) +
    cross-product eigenvectors for symmetric 3x3 matrices.
  * ``kabsch`` — optimal rigid rotation via Horn's quaternion method: the
    dominant eigenvector of the 4x4 K matrix by shifted power iteration.
    Always returns a proper rotation (det=+1), replacing SVD + det-fix
    (ref STDesc.cpp:549-571).
  * ``inv3x3`` — adjugate inverse.

All operate on (..., 3, 3) with arbitrary leading batch dims.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-12
HIGHEST = jax.lax.Precision.HIGHEST


def matmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """``a @ b`` with float32 products kept at full precision.

    A float32 product at default precision may run in TF32 (or bf16 passes)
    on a matrix unit, which loses centimetres on metric coordinates of
    50-500 m. Every product that carries coordinates or poses uses this.
    """
    return jnp.matmul(a, b, precision=HIGHEST)


def inv3x3(m: jnp.ndarray) -> jnp.ndarray:
    """Adjugate-based inverse of (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) > _EPS, det, _EPS)
    adj = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), b * f - c * e], axis=-1),
            jnp.stack([B, a * i - c * g, -(a * f - c * d)], axis=-1),
            jnp.stack([C, -(a * h - b * g), a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def det3x3(m: jnp.ndarray) -> jnp.ndarray:
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _det4x4(m: jnp.ndarray) -> jnp.ndarray:
    """Determinant of (..., 4, 4) via cofactor expansion on the first row."""
    out = 0.0
    for j in range(4):
        cols = [k for k in range(4) if k != j]
        minor = m[..., 1:, :][..., :, cols]
        out = out + ((-1.0) ** j) * m[..., 0, j] * det3x3(minor)
    return out


def _adjugate4x4(m: jnp.ndarray) -> jnp.ndarray:
    """Adjugate (transposed cofactor matrix) of (..., 4, 4)."""
    rows = list(range(4))
    cof = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(4):
            rr = [k for k in rows if k != i]
            cc = [k for k in rows if k != j]
            minor = m[..., rr, :][..., :, cc]
            cof[i][j] = ((-1.0) ** (i + j)) * det3x3(minor)
    # adj = cofactor^T
    return jnp.stack(
        [jnp.stack([cof[i][j] for i in range(4)], axis=-1) for j in range(4)],
        axis=-2,
    )


def sym_eig3x3(m: jnp.ndarray):
    """Eigen-decomposition of symmetric (..., 3, 3).

    Returns (eigenvalues (..., 3) ascending, eigenvectors (..., 3, 3) with
    columns matching the eigenvalues). Analytic method: Cardano for values,
    cross products of shifted rows for vectors, robust to repeated roots by
    epsilon regularization.
    """
    dtype = m.dtype
    m = m.astype(jnp.float32)
    q = jnp.trace(m, axis1=-2, axis2=-1) / 3.0
    eye = jnp.eye(3, dtype=m.dtype)
    a = m - q[..., None, None] * eye
    p2 = jnp.sum(a * a, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(p2 + _EPS)
    detb = det3x3(a / (2.0 * p[..., None, None] + _EPS))
    r = jnp.clip(detb * 0.5 * 8.0 / 2.0, -1.0, 1.0)  # det(B)/2 with B=A/p
    # det(A/p) = det(A)/p^3; r = det/2.
    r = jnp.clip(det3x3(a) / (2.0 * p**3 + _EPS), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e3 = q + 2.0 * p * jnp.cos(phi)
    e1 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    vals = jnp.stack([e1, e2, e3], axis=-1)  # ascending

    def eigvec(ev_a, ev_b):
        # Null space of (M - ev_a I) via rows of (M - ev_b I)(M - ev_c I):
        # columns of the product matrix span the ev_a eigenspace.
        pa = m - ev_a[..., None, None] * eye
        # Use cross products of two rows of pa for the null direction.
        r0, r1, r2 = pa[..., 0, :], pa[..., 1, :], pa[..., 2, :]
        c01 = jnp.cross(r0, r1)
        c02 = jnp.cross(r0, r2)
        c12 = jnp.cross(r1, r2)
        n01 = jnp.sum(c01 * c01, axis=-1)
        n02 = jnp.sum(c02 * c02, axis=-1)
        n12 = jnp.sum(c12 * c12, axis=-1)
        best = jnp.argmax(jnp.stack([n01, n02, n12], axis=-1), axis=-1)
        cand = jnp.stack([c01, c02, c12], axis=-2)
        v = jnp.take_along_axis(cand, best[..., None, None], axis=-2)[..., 0, :]
        return v / (jnp.linalg.norm(v, axis=-1, keepdims=True) + _EPS)

    v1 = eigvec(e1, e2)
    v3 = eigvec(e3, e2)
    # Orthogonalize: middle vector from the cross product.
    v3 = v3 - jnp.sum(v3 * v1, axis=-1, keepdims=True) * v1
    v3 = v3 / (jnp.linalg.norm(v3, axis=-1, keepdims=True) + _EPS)
    v2 = jnp.cross(v3, v1)
    vecs = jnp.stack([v1, v2, v3], axis=-1)
    return vals.astype(dtype), vecs.astype(dtype)


def kabsch(src: jnp.ndarray, ref: jnp.ndarray, weights: jnp.ndarray | None = None):
    """Optimal proper rotation + translation aligning src -> ref.

    src/ref: (..., N, 3) paired points; weights: (..., N) optional.
    Returns (rot (..., 3, 3), t (..., 3)) minimizing sum w ||R s + t - r||^2.
    Horn's quaternion method solved QCP-style (Theobald 2005): the largest
    eigenvalue of the 4x4 K matrix by Newton iteration on its quartic
    characteristic polynomial (trace(K)=0, start at the E0 upper bound), the
    eigenvector from the adjugate of K - lambda*I. Branch-free, no SVD,
    always det(R)=+1.
    """
    if weights is None:
        weights = jnp.ones(src.shape[:-1], src.dtype)
    w = weights[..., None]
    wsum = jnp.maximum(jnp.sum(w, axis=-2, keepdims=True), _EPS)
    wn = w / wsum  # normalized weights: well-conditioned f32 quartic below
    mu_s = jnp.sum(src * wn, axis=-2, keepdims=True)
    mu_r = jnp.sum(ref * wn, axis=-2, keepdims=True)
    s = src - mu_s
    r = ref - mu_r
    # Normalize scale so E0 == 1 (keeps the Newton iteration in [0, 1]).
    sigma2 = 0.5 * (
        jnp.sum(wn[..., 0] * jnp.sum(s * s, axis=-1), axis=-1)
        + jnp.sum(wn[..., 0] * jnp.sum(r * r, axis=-1), axis=-1)
    )
    inv_sigma = jax.lax.rsqrt(sigma2 + _EPS)[..., None, None]
    s = s * inv_sigma
    r = r * inv_sigma
    weights_n = wn[..., 0]
    # Cross-covariance H = sum w s_i r_i^T  (..., 3, 3)
    H = jnp.einsum("...ni,...nj->...ij", s * wn, r, precision=HIGHEST)

    sxx, sxy, sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    syx, syy, syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    szx, szy, szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    K = jnp.stack(
        [
            jnp.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
            jnp.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
            jnp.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
            jnp.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
        ],
        axis=-2,
    )  # (..., 4, 4)

    # Largest eigenvalue of K: Newton on the characteristic quartic
    # P(l) = l^4 + c2 l^2 + c1 l + c0 (trace(K) = 0), starting from the
    # E0 = (sum w|s|^2 + sum w|r|^2)/2 upper bound — monotone convergence to
    # the largest root in a handful of steps (Theobald's QCP).
    c2 = -2.0 * jnp.sum(H * H, axis=(-2, -1))
    c1 = -8.0 * det3x3(H)
    c0 = _det4x4(K)
    # After normalization E0 == 1 by construction.
    del weights_n
    lam = jnp.ones(c2.shape, K.dtype)

    def newton(_, lam):
        p = ((lam * lam + c2) * lam + c1) * lam + c0
        dp = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        return lam - p / jnp.where(jnp.abs(dp) > _EPS, dp, _EPS)

    lam = jax.lax.fori_loop(0, 12, newton, lam)

    # Eigenvector from the adjugate of (K - lam I): every nonzero column is
    # a null vector; take the largest for stability.
    A = K - lam[..., None, None] * jnp.eye(4, dtype=K.dtype)
    adj = _adjugate4x4(A)
    norms = jnp.sum(adj * adj, axis=-2)  # (..., 4) column norms
    best = jnp.argmax(norms, axis=-1)
    q = jnp.take_along_axis(adj, best[..., None, None], axis=-1)[..., 0]
    # Degenerate fallback (all columns ~0: repeated eigenvalue) -> identity.
    qn = jnp.linalg.norm(q, axis=-1, keepdims=True)
    ident = jnp.zeros_like(q).at[..., 0].set(1.0)
    q = jnp.where(qn > 1e-12, q / (qn + _EPS), ident)

    w0, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rot = jnp.stack(
        [
            jnp.stack(
                [1 - 2 * (y * y + z * z), 2 * (x * y - w0 * z), 2 * (x * z + w0 * y)], -1
            ),
            jnp.stack(
                [2 * (x * y + w0 * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w0 * x)], -1
            ),
            jnp.stack(
                [2 * (x * z - w0 * y), 2 * (y * z + w0 * x), 1 - 2 * (x * x + y * y)], -1
            ),
        ],
        axis=-2,
    )
    t = mu_r[..., 0, :] - jnp.einsum(
        "...ij,...j->...i", rot, mu_s[..., 0, :], precision=HIGHEST
    )
    return rot, t


def chol_solve6(H: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """Solve H x = g for SPD 6x6 H, fully unrolled (batched over leading dims).

    The se(3) normal-equation solve of the registration engines
    (H + lambda I from J^T M J, ref lsq_registration_impl.hpp:110,137).
    jnp.linalg.solve lowers 6x6 batches to a pivoted-LU loop, run 8 times
    per LM outer iteration. This unrolled Cholesky is ~50 vectorized
    scalar ops over the batch, exact for the SPD case.

    H (..., 6, 6), g (..., 6) -> x (..., 6).
    """
    n = 6
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                # Clamp: H is PSD + damping; guard exact zeros on fully
                # masked-out candidates.
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)
