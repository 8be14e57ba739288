"""Brute-force neighbour search (ops.nn) vs a NumPy float64 reference.

Reference semantics: nn1 == argmin over the exact squared-distance matrix;
knn == the k smallest distances' indices, ascending, ties broken by lower
index (lax.top_k on negated distances).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sgtd_tpu.ops.nn import knn, nn1


def _sqd(q, r):
    q = np.asarray(q, np.float64)
    r = np.asarray(r, np.float64)
    return np.sum((q[:, None, :] - r[None, :, :]) ** 2, axis=-1)


def _knn_ref(q, r, k):
    return np.argsort(_sqd(q, r), axis=1, kind="stable")[:, :k]


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def test_nn1_matches_argmin(rng):
    q = rng.uniform(-50, 50, (128, 3)).astype(np.float32)
    r = rng.uniform(-50, 50, (256, 3)).astype(np.float32)
    idx, d = nn1(jnp.asarray(q), jnp.asarray(r))
    ref = _sqd(q, r)
    np.testing.assert_array_equal(np.asarray(idx), ref.argmin(1))
    np.testing.assert_allclose(np.asarray(d), ref.min(1), rtol=1e-5)


def test_nn1_ties_pick_lowest_index(rng):
    r0 = rng.uniform(-5, 5, (4, 3)).astype(np.float32)
    r = np.concatenate([r0, r0])  # exact duplicates -> distance ties
    q = r0 + 0.01
    idx, _ = nn1(jnp.asarray(q), jnp.asarray(r))
    assert np.all(np.asarray(idx) < 4)


def test_knn_matches_topk(rng):
    q = rng.uniform(-50, 50, (64, 3)).astype(np.float32)
    r = rng.uniform(-50, 50, (128, 3)).astype(np.float32)
    k = 7
    idx = np.asarray(knn(jnp.asarray(q), jnp.asarray(r), k))
    np.testing.assert_array_equal(idx, _knn_ref(q, r, k))


def test_knn_sorted_by_distance(rng):
    q = rng.uniform(-10, 10, (32, 3)).astype(np.float32)
    idx = np.asarray(knn(jnp.asarray(q), jnp.asarray(q), 5))
    d = _sqd(q, q)
    picked = np.take_along_axis(d, idx, axis=1)
    assert np.all(np.diff(picked, axis=1) >= 0)
    # self is its own nearest neighbour
    np.testing.assert_array_equal(idx[:, 0], np.arange(32))


def test_vmap_batches(rng):
    q = rng.uniform(-50, 50, (2, 64, 3)).astype(np.float32)
    r = rng.uniform(-50, 50, (2, 64, 3)).astype(np.float32)
    ib, _ = jax.vmap(nn1)(jnp.asarray(q), jnp.asarray(r))
    kb = jax.vmap(lambda a, b: knn(a, b, 3))(jnp.asarray(q), jnp.asarray(r))
    for b in range(2):
        np.testing.assert_array_equal(np.asarray(ib[b]), _sqd(q[b], r[b]).argmin(1))
        np.testing.assert_array_equal(np.asarray(kb[b]), _knn_ref(q[b], r[b], 3))


def test_non_power_of_two_rows(rng):
    q = rng.uniform(-50, 50, (100, 3)).astype(np.float32)
    r = rng.uniform(-50, 50, (50, 3)).astype(np.float32)
    idx, _ = nn1(jnp.asarray(q), jnp.asarray(r))
    np.testing.assert_array_equal(np.asarray(idx), _sqd(q, r).argmin(1))


def test_far_coordinates_no_cancellation(rng):
    """Points 500 m from the origin, 1 cm apart: the difference form keeps
    the neighbour order that |q|^2 + |r|^2 - 2 q.r would lose in f32."""
    base = np.array([500.0, -480.0, 20.0])
    r = (base + rng.uniform(-0.5, 0.5, (256, 3))).astype(np.float32)
    q = (r[:64] + rng.normal(0, 0.003, (64, 3))).astype(np.float32)
    idx, _ = nn1(jnp.asarray(q), jnp.asarray(r))
    np.testing.assert_array_equal(np.asarray(idx), _sqd(q, r).argmin(1))
