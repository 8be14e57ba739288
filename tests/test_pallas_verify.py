"""Hypothesis inlier voting (match.verify.hypothesis_votes) vs NumPy float64."""

import numpy as np
import jax.numpy as jnp
import pytest

from sgtd_tpu.match.verify import hypothesis_votes


def _rand_rot(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    ).reshape(n, 3, 3)


def _case(rng, c, h, p):
    rot = _rand_rot(rng, c * h).reshape(c, h, 3, 3).astype(np.float32)
    t = rng.normal(0, 5, (c, h, 3)).astype(np.float32)
    vq = rng.normal(0, 10, (c, p, 3, 3)).astype(np.float32)
    # Half the pairs are near-consistent with hypothesis 0 of each candidate.
    vdb = rng.normal(0, 10, (c, p, 3, 3)).astype(np.float32)
    for ci in range(c):
        moved = vq[ci, : p // 2] @ rot[ci, 0].T + t[ci, 0]
        vdb[ci, : p // 2] = moved + rng.normal(0, 0.3, moved.shape)
    valid = rng.uniform(size=(c, p)) > 0.2
    return rot, t, vq, vdb, valid


def _ref(rot, t, vq, vdb, valid, thr):
    """Float64 reference; also returns the pairs within 1e-4 m of the
    threshold, whose float32 verdict may legitimately differ."""
    r64, t64, q64, d64 = (x.astype(np.float64) for x in (rot, t, vq, vdb))
    moved = np.einsum("chij,cpkj->chpki", r64, q64) + t64[:, :, None, None, :]
    d = np.linalg.norm(moved - d64[:, None], axis=-1)  # (C, H, P, 3)
    inlier = np.all(d < thr, axis=-1) & valid[:, None, :]
    near = np.any(np.abs(d - thr) < 1e-4, axis=-1) & valid[:, None, :]
    return inlier.sum(axis=-1), near.sum(axis=-1)


def _check(c, h, p, seed):
    rng = np.random.default_rng(seed)
    thr = 3.0
    rot, t, vq, vdb, valid = _case(rng, c, h, p)
    votes = np.asarray(
        hypothesis_votes(
            jnp.asarray(rot), jnp.asarray(t), jnp.asarray(vq),
            jnp.asarray(vdb), jnp.asarray(valid), thr,
        )
    )
    ref, near = _ref(rot, t, vq, vdb, valid, thr)
    assert votes.shape == (c, h) and votes.dtype == np.int32
    assert np.all(np.abs(votes - ref) <= near), (votes - ref)[near == 0]
    # the planted hypothesis wins
    assert (votes[:, 0] >= p // 2 * 0.5).all()
    return votes, ref, near


def test_votes_match_dense_reference():
    votes, ref, near = _check(5, 16, 64, seed=7)
    np.testing.assert_array_equal(votes[near == 0], ref[near == 0])


@pytest.mark.parametrize(
    "c,h,p",
    [(32, 50, 128), (50, 50, 256), (7, 50, 200)],
    ids=["c32", "c50", "p200"],
)
def test_votes_shapes_vs_numpy(c, h, p):
    _check(c, h, p, seed=c * 1000 + p)
