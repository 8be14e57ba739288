"""Per-frame vote tally vs np.bincount: bit-exact at every width.

match.search.frame_votes must count hits per frame exactly for narrow
and wide (20k-keyframe) vote arrays, including sentinel ids == f_pad
(dropped) and arbitrary lengths.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from sgtd_tpu.match.search import frame_votes


def _ref(hit, frame, f_pad):
    keep = hit & (frame < f_pad)
    return np.bincount(frame[keep], minlength=f_pad).astype(np.float32)


@pytest.mark.parametrize("f_pad", [8, 208, 1024, 2048])
def test_frame_votes_flat_parity(f_pad, rng):
    l = 5000
    hit = rng.uniform(size=l) < 0.3
    # include sentinel ids == f_pad (must contribute nothing)
    frame = rng.integers(0, f_pad + 1, size=l, dtype=np.int32)
    got = frame_votes(jnp.asarray(hit), jnp.asarray(frame), f_pad)
    np.testing.assert_array_equal(np.asarray(got), _ref(hit, frame, f_pad))


@pytest.mark.parametrize("f_pad", [208, 2056, 20016])
def test_frame_votes_wide_parity(f_pad, rng):
    l = 5001
    hit = rng.uniform(size=l) < 0.3
    frame = rng.integers(0, f_pad + 1, size=l, dtype=np.int32)
    got = frame_votes(jnp.asarray(hit), jnp.asarray(frame), f_pad)
    np.testing.assert_array_equal(np.asarray(got), _ref(hit, frame, f_pad))


def test_frame_votes_wide_dense_counts(rng):
    """Every bin hit many times: counts must be exact."""
    f_pad = 300
    l = 40000
    hit = np.ones(l, bool)
    frame = rng.integers(0, f_pad, size=l, dtype=np.int32)
    got = frame_votes(jnp.asarray(hit), jnp.asarray(frame), f_pad)
    want = np.bincount(frame, minlength=f_pad).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(got), want)
