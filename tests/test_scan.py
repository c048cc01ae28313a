"""Segmented fills (ops/scan.py) against a plain numpy loop."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gecoz_tpu.ops.scan import fill_fwd_i32, fill_rev_i32


def _fill_ref(x, reverse=False):
    """Nearest non-negative at-or-before (at-or-after when reverse)."""
    out = np.full_like(x, -1)
    it = range(x.size - 1, -1, -1) if reverse else range(x.size)
    last = -1
    for i in it:
        if x[i] >= 0:
            last = x[i]
        out[i] = last
    return out


def _marked(rng, n, density):
    x = np.full(n, -1, np.int32)
    marks = {"none": 0, "sparse": max(1, n // 100), "dense": n // 2}[density]
    pos = rng.choice(n, size=min(marks, n), replace=False)
    x[pos] = rng.integers(0, 1 << 30, size=pos.size).astype(np.int32)
    return x


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 777, (1 << 16) + 3])
@pytest.mark.parametrize("density", ["none", "sparse", "dense"])
def test_fill_matches_loop(reverse, n, density, rng):
    x = _marked(rng, n, density)
    fill = fill_rev_i32 if reverse else fill_fwd_i32
    got = np.asarray(jax.jit(fill)(jnp.asarray(x)))
    assert np.array_equal(got, _fill_ref(x, reverse)), (reverse, n, density)


def test_fill_under_vmap(rng):
    """The mesh path vmaps the SA kernel over equal-bucket blocks."""
    x = np.stack([_marked(rng, 999, d) for d in ("none", "sparse", "dense")])
    for fill, rev in ((fill_fwd_i32, False), (fill_rev_i32, True)):
        got = np.asarray(jax.vmap(fill)(jnp.asarray(x)))
        want = np.stack([_fill_ref(row, rev) for row in x])
        assert np.array_equal(got, want)
