"""Segmented fills over int32 arrays (plain jnp, any backend).

A *segmented fill* broadcasts each marked value (>= 0) over the unmarked
positions (-1) that follow it (forward) or precede it (reverse).  The
suffix-array kernel uses them to carry run-end and next-run data to every
member of a run (`ops/sa_device.py`).  Each is one cummax/cummin of
marked positions plus one gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def fill_fwd_i32(x: jax.Array) -> jax.Array:
    """out[i] = x[j] for the largest j <= i with x[j] >= 0, else -1."""
    iota = jnp.arange(x.shape[0], dtype=jnp.int32)
    idx = jax.lax.cummax(jnp.where(x >= 0, iota, -1))
    return jnp.where(idx < 0, jnp.int32(-1), x[jnp.maximum(idx, 0)])


def fill_rev_i32(x: jax.Array) -> jax.Array:
    """out[i] = x[j] for the smallest j >= i with x[j] >= 0, else -1."""
    n = x.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    idx = jax.lax.cummin(jnp.where(x >= 0, iota, n), reverse=True)
    return jnp.where(idx >= n, jnp.int32(-1), x[jnp.minimum(idx, n - 1)])
