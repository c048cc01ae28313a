"""Batched multi-pattern FM search: thousands of queries in lockstep.

The serving-path analog of SimpleGFFGenerator (which loops queries one at
a time, SimpleGFFGenerator.java:123-163): all patterns are right-aligned
into one matrix, one `search_batch` call per block resolves every row
range on device, and a single `locate_batch` resolves every hit row.
Per-sequence splitting then follows GSSA.find:160-185 on the host.
"""

from __future__ import annotations

import numpy as np


def pack_patterns(patterns: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Right-align patterns into a uint8 [B, L] matrix + lengths."""
    L = max((len(p) for p in patterns), default=1)
    arr = np.zeros((len(patterns), L), dtype=np.uint8)
    lens = np.zeros(len(patterns), dtype=np.int32)
    for i, p in enumerate(patterns):
        arr[i, L - len(p):] = np.frombuffer(p, np.uint8)
        lens[i] = len(p)
    return arr, lens


def find_batched(fm, patterns: list[bytes],
                 device_block=None) -> list[dict[int, np.ndarray]]:
    """Per-pattern {sequence: positions} over one block, device-batched."""
    import jax.numpy as jnp

    from gecoz_tpu.ops import fmq

    if not patterns:
        return []
    if device_block is None:
        # kmer table seeds the searches; the locate table turns each hit's
        # rate-step LF walk into ONE 8-byte gather (fmq.with_locate_table).
        # Its pointer-doubling build keeps ~8 int32 sort operands in
        # flight, so chr1-class blocks on a tight memory budget keep the
        # fused-LF walk instead.
        from gecoz_tpu.utils import accel
        budget = accel.device_hbm_bytes()
        base = fmq.with_kmer_table(fmq.device_block_from_fm(fm))
        if budget is None or fm.length * 40 <= budget:
            device_block = fmq.with_locate_table(base)
        else:
            device_block = fmq.with_lf_table(base, decode=False)
    arr, lens = pack_patterns(patterns)
    sp, ep = fmq.search_batch(device_block, jnp.asarray(arr),
                              jnp.asarray(lens))
    sp = np.asarray(sp).astype(np.int64)
    ep = np.asarray(ep).astype(np.int64)

    counts = np.maximum(ep - sp + 1, 0)
    total = int(counts.sum())
    out: list[dict[int, np.ndarray]] = [dict() for _ in patterns]
    if total == 0:
        return out

    # expand all hit rows and locate them in one device batch
    rows = np.concatenate([np.arange(s, e + 1)
                           for s, e, c in zip(sp, ep, counts) if c > 0])
    values = np.asarray(fmq.locate_batch(
        device_block, jnp.asarray(rows.astype(np.int32)))).astype(np.int64)

    e_arr = fm.e
    offs = np.concatenate([[0], np.cumsum(counts)])
    for i, c in enumerate(counts):
        if c == 0:
            continue
        hits = np.sort(values[offs[i]:offs[i + 1]])
        idx1 = 0
        res = {}
        for j in range(len(e_arr)):
            idx2 = int(np.searchsorted(hits, e_arr[j], side="left"))
            if idx2 > idx1:
                base = int(e_arr[j - 1]) + 1 if j > 0 else 0
                res[j] = hits[idx1:idx2] - base
                idx1 = idx2
        out[i] = res
    return out
