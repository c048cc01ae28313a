"""Device-side Huffman-shaped wavelet tree construction.

The reference fills node bit vectors one symbol at a time
(HuffmanShapedWaveletTree.fill:127-146) — a serial bit-push loop.  Here the
same node contents come out of level-order array ops: at level L, the
concatenation of all level-L node bit vectors equals

    bits  = (code(bwt) >> L) & 1
    order = stable argsort of (prefix_L(code(bwt)), else +inf for symbols
            whose code ends above L)

i.e. one stable sort per level groups elements by their code prefix
(ascending prefix integer), preserving BWT order within each node.  The
bits are packed into uint32 words ON DEVICE (32x smaller device->host
transfer than the raw 0/1 bytes), and the host slices per-node bit runs
straight out of the packed words (lengths are known from the shape) into
the pre-order gecoz layout.

Levels are few (max code length; ~3-7 for genomic alphabets), so the whole
construction is `maxlen` stable sorts — data-parallel work on any XLA
backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from gecoz_tpu.index.rankbv import slice_packed_bits
from gecoz_tpu.index.shape import HSWTShape

_BIG = np.int32(2 ** 30)


@functools.partial(jax.jit, static_argnames=("maxlen",))
def wavelet_level_words(bwt: jax.Array, codes: jax.Array, lens: jax.Array,
                        maxlen: int) -> jax.Array:
    """Per-level node-concatenated bit arrays, packed to words on device.

    Returns uint32 [maxlen, ceil(n/32)]; row L holds the level-L bits of
    all active elements (grouped by ascending code prefix, stable in BWT
    order) LSB-first in its first `n_L` bit positions.
    """
    from gecoz_tpu.ops.fmq import _pack_bits_jit

    sym = bwt.astype(jnp.int32)
    code = codes[sym]
    ln = lens[sym]

    rows = []
    for L in range(maxlen):
        active = ln > L
        prefix = code & ((1 << L) - 1)
        key = jnp.where(active, prefix, _BIG)
        order = jnp.argsort(key, stable=True)
        bits = ((code[order] >> L) & 1).astype(jnp.int32)
        rows.append(_pack_bits_jit(bits))
    return jnp.stack(rows)


def _level_bit_counts(shape: HSWTShape, maxlen: int) -> list[int]:
    """Active bits per level (= sum of that level's node lengths)."""
    counts = [0] * maxlen
    for (L, p), ln in shape.node_lengths.items():
        counts[L] += ln
    return counts


def node_bits_from_levels(levels,
                          shape: HSWTShape) -> dict[tuple[int, int], np.ndarray]:
    """Slice per-node packed bit vectors out of packed level words (host).

    `levels` is the uint32 [maxlen, W] array (or a list of per-level
    word rows) from wavelet_level_words; node boundaries fall at
    arbitrary bit offsets, extracted with one shift pass per node
    (slice_packed_bits)."""
    out: dict[tuple[int, int], np.ndarray] = {}
    by_level: dict[int, list[tuple[int, int]]] = {}
    for (L, p) in shape.nodes:
        by_level.setdefault(L, []).append((L, p))
    for L, keys in by_level.items():
        keys.sort(key=lambda k: k[1])          # ascending prefix integer
        off = 0
        row = np.ascontiguousarray(levels[L]).view(np.uint8)
        for key in keys:
            ln = shape.node_lengths[key]
            out[key] = slice_packed_bits(row, off, ln)
            off += ln
    return out


def build_hswt_device(bwt, shape: HSWTShape):
    """BWT bytes (host OR device array) -> {node: packed bits} via the
    device kernel.

    A device-resident `bwt` (e.g. the SA kernel's free BWT operand) is
    consumed in place — no re-upload; each level row is fetched sliced
    to its TRUE word count (level L holds only n_L = sum of its node
    lengths bits), so the device->host transfer is ~total-code-bits/8
    ~= 0.3 bytes/symbol instead of maxlen * n/8."""
    maxlen = int(shape.bit_lengths.max())
    if not isinstance(bwt, jax.Array):
        bwt = jnp.asarray(np.asarray(bwt, np.uint8))
    levels_dev = wavelet_level_words(
        bwt,
        jnp.asarray(shape.codes.astype(np.int32)),
        jnp.asarray(shape.bit_lengths.astype(np.int32)),
        maxlen)
    rows = []
    for L, nbits in enumerate(_level_bit_counts(shape, maxlen)):
        w = (nbits + 31) // 32
        rows.append(np.asarray(levels_dev[L, :w]))
    return node_bits_from_levels(rows, shape)
