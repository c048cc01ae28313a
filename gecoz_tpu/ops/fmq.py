"""Device FM-index query engine: batched occ / search / locate / decode.

Design (vs the reference's per-query pointer chasing, GSSA.java:187-251):

* Query state is flat device arrays, not the serialized wavelet layout:
  one bit plane per live symbol with its per-32-bit-word rank prefix fused
  alongside (`plane_pairs`), so occ(sym, pos) is one 2-wide gather + a
  popcount — versus 2 gathers *per wavelet level* in the tree walk, and a
  fused (lf, symbol) table makes decode/locate steps a single gather
  (`with_lf_table`).  For genomic alphabets (sigma <= 16) this costs
  ~0.2*sigma bytes/symbol of device memory and roughly triples decode
  speed.  (The wavelet tree remains the *storage*
  format; planes are built at load/encode time.)
* Everything is batched: searches run thousands of patterns in lockstep,
  locate walks advance all hit rows together (bounded by the sampling
  rate), and full-text decode runs one independent LF walk per sampling
  interval — n/rate walks of `rate` steps each, turning the reference's
  sequential backward extraction into [n/32]-wide vector gathers.
* LF steps from separator rows apply the wrap-row correction (see
  gecoz_tpu/index/fm.py); searching itself never needs it.

All entry points are jittable; arrays shard over a mesh along the batch /
walk dimension (see gecoz_tpu/parallel/mesh.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gecoz_tpu.ops.sa_device import _scatter_is_cheap
from gecoz_tpu.ops.sa_device import apply_perm as _apply_perm

MAX_PLANES = 16


class DeviceFMBlock(NamedTuple):
    """Device-resident query state for one block (a pytree; `sf` is static
    aux metadata so loop bounds stay concrete under jit)."""

    bwt: jax.Array          # uint8 [n] BWT bytes
    plane_pairs: jax.Array  # fused (word, prefix) pairs u32 [sigma*W,2]
                            # for blocks under _PAIR_LIMIT: one 8-byte
                            # row gather per occ (fastest search); a
                            # 2-wide minor dim risks a tile-padded
                            # layout, affordable only for small blocks.
                            # Empty [0, 2] for large blocks, which use
                            # the flat arrays:
    plane_words: jax.Array  # uint32 [sigma*W] flat bit words (empty for
                            # small blocks)
    plane_pres: jax.Array   # uint32 [sigma*W] per-word exclusive rank
                            # prefixes; occ = two plain 4-byte gathers
    c: jax.Array            # int32 [257] cumulative symbol counts
    sym_plane: jax.Array    # int32 [256] byte -> plane row (-1 if absent)
    wrap_row: jax.Array     # int32 [] row with SA value 0
    mark_words: jax.Array   # uint32 [W] sampled-row bit plane
    mark_pre: jax.Array     # int32 [W]
    mark_rows: jax.Array    # int32 [m] sampled row positions, ascending
                            # (the select-1 table: walk seeding is one
                            # gather instead of a per-walk binary search)
    ssa_perm: jax.Array     # int32 [m] sampled SA values >> sf, row order
    ssa_inv: jax.Array      # int32 [m] inverse permutation
    lf_tab: jax.Array       # fused LF table, uint32 [n]: ((lf<<8)|sym)
                            # when the block fits 24-bit rows, else plain
                            # lf (symbols fetched from bwt only where a
                            # step needs them); empty when not built
    lfk_tab: jax.Array      # k-step decode table: uint32 [n, 1+k/8ish]
                            # rows.  k=16: (LF^16, two code words — word
                            # w bits 4j = 4-bit PLANE code of the symbol
                            # at LF^(8w+j)); k=8: (LF^8, eight 4-bit
                            # PLANE codes — bits 4j = code at LF^j); k=4:
                            # (LF^4, four bytes — bits 8j = symbol at
                            # LF^j).  The k is recorded in lfk_k (static);
                            # empty when not built
    kmer_tab: jax.Array     # stacked k-mer seed table: int32 [T,2] rows of
                            # (sp, ep) after backward-searching every
                            # plane-coded string of length 1..kmer_k;
                            # level j starts at _kmer_offset(bits, j)
    loc_tab: jax.Array      # locate table: int32 [n, 2] rows of (first
                            # SAMPLED row on this row's LF path, step
                            # distance to it) — one 8-byte gather answers
                            # a locate.  Empty when not built
    sf: int                 # sampling factor (static)
    kmer_bits: int = 0      # bits per plane-coded symbol (static)
    kmer_k: int = 0         # max seeded suffix length (static)
    lfk_k: int = 0          # LF steps per lfk_tab row (4/8/16; static)

    @property
    def n(self) -> int:
        return self.bwt.shape[0]

    @property
    def W(self) -> int:
        return (self.bwt.shape[0] + 31) // 32

    @property
    def has_lf(self) -> bool:
        return self.lf_tab.shape[0] > 0

    @property
    def lf_packed(self) -> bool:
        """lf_tab rows carry the symbol in the low byte (small blocks)."""
        return self.bwt.shape[0] < _PACK_LIMIT

    @property
    def has_lfk(self) -> bool:
        return self.lfk_tab.shape[0] > 0

    @property
    def lfk_steps(self) -> int:
        """LF steps per fused-table gather (4 or 8; static)."""
        return self.lfk_k

    @property
    def has_kmer(self) -> bool:
        return self.kmer_tab.shape[0] > 0

    @property
    def has_loc(self) -> bool:
        return self.loc_tab.shape[0] > 0


jax.tree_util.register_pytree_node(
    DeviceFMBlock,
    lambda b: (tuple(b[:-4]), tuple(b[-4:])),
    lambda aux, leaves: DeviceFMBlock(*leaves, *aux),
)


_PACK_LIMIT = 1 << 23    # lf values below this pack with the symbol in u32
# blocks under this build the FUSED (word, pre) pair table (fast occ, but
# its 2-wide minor dim may be tile-padded); above it the flat arrays (two
# 4-byte gathers, ~1.5 bytes/char) keep chr1-class query state small
_PAIR_LIMIT = 1 << 24


def _corrected_lf(block: DeviceFMBlock) -> jax.Array:
    """Full corrected LF mapping as int32 [n] (jittable).

    One stable sort of the BWT yields the plain LF (stable argsort groups
    by symbol preserving row order, which IS C[sym]+rank); the separator
    correction is a cumsum over the zero plane (see gecoz_tpu/index/fm.py).
    Recovered elementwise from an already-built fused table when present."""
    n = block.n
    if block.has_lf:
        return _lf_from_row(block, block.lf_tab)
    iota = jnp.arange(n, dtype=jnp.int32)
    sym = block.bwt.astype(jnp.int32)
    _, order = jax.lax.sort((sym, iota), num_keys=2)
    lf = _apply_perm(order, iota)
    is_zero = sym == 0
    zero_rank = jnp.cumsum(is_zero, dtype=jnp.int32) - 1
    corr = 1 + zero_rank - (block.wrap_row < iota).astype(jnp.int32)
    lf = jnp.where(is_zero, corr, lf)
    return jnp.where(iota == block.wrap_row, 0, lf)


def _marked_bits(block: DeviceFMBlock) -> jax.Array:
    """Per-row sampled flag as int32 [n], expanded from the mark plane."""
    mb = (block.mark_words[:, None]
          >> jnp.arange(32, dtype=jnp.uint32)[None, :]) & jnp.uint32(1)
    return mb.reshape(-1)[:block.n].astype(jnp.int32)


def with_locate_table(block: DeviceFMBlock) -> DeviceFMBlock:
    """Attach the locate table (jittable): for every BWT row, the first
    SAMPLED row on its LF path and the step distance to it.

    The reference's locate is a sequential walk of up to rate LF steps per
    hit (GSSA.locate:241-251); the round-3 engine did the same walk
    batched, one 4-byte gather per step (~rate gathers per query).  Here
    the walk is precomputed for ALL rows at once by sf pointer-doubling
    rounds — round t extends every row's known path from 2^t to 2^(t+1)
    steps via one permutation inversion sort + one value-carrying
    permutation write (`apply_perm`) — after which a locate is ONE 8-byte row gather plus
    the final sampled-value lookup.  Every row reaches a sampled row
    within rate steps (SA values step down by 1 per LF step and every
    rate'th value is marked), so sf rounds always converge.
    """
    n = block.n
    if n == 0 or block.has_loc:
        return block
    iota = jnp.arange(n, dtype=jnp.int32)
    jump = _corrected_lf(block)                  # LF^1, a true permutation
    done = _marked_bits(block)
    hit = jnp.where(done == 1, iota, 0)
    d = jnp.zeros((n,), jnp.int32)
    # invariant before round t: (done, hit, d) cover steps [0, 2^t),
    # jump = LF^(2^t); lanes stay in play until their first mark
    for t in range(block.sf):
        _, ij = jax.lax.sort((jump, iota), num_keys=1)   # jump^{-1}
        hitd = hit.astype(jnp.uint32) | (done.astype(jnp.uint32) << 31)
        hitd2, d2, jump2 = _apply_perm(ij, hitd, d, jump)
        done2 = (hitd2 >> 31).astype(jnp.int32)
        hit2 = (hitd2 & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
        live = done == 0
        hit = jnp.where(live, hit2, hit)
        d = jnp.where(live, (1 << t) + d2, d)
        done = done | done2
        jump = jump2
    return block._replace(loc_tab=jnp.stack([hit, d], axis=1))


def with_lf_table(block: DeviceFMBlock, decode: bool = True) -> DeviceFMBlock:
    """Attach the fused LF table (jittable).

    One stable sort of the BWT yields the plain LF mapping (stable argsort
    groups by symbol preserving row order, which IS C[sym]+rank); the
    separator correction is a cumsum over the zero plane.  Decode/locate
    steps then cost ONE gather instead of three (bwt + plane + prefix).

    With decode=True the fused k-step decode table is also built: LF^k
    plus the k symbols emitted along the way, so a decode walk costs one
    (1 + k/4)-word gather per k text positions.  k = 8 when the sampling
    rate divides by 8 (three permutation-composition rounds), else 4;
    locate-only callers pass decode=False to skip it.
    """
    n = block.n
    if n == 0 or block.has_lf:
        return block
    iota = jnp.arange(n, dtype=jnp.int32)
    sym = block.bwt.astype(jnp.int32)
    lf = _corrected_lf(block)
    # bit 31 (spare in both row formats: lf < 2^23 packed, < 2^31 plain)
    # carries "this row is sampled", so a locate walk costs ONE gather per
    # step — the rank/perm lookups happen once, after the walk stops
    marked31 = _marked_bits(block).astype(jnp.uint32) << 31
    if n < _PACK_LIMIT:
        tab = ((lf.astype(jnp.uint32) << 8) | block.bwt.astype(jnp.uint32)
               | marked31)
    else:
        # rows don't fit 24 bits: plain lf — locate walks then gather 4
        # bytes per step; the rare steps that also need the symbol read
        # bwt separately
        tab = lf.astype(jnp.uint32) | marked31
    if not decode:
        return block._replace(lf_tab=tab)

    # Fused k-step decode table: LF^k plus the k symbols emitted along the
    # way, so a decode walk needs ONE (1 + k/4)-word gather per k text
    # positions.  Walks are memory-latency-bound, so halving the gather
    # count ~halves decode time; k = 8 costs one extra composition round
    # at build and 4 more bytes/row.
    # Permutation composition lf[lf[i]]: one sort inverts the permutation,
    # then the values return to position order via _apply_perm (extra
    # value operands ride along).
    rate = 1 << block.sf
    if rate % 8 == 0:
        # k=8, 8-byte rows: the eight symbols ride as 4-bit PLANE codes
        # (sigma <= 16), decoded back to bytes by a 16-way select in the
        # walk loop — gather cost scales with row bytes, so the packed
        # 8-byte row beats a 12-byte one
        pc = jnp.maximum(block.sym_plane[sym], 0).astype(jnp.uint32)
        _, i1 = jax.lax.sort((lf, iota), num_keys=1)
        lf2, q1 = _apply_perm(i1, lf, pc)
        c2 = pc | (q1 << 4)
        _, i2 = jax.lax.sort((lf2, iota), num_keys=1)
        lf4, q2 = _apply_perm(i2, lf2, c2)
        c4 = c2 | (q2 << 8)
        _, i4 = jax.lax.sort((lf4, iota), num_keys=1)
        lf8, q4 = _apply_perm(i4, lf4, c4)
        c8 = c4 | (q4 << 16)
        if rate % 16 == 0:
            # k=16, 12-byte rows: one more composition round folds two
            # 8-step words per gather — fewer row bytes per symbol, and
            # the walk does half the sequential rounds
            _, i8 = jax.lax.sort((lf8, iota), num_keys=1)
            lf16, q8 = _apply_perm(i8, lf8, c8)
            lfk_tab = jnp.stack([lf16.astype(jnp.uint32), c8, q8], axis=1)
            return block._replace(lf_tab=tab, lfk_tab=lfk_tab, lfk_k=16)
        lfk_tab = jnp.stack([lf8.astype(jnp.uint32), c8], axis=1)
        return block._replace(lf_tab=tab, lfk_tab=lfk_tab, lfk_k=8)

    sym32 = block.bwt.astype(jnp.uint32)
    _, i1 = jax.lax.sort((lf, iota), num_keys=1)
    lf2, t1 = _apply_perm(i1, lf, sym32)
    s2 = sym32 | (t1 << 8)
    _, i2 = jax.lax.sort((lf2, iota), num_keys=1)
    lf4, t2 = _apply_perm(i2, lf2, s2)
    s4 = s2 | (t2 << 16)
    lfk_tab = jnp.stack([lf4.astype(jnp.uint32), s4], axis=1)
    return block._replace(lf_tab=tab, lfk_tab=lfk_tab, lfk_k=4)


def _lf_from_row(block: DeviceFMBlock, v):
    """LF value out of a fused-table row (strips the bit-31 mark bit)."""
    if block.lf_packed:
        return ((v >> 8) & jnp.uint32(0x7FFFFF)).astype(jnp.int32)
    return (v & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)


def _lf_step(block: DeviceFMBlock, idx):
    """(next_idx, symbol) via the fused table, batched."""
    v = block.lf_tab[idx]
    if block.lf_packed:
        return _lf_from_row(block, v), (v & 255).astype(jnp.uint8)
    return _lf_from_row(block, v), block.bwt[idx]


def _lf_next(block: DeviceFMBlock, idx):
    """Next row only (locate walks don't need the symbol: 4-byte gather)."""
    return _lf_from_row(block, block.lf_tab[idx])


def _bit_plane(bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """0/1 array -> (uint32 words, int32 per-word exclusive rank prefix)."""
    n = len(bits)
    W = (n + 31) // 32
    packed = np.packbits(bits.astype(np.uint8), bitorder="little")
    words = np.zeros(W * 4, dtype=np.uint8)
    words[:len(packed)] = packed
    words = words.view(np.uint32)
    pc = np.bitwise_count(words).astype(np.int64)
    pre = np.zeros(W, dtype=np.int64)
    np.cumsum(pc[:-1], out=pre[1:])
    return words, pre.astype(np.int32)


def build_device_block(bwt: np.ndarray, sampled_rows: np.ndarray,
                       ssa_perm: np.ndarray, sf: int,
                       wrap_row: int) -> DeviceFMBlock:
    """Assemble device query state (host-side packing, one pass per symbol)."""
    bwt = np.asarray(bwt, dtype=np.uint8)
    n = len(bwt)
    counts = np.bincount(bwt, minlength=256).astype(np.int64)
    live = np.flatnonzero(counts > 0)
    if len(live) > MAX_PLANES:
        raise ValueError(
            f"alphabet of {len(live)} symbols exceeds the plane engine; "
            "use the host FMIndex path")
    sym_plane = np.full(256, -1, dtype=np.int32)
    planes = []
    pres = []
    for row, s in enumerate(live):
        sym_plane[s] = row
        w, p = _bit_plane(bwt == s)
        planes.append(w)
        pres.append(p)
    c = np.zeros(257, dtype=np.int64)
    np.cumsum(counts, out=c[1:])

    mark_bits = np.zeros(n, dtype=np.uint8)
    mark_bits[sampled_rows] = 1
    mark_words, mark_pre = _bit_plane(mark_bits)
    mark_rows = np.sort(np.asarray(sampled_rows)).astype(np.int32)

    perm = np.asarray(ssa_perm, dtype=np.int32)
    inv = np.zeros(len(perm), dtype=np.int32)
    inv[perm] = np.arange(len(perm), dtype=np.int32)

    words_np = np.concatenate(planes)
    pres_np = np.concatenate(pres).view(np.uint32)
    if n < _PAIR_LIMIT:
        pairs = jnp.asarray(np.stack([words_np, pres_np], axis=1))
        wd, pr = jnp.zeros((0,), jnp.uint32), jnp.zeros((0,), jnp.uint32)
    else:
        pairs = jnp.zeros((0, 2), jnp.uint32)
        wd, pr = jnp.asarray(words_np), jnp.asarray(pres_np)
    return DeviceFMBlock(
        bwt=jnp.asarray(bwt),
        plane_pairs=pairs, plane_words=wd, plane_pres=pr,
        c=jnp.asarray(c.astype(np.int32)),
        sym_plane=jnp.asarray(sym_plane),
        wrap_row=jnp.asarray(np.int32(wrap_row)),
        mark_words=jnp.asarray(mark_words),
        mark_pre=jnp.asarray(mark_pre),
        mark_rows=jnp.asarray(mark_rows),
        ssa_perm=jnp.asarray(perm),
        ssa_inv=jnp.asarray(inv),
        lf_tab=jnp.zeros((0,), jnp.int32),
        lfk_tab=jnp.zeros((0, 2), jnp.uint32),
        kmer_tab=jnp.zeros((0, 2), jnp.int32),
        loc_tab=jnp.zeros((0, 2), jnp.int32),
        sf=int(sf),
    )


def device_block_from_fm(fm) -> DeviceFMBlock:
    """Lift a host FMIndex (gecoz_tpu.index.fm) onto the device."""
    rows, values = fm.index.sampled_rows()
    return build_device_block(fm.bwt, rows, np.asarray(fm.index.wsa.perm),
                              fm.index.sampling_factor, fm.wrap_row)


@functools.partial(jax.jit, static_argnames=("sf", "symbols"))
def build_device_block_parts_jit(bwt: jax.Array, mark_rows: jax.Array,
                                 perm: jax.Array, wrap_row: jax.Array,
                                 sf: int, symbols: tuple[int, ...]
                                 ) -> DeviceFMBlock:
    """Query-state construction ON DEVICE from the decode-path parts: the
    BWT plus the .gcx sampled rows/values (no suffix array needed).

    The wire-thin companion of build_device_block_jit: a decode lift
    transfers only the (packed) BWT and two m = ceil(n/rate) int32
    arrays (~n/4 + n/8 bytes) instead of host-built planes + bwt
    (~2.7n bytes).
    """
    n = bwt.shape[0]
    m = perm.shape[0]

    planes, pres, totals = [], [], []
    sym_plane = np.full(256, -1, dtype=np.int32)
    for row, s in enumerate(symbols):
        sym_plane[s] = row
        w, p = _plane_jit(bwt == jnp.uint8(s))
        planes.append(w)
        pres.append(p)
        totals.append(p[-1] + jax.lax.population_count(w[-1]).astype(
            jnp.int32))
    counts = jnp.zeros((256,), jnp.int32).at[
        jnp.asarray(symbols, dtype=jnp.int32)].set(jnp.stack(totals))
    c = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                         jnp.cumsum(counts).astype(jnp.int32)])

    marked = jnp.zeros((n,), jnp.uint8).at[mark_rows].set(1)
    mark_words, mark_pre = _plane_jit(marked)
    inv = jnp.zeros((m,), jnp.int32).at[perm].set(
        jnp.arange(m, dtype=jnp.int32))

    words_all = jnp.concatenate(planes)
    pres_all = jnp.concatenate(pres).astype(jnp.uint32)
    if n < _PAIR_LIMIT:
        pairs_v = jnp.stack([words_all, pres_all], axis=1)
        words_v = jnp.zeros((0,), jnp.uint32)
        pres_v = jnp.zeros((0,), jnp.uint32)
    else:
        pairs_v = jnp.zeros((0, 2), jnp.uint32)
        words_v, pres_v = words_all, pres_all
    return DeviceFMBlock(
        bwt=bwt, plane_pairs=pairs_v, plane_words=words_v,
        plane_pres=pres_v,
        c=c, sym_plane=jnp.asarray(sym_plane),
        wrap_row=wrap_row.astype(jnp.int32),
        mark_words=mark_words, mark_pre=mark_pre,
        mark_rows=mark_rows.astype(jnp.int32),
        ssa_perm=perm.astype(jnp.int32), ssa_inv=inv,
        lf_tab=jnp.zeros((0,), jnp.int32),
        lfk_tab=jnp.zeros((0, 2), jnp.uint32),
        kmer_tab=jnp.zeros((0, 2), jnp.int32),
        loc_tab=jnp.zeros((0, 2), jnp.int32), sf=int(sf))


def device_block_from_fm_packed(fm) -> tuple[DeviceFMBlock,
                                             tuple[int, ...]]:
    """Lift a host FMIndex with packed transfers: 2-bit+runs BWT upload
    (utils/xfer) + the two small .gcx arrays, planes/marks/c built on
    device.  Returns (block, live symbol tuple) — the symbols also drive
    the packed text fetch."""
    from gecoz_tpu.utils import xfer

    counts = fm.hswt.symbol_counts()
    symbols = tuple(int(x) for x in np.flatnonzero(counts))
    if len(symbols) > MAX_PLANES:
        raise ValueError(
            f"alphabet of {len(symbols)} symbols exceeds the plane engine")
    rows, _ = fm.index.sampled_rows()
    bwt_dev = xfer.put_packed(fm.bwt, np.asarray(counts, np.int64))
    block = build_device_block_parts_jit(
        bwt_dev, jnp.asarray(np.sort(rows).astype(np.int32)),
        jnp.asarray(np.asarray(fm.index.wsa.perm, np.int32)),
        jnp.asarray(np.int32(fm.wrap_row)),
        sf=int(fm.index.sampling_factor), symbols=symbols)
    return block, symbols


def fetch_text_packed(text_dev, symbols: tuple[int, ...], n: int
                      ) -> np.ndarray:
    """Device -> host text fetch at 4 bits/symbol (2x fewer bytes over
    the host link)."""
    from gecoz_tpu.utils import xfer

    pack = jax.jit(xfer.pack_nibbles_device, static_argnames=("symbols",))
    packed = pack(text_dev, symbols=symbols)
    return xfer.unpack_nibbles_host(np.asarray(packed), symbols, n)


def _pack_bits_jit(bits: jax.Array) -> jax.Array:
    """0/1 (any int/bool dtype) [n] -> uint32 words [ceil(n/32)],
    LSB-first (on device)."""
    n = bits.shape[0]
    W = (n + 31) // 32
    pad = W * 32 - n
    b = bits.astype(jnp.uint32)
    if pad:
        b = jnp.concatenate([b, jnp.zeros((pad,), jnp.uint32)])
    b = b.reshape(W, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(b * weights[None, :], axis=1, dtype=jnp.uint32)


def _plane_jit(bits: jax.Array) -> tuple[jax.Array, jax.Array]:
    words = _pack_bits_jit(bits)
    pc = jax.lax.population_count(words).astype(jnp.int32)
    pre = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                           jnp.cumsum(pc)[:-1].astype(jnp.int32)])
    return words, pre


def build_device_block_jit(bwt: jax.Array, sa: jax.Array, sf: int,
                           symbols: tuple[int, ...]) -> DeviceFMBlock:
    """Fully on-device query-state construction (jittable).

    `symbols` is the static alphabet (plane order); symbols outside it must
    not occur in `bwt`.  The sampled-row count is exactly ceil(n/rate)
    (multiples of the rate in a permutation of 0..n-1), so all shapes are
    static.
    """
    n = bwt.shape[0]
    rate = 1 << sf
    m = (n + rate - 1) // rate

    planes = []
    pres = []
    totals = []
    sym_plane = np.full(256, -1, dtype=np.int32)
    for row, s in enumerate(symbols):
        sym_plane[s] = row
        w, p = _plane_jit(bwt == jnp.uint8(s))
        planes.append(w)
        pres.append(p)
        totals.append(p[-1] + jax.lax.population_count(w[-1]).astype(
            jnp.int32))

    # symbol counts fall out of the plane popcounts — no n-wide bincount
    counts = jnp.zeros((256,), jnp.int32).at[
        jnp.asarray(symbols, dtype=jnp.int32)].set(jnp.stack(totals))
    c = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                         jnp.cumsum(counts).astype(jnp.int32)])

    marked = (sa & (rate - 1)) == 0
    mark_words, mark_pre = _plane_jit(marked)
    if _scatter_is_cheap():
        (rows,) = jnp.nonzero(marked, size=m, fill_value=0)
        perm = (sa[rows] >> sf).astype(jnp.int32)
        mark_rows = rows.astype(jnp.int32)
    else:
        # sampled values in row order via one partition sort (marked rows
        # first) instead of nonzero + gather.  The (not-marked, row) key pair packs into one int31 word (rows
        # < 2^30 by the block-size contract), so the sort carries only
        # two operands; the low bits of the sorted key are the select-1
        # table
        iota = jnp.arange(sa.shape[0], dtype=jnp.int32)
        pkey = ((~marked).astype(jnp.int32) << 30) | iota
        keys_s, vals = jax.lax.sort((pkey, sa >> sf), num_keys=1)
        perm = vals[:m].astype(jnp.int32)
        mark_rows = (keys_s[:m] & ((1 << 30) - 1)).astype(jnp.int32)
    inv = jnp.zeros((m,), jnp.int32).at[perm].set(
        jnp.arange(m, dtype=jnp.int32))
    wrap = jnp.argmax(sa == 0).astype(jnp.int32)

    words_all = jnp.concatenate(planes)
    pres_all = jnp.concatenate(pres).astype(jnp.uint32)
    if n < _PAIR_LIMIT:
        pairs_v = jnp.stack([words_all, pres_all], axis=1)
        words_v = jnp.zeros((0,), jnp.uint32)
        pres_v = jnp.zeros((0,), jnp.uint32)
    else:
        pairs_v = jnp.zeros((0, 2), jnp.uint32)
        words_v, pres_v = words_all, pres_all
    return DeviceFMBlock(
        bwt=bwt, plane_pairs=pairs_v, plane_words=words_v,
        plane_pres=pres_v,
        c=c, sym_plane=jnp.asarray(sym_plane), wrap_row=wrap,
        mark_words=mark_words, mark_pre=mark_pre, mark_rows=mark_rows,
        ssa_perm=perm, ssa_inv=inv,
        lf_tab=jnp.zeros((0,), jnp.int32),
        lfk_tab=jnp.zeros((0, 2), jnp.uint32),
        kmer_tab=jnp.zeros((0, 2), jnp.int32),
        loc_tab=jnp.zeros((0, 2), jnp.int32), sf=sf)


# -- primitive rank ---------------------------------------------------------

def _rank_words(words, pre, pos):
    """Inclusive rank in one plane at positions `pos` (>=0)."""
    w = pos >> 5
    word = words[w]
    mask = (jnp.uint32(2) << (pos & 31).astype(jnp.uint32)) - jnp.uint32(1)
    return pre[w] + jax.lax.population_count(word & mask).astype(jnp.int32)


def occ_inclusive(block: DeviceFMBlock, syms, pos):
    """Count of `syms` in BWT[0..pos] (0 when pos < 0), batched.

    One 2-wide gather per lookup: the bit word and its rank prefix live
    side by side in `plane_pairs`.
    """
    row = block.sym_plane[syms]
    safe_row = jnp.maximum(row, 0)
    p = jnp.maximum(pos, 0)
    w = p >> 5
    base = safe_row * block.W + w
    if block.plane_pairs.shape[0]:
        # fused pairs: ONE 8-byte row gather per occ
        pair = block.plane_pairs[base]
        word = pair[..., 0]
        pre = pair[..., 1].astype(jnp.int32)
    else:
        # large blocks: two plain 4-byte gathers from the flat arrays
        word = block.plane_words[base]
        pre = block.plane_pres[base].astype(jnp.int32)
    mask = (jnp.uint32(2) << (p & 31).astype(jnp.uint32)) - jnp.uint32(1)
    cnt = pre + jax.lax.population_count(word & mask).astype(jnp.int32)
    return jnp.where((pos < 0) | (row < 0), 0, cnt)


def lf_batch(block: DeviceFMBlock, idx):
    """Corrected LF mapping for rows `idx` (batched)."""
    if block.has_lf:
        return _lf_next(block, idx)
    syms = block.bwt[idx].astype(jnp.int32)
    occ = occ_inclusive(block, syms, idx)       # inclusive, >= 1
    plain = block.c[syms] + occ - 1
    sep = 1 + (occ - 1) - (block.wrap_row < idx).astype(jnp.int32)
    out = jnp.where(syms == 0, sep, plain)
    return jnp.where(idx == block.wrap_row, 0, out)


# -- backward search --------------------------------------------------------

def _kmer_offset(bits: int, j: int) -> int:
    """Start row of the length-j level in the stacked k-mer table."""
    return sum(1 << (bits * i) for i in range(1, j))


def with_kmer_table(block: DeviceFMBlock, k: int | None = None
                    ) -> DeviceFMBlock:
    """Attach the stacked k-mer seed table (jittable).

    Level j holds (sp, ep) after backward-searching every plane-coded
    string of length j, for j = 1..k; a query's last min(len, k)
    characters are then ONE table lookup instead of min(len, k)-1 search
    steps (each of which costs two occ gathers per live query).  Built
    bottom-up: level j+1 extends level j by one earlier character, all
    codes stepped in one vectorized occ batch — ~2^(bits*k) gathers
    total, amortized over every future search against the block.
    """
    if block.n == 0 or block.has_kmer:
        return block
    nplanes = (block.plane_pairs.shape[0]
               or block.plane_words.shape[0]) // max(block.W, 1)
    bits = max(1, (nplanes - 1).bit_length())
    if k is None:
        # table capped at ~2^19 rows for small blocks, 2^24 for blocks
        # >= 4 MiB: at genomic sigma (6 planes -> 3 bits) that is k = 8,
        # so a 16-mer runs 8 lockstep occ rounds instead of 9 — each
        # seeded character removes a full 2-gathers-per-query round, and
        # the ~150 MB level-8 table amortizes over every search batch
        # against the block
        cap = 24 if block.n >= (1 << 22) else 19
        k = max(1, min(8, cap // bits,
                       int(max(block.n, 2)).bit_length() // bits))
    # inverse plane map: plane row -> symbol byte
    rows = block.sym_plane
    plane_sym = jnp.zeros((1 << bits,), jnp.int32).at[
        jnp.where(rows >= 0, rows, 1 << bits)].set(
        jnp.arange(256, dtype=jnp.int32), mode="drop")

    levels = []
    # level 1: all single symbols
    syms1 = plane_sym[jnp.arange(1 << bits, dtype=jnp.int32)]
    sp = block.c[syms1]
    ep = block.c[syms1 + 1] - 1
    levels.append(jnp.stack([sp, ep], axis=1))
    for j in range(1, k):
        codes = jnp.arange(1 << (bits * (j + 1)), dtype=jnp.int32)
        prev = levels[j - 1][codes & ((1 << (bits * j)) - 1)]
        ch = plane_sym[codes >> (bits * j)]     # the added, earlier char
        sp, ep = prev[:, 0], prev[:, 1]
        nsp = block.c[ch] + occ_inclusive(block, ch, sp - 1)
        nep = block.c[ch] + occ_inclusive(block, ch, ep) - 1
        dead = sp > ep
        levels.append(jnp.stack([jnp.where(dead, sp, nsp),
                                 jnp.where(dead, ep, nep)], axis=1))
    return block._replace(kmer_tab=jnp.concatenate(levels, axis=0),
                          kmer_bits=bits, kmer_k=k)


@functools.partial(jax.jit, static_argnames=())
def search_batch(block: DeviceFMBlock, patterns: jax.Array,
                 lengths: jax.Array):
    """Backward-search many patterns in lockstep.

    `patterns` is uint8 [B, L] right-aligned (last character at column L-1,
    leading columns zero-padded); `lengths` is int32 [B].  Returns (sp, ep)
    inclusive row ranges; ep < sp means no match.

    With a k-mer table attached, each query's last min(len, k) characters
    resolve in one 8-byte gather and the lockstep loop shrinks from L-1 to
    L-k steps.
    """
    B, L = patterns.shape

    if block.has_kmer and L > 1:
        bits, k = block.kmer_bits, min(block.kmer_k, L)
        # plane-code of the last k characters, char at column L-1-t at
        # bit position bits*t (so the last j chars are the low bits*j bits)
        code = jnp.zeros((B,), jnp.int32)
        bad = jnp.zeros((B,), jnp.bool_)
        for t in range(k):
            row = block.sym_plane[patterns[:, L - 1 - t].astype(jnp.int32)]
            code = code | (jnp.maximum(row, 0) << (bits * t))
            # a symbol absent from the block, within the query: no match
            bad = bad | ((row < 0) & (t < lengths))
        j = jnp.clip(lengths, 1, k)
        code = code & ((1 << (bits * j)) - 1)
        offs = jnp.asarray(
            np.array([_kmer_offset(bits, int(jj)) for jj in range(k + 2)],
                     dtype=np.int32))
        seed = block.kmer_tab[offs[j] + code]
        sp0 = jnp.where(bad, 1, seed[:, 0])
        ep0 = jnp.where(bad, 0, seed[:, 1])
        start_col = L - k                 # first unconsumed column
    else:
        last = patterns[:, L - 1].astype(jnp.int32)
        sp0 = block.c[last]
        ep0 = block.c[last + 1] - 1
        start_col = L - 1

    def body(i, state):
        sp, ep = state
        col = start_col - 1 - i
        ch = patterns[:, col].astype(jnp.int32)
        active = (col >= L - lengths) & (sp <= ep)
        nsp = block.c[ch] + occ_inclusive(block, ch, sp - 1)
        nep = block.c[ch] + occ_inclusive(block, ch, ep) - 1
        sp = jnp.where(active, nsp, sp)
        ep = jnp.where(active, nep, ep)
        return sp, ep

    sp, ep = jax.lax.fori_loop(0, start_col, body, (sp0, ep0))
    return sp, ep


# -- locate -----------------------------------------------------------------

def _sampled_value(block: DeviceFMBlock, idx):
    """(is_sampled, sa_value) for rows idx."""
    w = idx >> 5
    bit = (block.mark_words[w] >> (idx & 31).astype(jnp.uint32)) & 1
    rank = _rank_words(block.mark_words, block.mark_pre, idx)
    val = block.ssa_perm[jnp.maximum(rank - 1, 0)].astype(jnp.int32) << block.sf
    return bit.astype(jnp.bool_), val


@jax.jit
def locate_batch(block: DeviceFMBlock, rows: jax.Array):
    """SA values for `rows`: batched LF walks to the nearest sample
    (<= 2^sf steps by construction).

    With the fused table attached, each step is ONE 4-byte gather: the
    row's bit 31 says "sampled here" (set at table build), so the
    rank/perm lookups that turn a sampled row into its SA value run once,
    after every walk has stopped — not once per step per lane."""
    rate = 1 << block.sf
    steps = jnp.zeros(rows.shape, jnp.int32)

    if block.has_loc:
        # precomputed walk: one 8-byte row gather per query, then the
        # sampled-value lookup once for the whole batch
        row = block.loc_tab[rows]
        _, val = _sampled_value(block, row[:, 0])
        return val + row[:, 1]

    if block.has_lf:
        hit_idx = jnp.zeros(rows.shape, jnp.int32)
        live = jnp.ones(rows.shape, jnp.bool_)

        def body(_, state):
            idx, steps, hit_idx, live = state
            v = block.lf_tab[idx]
            sampled = (v >> 31) != 0
            hit = live & sampled
            hit_idx = jnp.where(hit, idx, hit_idx)
            live = live & ~sampled
            idx = jnp.where(live, _lf_from_row(block, v), idx)
            steps = steps + live.astype(jnp.int32)
            return idx, steps, hit_idx, live

        _, steps, hit_idx, live = jax.lax.fori_loop(
            0, rate + 1, body, (rows, steps, hit_idx, live))
        _, val = _sampled_value(block, hit_idx)
        return jnp.where(live, -1, val + steps)

    out = jnp.full(rows.shape, -1, jnp.int32)
    live = jnp.ones(rows.shape, jnp.bool_)

    def body(_, state):
        idx, steps, out, live = state
        sampled, val = _sampled_value(block, idx)
        hit = live & sampled
        out = jnp.where(hit, val + steps, out)
        live = live & ~sampled
        nxt = lf_batch(block, idx)
        idx = jnp.where(live, nxt, idx)
        steps = steps + live.astype(jnp.int32)
        return idx, steps, out, live

    _, _, out, _ = jax.lax.fori_loop(
        0, rate + 1, body, (rows, steps, out, live))
    return out


# -- full-text decode -------------------------------------------------------

@jax.jit
def decode_text_jit(block: DeviceFMBlock):
    """Reconstruct the whole generalized string on device.

    One walk per sampling interval: walk w covers positions
    [w*rate, (w+1)*rate) and is seeded at the sampled row with SA value
    (w+1)*rate, so step j of every full walk writes column rate-1-j — a
    pure column store, no scatter.  The ragged tail [W*rate, n) rides
    along as one extra walk seeded at row 0 (SA value n-1) whose early
    steps burn down to the tail end; its partial emits are fixed up at
    the end.  All walks advance in lockstep: ~rate rounds of [n/rate]-wide
    gathers.
    """
    n = block.n
    rate = 1 << block.sf
    W = (n - 1) // rate                  # full walks
    tail_lo = W * rate                   # tail covers [tail_lo, n-1)
    tail_len = (n - 1) - tail_lo         # 0 <= tail_len < rate

    widx = jnp.arange(W, dtype=jnp.int32)
    seeds = _row_with_sa(block, (widx + 1) * rate)

    def step(idx):
        if block.has_lf:
            return _lf_step(block, idx)
        return lf_batch(block, idx), block.bwt[idx]

    if W and block.has_lfk and rate % block.lfk_steps == 0:
        # k positions per 8-byte fused-table gather: each round emits one
        # k-wide column block from the packed symbol word (ascending
        # column = descending LF step), rounds concatenated in reverse
        k = block.lfk_steps
        if k in (8, 16):
            # inverse plane map as 16 tiny reductions (no gather): the
            # byte whose plane row is r
            idx256 = jnp.arange(256, dtype=jnp.uint32)
            inv = [jnp.sum(jnp.where(block.sym_plane == r, idx256, 0))
                   for r in range(16)]

            def plane_cols(sw, kk):
                # kk 4-bit plane codes, step j at bits 4j — latest first
                codes = jnp.stack(
                    [(sw >> (4 * j)) & 15 for j in range(kk - 1, -1, -1)],
                    axis=1)
                syms = jnp.zeros_like(codes)
                for r in range(16):
                    syms = jnp.where(codes == r, inv[r], syms)
                return syms.astype(jnp.uint8)
        cols = []
        idx = seeds
        for _ in range(rate // k):
            row = block.lfk_tab[idx]
            sw = row[..., 1]
            if k == 16:
                # steps 8..15 in word 2, steps 0..7 in word 1: latest
                # first means word-2 columns precede word-1 columns
                cols.append(jnp.concatenate(
                    [plane_cols(row[..., 2], 8), plane_cols(sw, 8)],
                    axis=1))
            elif k == 8:
                cols.append(plane_cols(sw, 8))
            else:
                cols.append(jnp.stack(
                    [(sw >> 24).astype(jnp.uint8),
                     ((sw >> 16) & 255).astype(jnp.uint8),
                     ((sw >> 8) & 255).astype(jnp.uint8),
                     (sw & 255).astype(jnp.uint8)], axis=1))
            idx = row[..., 0].astype(jnp.int32)
        out = jnp.concatenate(cols[::-1], axis=1)
    elif W:
        out = jnp.zeros((W, rate), dtype=jnp.uint8)

        def body(j, state):
            idx, out = state
            nxt, sym = step(idx)
            return nxt, out.at[:, rate - 1 - j].set(sym)

        _, out = jax.lax.fori_loop(0, rate, body, (seeds, out))
    else:
        out = jnp.zeros((0, rate), dtype=jnp.uint8)

    # tail walk: start at row 0 (suffix n-1); step j emits position n-2-j,
    # covering [tail_lo, n-2] — tail_len is static, so no masking needed
    tail_out = jnp.zeros((rate,), dtype=jnp.uint8)
    if tail_len:
        def tbody(j, state):
            tidx, tail_out = state
            tnxt, tsym = step(tidx)
            return tnxt, tail_out.at[tail_len - 1 - j].set(tsym[0])

        _, tail_out = jax.lax.fori_loop(
            0, tail_len, tbody, (jnp.zeros((1,), jnp.int32), tail_out))

    text = jnp.concatenate([
        out.reshape(-1),
        tail_out[:max(tail_len, 0)] if tail_len else jnp.zeros((0,), jnp.uint8),
        jnp.zeros((1,), jnp.uint8),      # final terminator at n-1
    ])
    return text[:n]


def _row_with_sa(block: DeviceFMBlock, value):
    """Row whose SA value is `value` (a sampled multiple of the rate):
    two small gathers through the select table, batched."""
    j = block.ssa_inv[value >> block.sf]
    return block.mark_rows[j]


def decode_text_device(fm) -> np.ndarray:
    """Host entry: lift an FMIndex to device, decode, return numpy text.

    Decode is the XLA fused-LF^k path (`decode_text_jit`).
    """
    block = jax.jit(with_lf_table)(device_block_from_fm(fm))
    return np.asarray(decode_text_jit(block))
