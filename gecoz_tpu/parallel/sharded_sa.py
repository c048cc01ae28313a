"""Sharded suffix sort: blocks larger than one device's memory.

This is the explicit in-block 'seq'-axis distribution (SURVEY §5
long-context: the reference's analogous limit is the int32 SA,
SAIS.java:103).  GSPMD does NOT distribute `lax.sort` along the sorted
dimension — it all-gathers the operands onto every device (verified: a
sharded 4 MiB sort compiles to per-device temp == the full array), so a
suffix sort whose working set exceeds one device's memory needs a hand-authored
distributed sort.  Everything here is `shard_map` over a 1-D device axis;
per-device memory is O(n / D) with only
  * full-shard neighbor exchanges (`ppermute`),
  * [1]-element boundary fetches, and
  * [D]-element all-gathers of per-shard scalars
as communication.

Algorithm
---------
* Distributed sort = odd-even transposition over device blocks: each
  device keeps its shard locally sorted; D rounds of pairwise
  exchange-merge-split (pair sorts 2L elements, low rank keeps the lower
  half) yield a globally sorted, block-distributed array (block-level 0-1
  principle).  All shifts and permutation-scatters are expressed as
  value-carrying sorts — the same "sorts instead of random memory
  access" stance as the single-device kernels (ops/sa_device.py).
* Two suffix-array variants over that sort, mirroring the single-chip
  pair (ops/sa_device.py):
  - 'kmer': dense-packed k-mer seeding + prefix doubling with global
    re-ranking.  Optimal on run-free text, but pays ~log2(longest
    equal-symbol run) extra rounds on real genomes.
  - 'runs': exact run-key seeding ((c, side, ±ell) per position — a run
    of ANY length is fully ordered by the seed sort), compaction to the
    run-token string (one value-carrying sort), prefix doubling over
    TOKENS (so refinement jumps run-by-run), and a final
    (seed-rank, next-run-rank) sort that carries the BWT as a value
    operand.  The run-wide broadcast of the next-run rank is a placement
    sort + chunked segmented cummax fill — no cross-shard gathers.
  'auto' picks by the longest equal-symbol run, like the single-chip
  dispatcher (megabase N runs are exactly the blocks big enough to need
  sharding).

The single-chip path (ops/sa_device.py) stays optimal for blocks that fit
one device; this module is the capacity escape hatch and the multi-chip
scaling axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
try:                                    # jax >= 0.4.35 stable location
    from jax import shard_map
except ImportError:                     # older jax
    from jax.experimental.shard_map import shard_map


# -- collective building blocks (inside shard_map) ---------------------------

def _prev_last(x: jax.Array, axis: str, D: int, fill) -> jax.Array:
    """[1]: previous device's last element (device 0 gets `fill`)."""
    got = jax.lax.ppermute(x[-1:], axis, [(i, i + 1) for i in range(D - 1)])
    idx = jax.lax.axis_index(axis)
    return jnp.where(idx == 0, jnp.full((1,), fill, x.dtype), got)


def _next_head(x: jax.Array, t: int, axis: str, D: int, fill) -> jax.Array:
    """[t]: next device's first t elements (last device gets `fill`)."""
    got = jax.lax.ppermute(x[:t], axis, [(i + 1, i) for i in range(D - 1)])
    idx = jax.lax.axis_index(axis)
    return jnp.where(idx == D - 1, jnp.full((t,), fill, x.dtype), got)


def _shift_small(x: jax.Array, t: int, axis: str, D: int, fill) -> jax.Array:
    """x[i + t] with `fill` past the global end; static t < L."""
    if t == 0:
        return x
    return jnp.concatenate([x[t:], _next_head(x, t, axis, D, fill)])


def _global_cumsum(x: jax.Array, axis: str, D: int) -> jax.Array:
    """Inclusive cumsum over the global (concatenated) array."""
    loc = jnp.cumsum(x)
    totals = jax.lax.all_gather(loc[-1:], axis).reshape(D)
    idx = jax.lax.axis_index(axis)
    prefix = jnp.sum(jnp.where(jnp.arange(D) < idx, totals, 0))
    return loc + prefix


def _global_cummax(x: jax.Array, axis: str, D: int) -> jax.Array:
    """Inclusive forward cummax over the global array (shard-local scan +
    one [D]-scalar all-gather carry)."""
    loc = jax.lax.cummax(x)
    tops = jax.lax.all_gather(loc[-1:], axis).reshape(D)
    idx = jax.lax.axis_index(axis)
    lo = jnp.iinfo(x.dtype).min
    prev = jnp.max(jnp.where(jnp.arange(D) < idx, tops, lo))
    return jnp.maximum(loc, prev)


def _global_cummin_rev(x: jax.Array, axis: str, D: int) -> jax.Array:
    """Inclusive REVERSE cummin over the global array."""
    loc = jax.lax.cummin(x, reverse=True)
    heads = jax.lax.all_gather(loc[:1], axis).reshape(D)
    idx = jax.lax.axis_index(axis)
    hi = jnp.iinfo(x.dtype).max
    nxt = jnp.min(jnp.where(jnp.arange(D) > idx, heads, hi))
    return jnp.minimum(loc, nxt)


def sorted_sharded(operands: tuple, num_keys: int, axis: str,
                   D: int) -> tuple:
    """Globally sort equally-sharded operands; result block-distributed
    (device d holds global slice [d*L, (d+1)*L)).

    A block-level SORTING NETWORK with compare-exchange lifted to
    exchange-merge-split (each device keeps its shard locally sorted;
    a comparator sorts the 2L-element pair and the designated side keeps
    the lower half — valid for any sorting network by the blockwise 0-1
    principle).  Power-of-two device counts use the BITONIC network:
    log2(D)(log2(D)+1)/2 exchange rounds (6 at D=8, 36 at D=256) over
    hypercube partners; other counts fall back to odd-even transposition
    (D rounds, nearest-neighbor only).

    REQUIREMENT: the first `num_keys` operands must form a globally
    DISTINCT total order.  The two sides of an exchange merge the same
    multiset in different concatenation orders; with tied keys their
    stable sorts route tied elements differently, so one side's lower
    half and the other's upper half can double-keep / drop an element.
    Callers append a unique tiebreaker (the position) as the last key.
    """
    ops = jax.lax.sort(operands, num_keys=num_keys)
    if D == 1:
        return ops
    L = ops[0].shape[0]
    idx = jax.lax.axis_index(axis)

    def exchange(ops, perm, keep_low):
        recv = tuple(jax.lax.ppermute(a, axis, perm) for a in ops)
        cat = tuple(jnp.concatenate([a, r]) for a, r in zip(ops, recv))
        merged = jax.lax.sort(cat, num_keys=num_keys)
        return tuple(jnp.where(keep_low, m[:L], m[L:]) for m in merged)

    if D & (D - 1) == 0:
        # bitonic: phase k builds sorted runs of 2^k blocks; stage j pairs
        # devices at hypercube distance 2^j; direction flips with bit k
        logd = D.bit_length() - 1
        for k in range(1, logd + 1):
            for j in range(k - 1, -1, -1):
                dist = 1 << j
                perm = [(i, i ^ dist) for i in range(D)]
                asc = ((idx >> k) & 1) == 0
                is_lower = (idx & dist) == 0
                ops = exchange(ops, perm, asc == is_lower)
        return ops

    for rnd in range(D):
        if rnd % 2 == 0:
            pairs = [(i, i + 1) for i in range(0, D - 1, 2)]
        else:
            pairs = [(i, i + 1) for i in range(1, D - 1, 2)]
        perm = []
        lo = jnp.zeros((), jnp.bool_)
        hi = jnp.zeros((), jnp.bool_)
        for a, b in pairs:
            perm += [(a, b), (b, a)]
            lo = lo | (idx == a)
            hi = hi | (idx == b)
        recv = tuple(jax.lax.ppermute(a, axis, perm) for a in ops)
        cat = tuple(jnp.concatenate([a, r]) for a, r in zip(ops, recv))
        merged = jax.lax.sort(cat, num_keys=num_keys)
        ops = tuple(
            jnp.where(lo, m[:L], jnp.where(hi, m[L:], o))
            for m, o in zip(merged, ops))
    return ops


# -- suffix-array building blocks ---------------------------------------------

def _shift_k(rank: jax.Array, k, ig: jax.Array, n: int, axis: str,
             D: int, limit=None) -> jax.Array:
    """rank[i + k] with -1 past position `limit` (default the global end);
    traced k.

    A shift is a ROTATION of the block-distributed array, not a sort:
    rotate left by k // L whole shards (one conditional ppermute per bit
    of the shard count), then slide the k % L remainder off the next
    shard (one ppermute + a local dynamic slice).  ~log2(D) + 1 ppermutes
    versus the full distributed sort a generic permutation would need.
    """
    L = rank.shape[0]
    k = jnp.asarray(k, jnp.int32)
    q = k // L
    r = k - q * L
    y = rank
    for b in range(max(1, (D - 1).bit_length())):
        amt = 1 << b
        rotated = jax.lax.ppermute(
            y, axis, [(i, (i - amt) % D) for i in range(D)])
        y = jnp.where(((q >> b) & 1) == 1, rotated, y)
    nxt = jax.lax.ppermute(y, axis, [(i, (i - 1) % D) for i in range(D)])
    y = jax.lax.dynamic_slice(jnp.concatenate([y, nxt]), (r,), (L,))
    end = jnp.int32(n if limit is None else limit)
    return jnp.where(ig < end - k, y, jnp.int32(-1))


def _sort_rerank_n(keys: tuple, pos, vals: tuple, n: int, axis: str,
                   D: int):
    """Sort by (*keys, pos) — pos is the distinctness tiebreaker, making
    the whole pipeline effectively stable; dense re-rank ignores it.
    `vals` ride the sort.  Returns (rank_by_position, pos_in_rank_order,
    vals_in_rank_order, all_distinct).

    Wider key tuples are for rounds OUTSIDE while_loop only (see
    ops/sa_device.py)."""
    nk = len(keys)
    ops = sorted_sharded(tuple(keys) + (pos,) + tuple(vals), nk + 1,
                         axis, D)
    ks, pos_s = ops[:nk], ops[nk]
    vals_s = ops[nk + 1:]
    diff = jnp.zeros(ks[0].shape, jnp.bool_)
    for k in ks:
        p = _prev_last(k, axis, D, jnp.int32(-(2 ** 31) + 1))
        diff = diff | (k != jnp.concatenate([p, k[:-1]]))
    new_group = diff.astype(jnp.int32)
    ranks_sorted = _global_cumsum(new_group, axis, D) - 1
    done = jax.lax.pmax(ranks_sorted[-1], axis) == n - 1
    # ranks back to position order: one more value-carrying sort
    _, rank_pos = sorted_sharded((pos_s, ranks_sorted), 1, axis, D)
    return rank_pos, pos_s, vals_s, done


def _sort_rerank(key1, key2, pos, vals: tuple, n: int, axis: str, D: int):
    """2-key variant (the only width safe inside while_loop)."""
    return _sort_rerank_n((key1, key2), pos, vals, n, axis, D)


def _bwt_source(s_l, ig, n_r, axis: str, D: int) -> jax.Array:
    """Previous byte, cyclic over the REAL text (the BWT gather operand)."""
    s32 = s_l.astype(jnp.int32)
    p = _prev_last(s32, axis, D, 0)
    sp = jnp.concatenate([p, s32[:-1]])
    last_real = jax.lax.pmax(
        jnp.max(jnp.where(ig == n_r - 1, s32, -1)), axis)
    return jnp.where(ig == 0, last_real, sp)


# -- the jitted sharded kernels ------------------------------------------------

@functools.partial(jax.jit, static_argnames=("mesh", "axis", "symbols"))
def _suffix_array_sharded_jit(s: jax.Array, n_real: jax.Array, *,
                              mesh: Mesh, axis: str,
                              symbols: tuple[int, ...]):
    """K-mer-seeded variant.  Padded input [n] (multiple of D, sharded
    along `axis`) -> (sa, bwt), both in suffix-rank order,
    block-distributed.

    Positions >= n_real are padding and read as code 0 (below every real
    symbol), so they occupy the first n - n_real rank slots in descending
    position order; the host wrapper strips them.
    """
    n = s.shape[0]
    D = mesh.shape[axis]
    table = np.zeros(256, dtype=np.int32)
    for i, sym in enumerate(sorted(symbols)):
        table[sym] = i + 1
    bits = max(1, len(symbols).bit_length())
    chars_per = max(1, 31 // bits)
    table_d = jnp.asarray(table)

    def kernel(s_l, n_real_l):
        L = s_l.shape[0]
        idx = jax.lax.axis_index(axis)
        ig = idx * L + jnp.arange(L, dtype=jnp.int32)   # global positions
        n_r = n_real_l[0]
        codes = jnp.where(ig < n_r, table_d[s_l.astype(jnp.int32)], 0)
        sprev = _bwt_source(s_l, ig, n_r, axis, D)

        # k-mer seed rank: pack chars_per dense codes into one int31 word
        rank = jnp.zeros(L, dtype=jnp.int32)
        for t in range(chars_per):
            rank = (rank << bits) | _shift_small(codes, min(t, L - 1),
                                                 axis, D, jnp.int32(0))
        zeros = jnp.zeros(L, jnp.int32)
        rank, sa_k, (bwt_k,), done = _sort_rerank(rank, zeros, ig, (sprev,),
                                                  n, axis, D)

        # k is capped at n (a shift by >= n is already the final round) so
        # the doubling never overflows int32 even for blocks past 1 GiB —
        # the kernel is valid up to the int32-SA contract (SAIS.java:103)
        kcap = jnp.int32(n)

        def body(state):
            rank, sa_k, bwt_k, k, _ = state
            r2 = _shift_k(rank, k, ig, n, axis, D)
            rank, sa_k, (bwt_k,), done = _sort_rerank(rank, r2, ig, (sprev,),
                                                      n, axis, D)
            k = jnp.where(k > kcap // 2, kcap, k * 2)
            return rank, sa_k, bwt_k, k, done

        def cond(state):
            _, _, _, k, done = state
            return jnp.logical_and(~done, k < kcap)

        _, sa_k, bwt_k, _, _ = jax.lax.while_loop(
            cond, body, (rank, sa_k, bwt_k, jnp.int32(chars_per), done))
        return sa_k, bwt_k.astype(jnp.uint8)

    fn = shard_map(kernel, mesh=mesh,
                   in_specs=(P(axis), P(None)),
                   out_specs=(P(axis), P(axis)))
    return fn(s, n_real)


@functools.partial(jax.jit, static_argnames=("mesh", "axis", "symbols"))
def _suffix_array_sharded_runs_jit(s: jax.Array, n_real: jax.Array, *,
                                   mesh: Mesh, axis: str,
                                   symbols: tuple[int, ...]):
    """Run-aware variant (the sharded port of ops/sa_device.py
    `_suffix_array_runs_jit`): run-key seeding + token-string doubling, so
    megabase equal-symbol runs cost ZERO extra rounds — refinement depth
    is counted in runs, not characters.

    Mechanics (all global ops are value-carrying distributed sorts or
    shard-local scans with [D]-scalar carries):

    * run keys: `nde`/`below` come from one global REVERSE cummin of the
      packed (run-end position << 1 | below-bit) — shard-local cummin plus
      a [D]-scalar suffix-min exchange;
    * compaction: one 1-key placement sort lands seed rank0 of the j-th
      run start at global slot j (padding slots keep inert large keys);
    * token doubling: identical loop shape to the k-mer variant, but over
      the m-token string;
    * next-run broadcast: nrank placed back at run-start positions by one
      placement sort, then a chunked segmented forward fill — each chunk
      one global cummax over (position << cb | value-chunk);
    * final order: ONE global sort by (rank0, nr) with the BWT source as
      a value operand (position rides as the distinctness key).
    """
    n = s.shape[0]
    D = mesh.shape[axis]
    if n >= 1 << 30:
        raise ValueError("run-aware sharded SA packs (position, side) "
                         "into int31; split blocks above 1 GiB")
    table = np.zeros(256, dtype=np.int32)
    for i, sym in enumerate(sorted(symbols)):
        table[sym] = i + 1
    table_d = jnp.asarray(table)

    pos_bits = max(1, (n - 1).bit_length())
    cb = 31 - pos_bits                       # value-chunk bits per fill pass
    vbits = max(1, int(n).bit_length())      # fill values in [0, n]
    chunks = -(-vbits // cb)

    def kernel(s_l, n_real_l):
        L = s_l.shape[0]
        idx = jax.lax.axis_index(axis)
        ig = idx * L + jnp.arange(L, dtype=jnp.int32)
        n_r = n_real_l[0]
        codes = jnp.where(ig < n_r, table_d[s_l.astype(jnp.int32)], 0)
        sprev = _bwt_source(s_l, ig, n_r, axis, D)

        # -- exact run keys (c, side, ±ell) ---------------------------------
        nxt = _shift_small(codes, 1, axis, D, jnp.int32(-1))
        is_end = codes != nxt                # last position of each run
        pe = _prev_last(is_end.astype(jnp.int32), axis, D, jnp.int32(1))
        is_start = jnp.concatenate(
            [pe, is_end[:-1].astype(jnp.int32)]).astype(jnp.bool_)
        run_id = _global_cumsum(is_start.astype(jnp.int32), axis, D) - 1
        m = jax.lax.pmax(run_id[-1], axis) + 1      # number of runs (traced)
        below_end = nxt < codes              # symbol after the run < c
        packed = jnp.where(is_end,
                           (ig << 1) | below_end.astype(jnp.int32),
                           jnp.int32(2) * n)
        v = _global_cummin_rev(packed, axis, D)
        nde = v >> 1                         # inclusive next run end
        below = (v & 1).astype(jnp.bool_)
        ell = nde - ig + 1                   # remaining run length >= 1
        key1 = (codes << 1) | (~below).astype(jnp.int32)
        key2 = jnp.where(below, ell, -ell)
        rank0, _, _, done0 = _sort_rerank(key1, key2, ig, (), n, axis, D)

        # -- compact to the token string: slot j = rank0 at run j's start --
        ckey = jnp.where(is_start, run_id, n + ig)
        _, tok_r, starts_full = sorted_sharded((ckey, rank0, ig), 1, axis, D)
        tok = jnp.where(ig < m, tok_r, n + ig)

        pad_key1 = jnp.int32((1 << 31) - 1) - (n - 1 - ig)

        def tshift(rank, k):
            """Token rank[j + k] with -1 past the token-string end
            (a rotation, not a sort — see _shift_k)."""
            return _shift_k(rank, k, ig, n, axis, D, limit=m)

        def trerank(keys):
            ks = ([jnp.where(ig < m, keys[0], pad_key1)]
                  + [jnp.where(ig < m, kk, 0) for kk in keys[1:]])
            rank, _, _, done = _sort_rerank_n(tuple(ks), ig, (), n,
                                              axis, D)
            return rank, done

        # Adaptive rank packing (ops/sa_device.py:247-289, distributed):
        # while the global group count G fits, 2-3 ranks pack into each
        # int32 sort key so one round covers 4k/6k tokens instead of 2k.
        # Shifts are rotations (cheap), so the extra operands cost ~4
        # ppermutes against whole distributed sort rounds saved.
        t3 = 1
        while (t3 + 1) ** 3 <= (1 << 31) - n - 2:
            t3 += 1
        t2 = 1
        while (t2 + 1) ** 2 <= (1 << 31) - n - 2:
            t2 += 1

        def packed_round(rank, k, nkeys: int = 2):
            """One token-doubling round covering up to 3*nkeys*k tokens.

            nkeys > 2 widens the distributed sort — used ONLY for the
            first round, which runs outside the while_loop."""
            B = jax.lax.pmax(
                jnp.max(jnp.where(ig < m, rank, -1)), axis) + 2

            def sh(t):
                off = jnp.where(k > n // t, jnp.int32(n), t * k)
                return tshift(rank, off) + 1
            r = [rank] + [sh(t) for t in range(1, 3 * nkeys)]
            p3 = B <= t3
            p2 = B <= t2
            keys = []
            for j in range(nkeys):
                kj3 = (r[3 * j] * B + r[3 * j + 1]) * B + r[3 * j + 2]
                kj2 = r[2 * j] * B + r[2 * j + 1]
                keys.append(jnp.where(p3, kj3, jnp.where(p2, kj2, r[j])))
            rank, done = trerank(keys)
            mult = jnp.where(p3, 3 * nkeys,
                             jnp.where(p2, 2 * nkeys,
                                       nkeys)).astype(jnp.int32)
            mult = jnp.where(k > ((1 << 31) - 1) // (3 * nkeys), 2, mult)
            return rank, k * mult, done

        def body(state):
            rank, k, _ = state
            return packed_round(rank, k)

        def cond(state):
            _, k, done = state
            return jnp.logical_and(~done, k < 2 * n)

        rank, k1, done1 = packed_round(tok, jnp.int32(1), nkeys=3)
        rank, _, _ = jax.lax.while_loop(
            cond, body, (rank, k1, done1 | done0))

        # -- rank of the NEXT run's start, broadcast over each run ----------
        nrank = tshift(rank, 1)
        # placement sort: position starts_full[j] receives nrank[j]
        _, placed = sorted_sharded((starts_full, nrank), 1, axis, D)
        val = placed + 1                     # [-1, n) -> [0, n]
        nr = jnp.zeros((L,), jnp.int32)
        for c in range(chunks):
            chunk = (val >> (c * cb)) & ((1 << cb) - 1)
            pk = jnp.where(is_start, (ig << cb) | chunk, -1)
            fill = _global_cummax(pk, axis, D)
            nr = nr | ((fill & ((1 << cb) - 1)) << (c * cb))
        nr = nr - 1

        # -- final order: one sort by (rank0, nr); BWT rides along ----------
        _, _, sa_k, bwt_k = sorted_sharded((rank0, nr, ig, sprev), 3,
                                           axis, D)
        return sa_k, bwt_k.astype(jnp.uint8)

    fn = shard_map(kernel, mesh=mesh,
                   in_specs=(P(axis), P(None)),
                   out_specs=(P(axis), P(axis)))
    return fn(s, n_real)


def suffix_array_sharded(s, mesh: Mesh | None = None, axis: str = "seq",
                         symbols: tuple[int, ...] | None = None,
                         impl: str = "auto"):
    """Host entry: suffix array + BWT of `s` over a device mesh.

    Returns (sa, bwt) as device arrays of length len(s), block-sharded
    along `axis` (suffix-rank order).  Use for blocks whose 10-20x int32
    working set exceeds one device; smaller blocks are faster on the
    single-chip kernel.

    impl: 'kmer' (dense-packed prefix doubling), 'runs' (run-key seeding +
    token doubling, immune to long equal-symbol runs), or 'auto' (pick by
    the longest run, like the single-chip dispatcher).

    Size ceiling matches the reference's int32-SA contract (SAIS.java:103,
    2^31 bytes).  The 'runs' variant packs (position, side) into int31 so
    it caps at 1 GiB; blocks in [2^30, 2^31) dispatch to 'kmer', which is
    int32-safe all the way (at the cost of ~log2(longest run) extra
    doubling rounds on run-heavy text).
    """
    from gecoz_tpu.ops.sa_device import RUN_THRESHOLD, max_run_length

    if len(s) >= 1 << 31:
        raise ValueError("blocks are capped at 2^31 bytes by the int32-SA "
                         "contract (SAIS.java:103)")
    s = np.asarray(s, dtype=np.uint8)
    n = len(s)
    if mesh is None:
        devs = np.array(jax.devices())
        mesh = Mesh(devs, (axis,))
    D = mesh.shape[axis]
    if symbols is None:
        symbols = tuple(int(x) for x in np.unique(s))
    if impl == "auto":
        impl = ("runs" if n and n < (1 << 30)
                and max_run_length(s) > RUN_THRESHOLD else "kmer")
    if impl == "runs" and n >= 1 << 30:
        impl = "kmer"                       # runs packs int31 positions
    pad = (-n) % D
    padded = np.concatenate([s, np.zeros(pad, np.uint8)])
    sh = NamedSharding(mesh, P(axis))
    s_d = jax.device_put(jnp.asarray(padded), sh)
    n_real = jnp.asarray([n], dtype=jnp.int32)
    fn = (_suffix_array_sharded_runs_jit if impl == "runs"
          else _suffix_array_sharded_jit)
    sa, bwt = fn(s_d, n_real, mesh=mesh, axis=axis, symbols=symbols)
    if pad:
        sa, bwt = sa[pad:], bwt[pad:]       # strip the padding rank slots
    return sa, bwt
