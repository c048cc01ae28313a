"""Suffix-array construction on device (JAX, jittable, mesh-shardable).

Prefix doubling: O(log n) rounds of a two-key int32 sort, a data-parallel
primitive on every XLA backend, unlike the reference's induced-sort
pointer chasing (SAIS.java), which is irreducibly serial and
gather-bound.

Round-count optimization: initial ranks come from *dense-packed k-mers* —
symbols are mapped to a dense alphabet (0 reserved for past-the-end, which
is exactly the virtual-end comparison semantics) and ``chars_per`` symbols
are packed into one int31 word, so the first sort already orders by
``chars_per`` characters and doubling starts at k = chars_per.  For DNA
(4-bit dense codes, 7 chars/word) random genomic text finishes in 2-3
sorts instead of ~log2(n).

Long-run pathology: prefix doubling needs ~log2(longest equal-symbol run)
extra rounds, and real genomes carry megabase ``N`` runs.
`_suffix_array_runs_jit` removes that: seed ranks come from exact *run
keys* and refinement jumps run-by-run (see its docstring), so a run of any
length is fully ordered by the seed sort.

`lax.while_loop` gives the data-dependent early exit while keeping all
shapes static for XLA.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _scatter_is_cheap(nvals: int = 1) -> bool:
    """Pick the permutation-write strategy per backend (trace time) for a
    write carrying `nvals` value arrays.

    CPU: a scatter is one linear pass, so always scatter.  GPU: a 1-key
    sort with ONE value operand takes XLA's radix-sort path and beats a
    random scatter, but a sort with more operands falls back to a
    comparison sort that is far slower.  Measured by chip_smoke.py on an
    H100 80GB HBM3 (400 W power limit), 2^28 int32: one value, sort
    9.5 ms vs scatter 21.7 ms; three values, sort 460 ms vs scatter
    64 ms.  So the GPU sorts single-value writes and scatters the rest.
    """
    backend = jax.default_backend()
    if backend == "gpu":
        return nvals > 1
    return backend == "cpu"


def apply_perm(dest, *vals):
    """out[dest[j]] = vals[j] for each value array; `dest` a permutation.

    One 1-key sort carrying the values, or plain scatters, as
    `_scatter_is_cheap` picks.  `dest` is distinct by contract, so the
    sort need not be stable (a stable XLA sort carries an implicit index
    tiebreaker operand).
    """
    if _scatter_is_cheap(len(vals)):
        outs = tuple(jnp.zeros_like(v).at[dest].set(v) for v in vals)
    else:
        outs = jax.lax.sort((dest,) + vals, num_keys=1,
                            is_stable=False)[1:]
    return outs if len(outs) > 1 else outs[0]


def _sort_rerank_n(keys: tuple, iota):
    """Sort positions by the key tuple; return (new dense ranks in
    position order, sort order, all-distinct flag).

    Callers inside the doubling loop stay at 2 keys; only the round that
    runs outside the loop goes wider (see `packed_round`'s nkeys).
    """
    n = iota.shape[0]
    # unstable: ties collapse to one rank whatever their order, and every
    # consumer of `order` pairs it with values that are equal across the
    # tie (see call sites) — while a stable XLA sort pays for an implicit
    # index tiebreaker operand
    out = jax.lax.sort(tuple(keys) + (iota,), num_keys=len(keys),
                       is_stable=False)
    ks, order = out[:-1], out[-1]
    diff = jnp.zeros((n - 1,), jnp.bool_)
    for k in ks:
        diff = diff | (k[1:] != k[:-1])
    new_group = jnp.concatenate([
        jnp.ones((1,), jnp.int32), diff.astype(jnp.int32)])
    ranks_in_order = jnp.cumsum(new_group, dtype=jnp.int32) - 1
    rank = apply_perm(order, ranks_in_order)
    done = ranks_in_order[n - 1] == n - 1
    return rank, order, done


def _sort_rerank(key1, key2, iota):
    """2-key variant (the only width safe inside while_loop — see
    _sort_rerank_n)."""
    return _sort_rerank_n((key1, key2), iota)


def _sort_rerank1(key, iota):
    """1-key variant of _sort_rerank (sorts 2 operands, not 3): for callers
    whose composite key fits one int31 word (one fewer sort operand)."""
    n = iota.shape[0]
    ks, order = jax.lax.sort((key, iota), num_keys=1, is_stable=False)
    new_group = jnp.concatenate([
        jnp.ones((1,), jnp.int32),
        (ks[1:] != ks[:-1]).astype(jnp.int32)])
    ranks_in_order = jnp.cumsum(new_group, dtype=jnp.int32) - 1
    rank = apply_perm(order, ranks_in_order)
    done = ranks_in_order[n - 1] == n - 1
    return rank, order, done


@functools.partial(jax.jit, static_argnames=("bits",))
def _suffix_array_jit(s: jax.Array, dense: jax.Array | None = None,
                      bits: int = 9):
    """Suffix array of `s` (uint8 [n]).

    `dense` maps byte -> dense code in [1, 2^bits); identity+1 when None.
    """
    n = s.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)

    if dense is None:
        codes = s.astype(jnp.int32) + 1
    else:
        codes = dense[s.astype(jnp.int32)]

    # pack chars_per dense codes into one int31 word (big-endian in the
    # word so integer order == lexicographic order)
    chars_per = max(1, 31 // bits)
    rank = jnp.zeros(n, dtype=jnp.int32)
    for t in range(chars_per):
        # static shift: slice + zero pad (past-the-end reads as 0 = minimal)
        tt = min(t, n)
        ch = jnp.concatenate([codes[tt:], jnp.zeros((tt,), jnp.int32)]) \
            if tt else codes
        rank = (rank << bits) | ch

    def shifted(r, k):
        # r[i+k] with -1 past the end: a dynamic slice of a padded buffer,
        # not a gather
        padded = jnp.concatenate([r, jnp.full((n,), -1, jnp.int32)])
        return jax.lax.dynamic_slice(padded, (k,), (n,))

    # the packed k-mer word is order-isomorphic and equal exactly for
    # equal chars_per-prefixes — it IS a valid (non-dense) rank, so the
    # seed densification sort is skipped; the first doubling round (run
    # unconditionally, so `order` is always a real sort order) starts
    # directly from the packed words
    def body(state):
        rank, order, k, _ = state
        rank, order, done = _sort_rerank(rank, shifted(rank, k), iota)
        return rank, order, k * 2, done

    def cond(state):
        _, _, k, done = state
        return jnp.logical_and(~done, k < 2 * n)

    rank, order, done1 = _sort_rerank(
        rank, shifted(rank, jnp.int32(min(chars_per, n))), iota)
    # once ranks are all distinct, the last round's sort order IS the
    # suffix array — no final argsort needed
    _, order, _, _ = jax.lax.while_loop(
        cond, body, (rank, order, jnp.int32(chars_per * 2), done1))

    return order.astype(jnp.int32)


TOK_TABLE_SIZE = 128    # fixed table shape: one program for all tables


@functools.partial(jax.jit, static_argnames=("nr_mode", "syms", "r1_keys",
                                             "m_pad", "ell_bits"))
def _suffix_array_runs_jit(s: jax.Array, nr_mode: str = "auto",
                           syms: tuple[int, ...] | None = None,
                           r1_keys: int | None = None,
                           m_pad: int | None = None,
                           tok_table: jax.Array | None = None,
                           ell_bits: int | None = None):
    # `syms`: static alphabet covering EVERY byte of `s` (bytes outside it
    # would alias a neighbor's dense code).  When given and small enough,
    # the whole run key packs into one int31 word -> 1-key seed sort.
    """Run-aware suffix array + BWT: run-token reduction + doubling.

    Equal-symbol runs are the prefix-doubling pathology (a run of length R
    ties for ~log2 R rounds).  This variant pays ~log2(#runs in the
    longest repeated prefix) sorts instead, independent of run lengths:

    * Every position gets an exact *run key* ``(c, side, ±l)``: first
      symbol ``c``, remaining run length ``l``, and ``side`` = whether the
      symbol after the run is smaller ("below", incl. end-of-text) or
      larger than ``c``.  For suffixes c^a·X vs c^b·Y (X, Y starting with
      a non-c symbol or empty): below sorts before above; within below the
      shorter run wins; within above the longer run wins — regardless of
      the tails.  So the seed sort totally orders suffixes except exact
      (c, side, l) ties, which share an identical first run and reduce to
      comparing the suffixes at their run ends.
    * The text is then compacted to its *run-token string* (one token per
      run; token order = seed-rank at the run start) and a standard
      prefix-doubling pass computes the token-string suffix array — all
      shifts are +k slices on the compacted arrays, so no jump-pointer
      gathers.  Lexicographic token comparison equals original suffix
      comparison at run starts (the run-key order is prefix-independent,
      per the case analysis above).
    * Final order = one sort by (seed rank, rank of the suffix at the next
      run start), the latter broadcast run-wide by one monotone gather.
      The BWT rides along as a value operand of that sort, saving the
      usual s[sa-1] gather.

    Returns (sa, bwt).  No dense packing table needed — run keys already
    compress better than k-mers wherever runs exist.

    ``m_pad``: static upper bound on the RUN COUNT of `s` (caller contract
    — one cheap host pass, see `runs_m_pad`).  The token-string doubling
    then runs on arrays of that length instead of n (~0.75n for DNA), so
    every doubling-phase sort sheds ~25% of its elements.  None keeps the
    n-sized behavior (required when `s` is a tracer the host never saw).

    ``tok_table``: int32[TOK_TABLE_SIZE], the sorted distinct run keys
    present at run starts, padded with INT32_MAX (caller contract —
    `runs_token_table`; MUST cover every start or dense token values
    silently collide).  Replaces the two 3-operand compaction sorts with
    TOK_TABLE_SIZE fused compares + one 2-operand sort.  TRACED, not
    static: one compiled program serves every block's table.

    ``ell_bits``: static bound with 2^ell_bits > the longest equal-symbol
    run (caller contract — `runs_ell_bits`); shrinks the run-length field
    of the packed seed key so pack_seed (and with it tok_table) engages
    on blocks past 2^27 bytes.  The helper and this kernel must agree on
    the value or the key formulas diverge.
    """
    n = s.shape[0]
    if n >= 1 << 30:
        raise ValueError("run-aware device SA packs (position, side) into "
                         "int31; split blocks above 1 GiB")
    M = n if m_pad is None else max(1, min(int(m_pad), n))
    iota = jnp.arange(n, dtype=jnp.int32)
    iota_m = iota if M == n else jnp.arange(M, dtype=jnp.int32)
    # eb: bits reserved for the run length in the packed seed key.  The
    # default bit_length(n) always fits but costs pack_seed above 2^27
    # (sym_bits + 1 + eb > 31); a host-measured static bound
    # (`ell_bits` >= bit_length(max run), see `runs_ell_bits`) keeps the
    # 1-key packed seed + tok_table compaction alive at chr1 scale.
    eb = int(n).bit_length() if ell_bits is None \
        else min(int(ell_bits), int(n).bit_length())
    sym_bits = max(len(syms), 1).bit_length() if syms else 0
    pack_seed = bool(syms) and sym_bits + 1 + eb <= 31
    if pack_seed:
        # dense codes via compare-sum against the static alphabet (sigma
        # fused elementwise passes instead of a 256-entry table gather)
        codes = jnp.zeros((n,), jnp.int32)
        for sym in syms:
            codes = codes + (s >= jnp.uint8(sym)).astype(jnp.int32)
        # order-isomorphic to raw bytes: run/below semantics unchanged
    else:
        codes = s.astype(jnp.int32) + 1
    nxt = jnp.concatenate([codes[1:], jnp.full((1,), -1, jnp.int32)])
    from gecoz_tpu.ops.scan import fill_fwd_i32, fill_rev_i32
    is_end = codes != nxt                      # last position of each run
    is_start = jnp.concatenate([jnp.ones((1,), jnp.bool_), is_end[:-1]])
    run_id = jnp.cumsum(is_start, dtype=jnp.int32) - 1
    m = run_id[n - 1] + 1                      # number of runs (traced)
    # one backward segmented fill carries (run end position << 1 |
    # below-side bit) to every member: `below` = symbol after the run <
    # run symbol (end-of-text counts below), constant per run.  The last
    # position is always an end, so the fill never returns -1.
    below_end = nxt < codes
    v = fill_rev_i32(jnp.where(
        is_end, (iota << 1) | below_end.astype(jnp.int32), jnp.int32(-1)))
    nde = v >> 1                               # inclusive next run end
    below = (v & 1).astype(jnp.bool_)
    ell = nde - iota + 1                       # remaining run length >= 1
    if pack_seed:
        # the whole run key (c, side, +/-ell) packs into one int31 word —
        # and an order-isomorphic key IS a rank: nothing downstream needs
        # density (the compaction re-densifies over start values, the
        # final sort only compares), so the seed sort + its rerank sort
        # are skipped entirely.  rank0 := the packed key itself.
        above = (~below).astype(jnp.int32)
        rank0 = ((codes << (1 + eb)) | (above << eb)
                 | jnp.where(below, ell, (1 << eb) - ell))
        done0 = jnp.asarray(False)       # loop exit rides round 1's done
    else:
        key1 = (codes << 1) | (~below).astype(jnp.int32)
        key2 = jnp.where(below, ell, -ell)
        rank0, _, done0 = _sort_rerank(key1, key2, iota)

    # Compact to the token string: slot j = seed rank at run j's start,
    # RE-DENSIFIED over token values.  Seed ranks are dense over all n
    # *positions*, but a megabase run contributes one distinct
    # (c, side, ell) key per member position and only ONE token — so token
    # values are sparse (measured: 335,616 position-ranks vs 73
    # start-ranks on the 64 MiB bench block).  The adaptive packing below
    # keys off the max rank; without re-densifying, any long run pushes
    # the first round past every packing threshold.  Padding slots
    # m..n-1 get large distinct keys so they sort last and stay inert.
    starts_full = None
    if _scatter_is_cheap():
        drop = jnp.where(is_start, run_id, n)
        tok = (n + iota).at[drop].set(rank0, mode="drop")
        # densify with the pad flag as the leading key: rank0 may be the
        # raw (non-dense) packed seed key, which can collide with the
        # n+iota pad values — the flag keeps pads behind every real token
        pad = (iota >= m).astype(jnp.int32)
        tok, _, _ = _sort_rerank(pad, tok, iota)
        tok = tok[:M]
    elif pack_seed and tok_table is not None:
        # HOST-TABLED densify + one-sort compaction.  The distinct run
        # keys present at run starts number only a few dozen on genomic
        # text (73 on the 64 MiB bench block), and the caller measured
        # them (runs_token_table): dense token values come from a
        # compare-sum against the sorted table (TOK_TABLE_SIZE compares,
        # fused by XLA into ONE elementwise pass — INT32_MAX padding
        # contributes 0 since rank0 < INT32_MAX), and the compaction
        # collapses to a single 2-operand 1-key sort — replacing the
        # value sort + rerank scan + position sort below (two n-wide
        # 3-operand sorts).  The sorted keys are the positions
        # themselves, so the sort's key output doubles as `starts_full`
        # (starts ascending, then non-starts ascending — a full position
        # permutation for the placed sort below).
        dense0 = jnp.zeros((n,), jnp.int32)
        for i in range(TOK_TABLE_SIZE):
            dense0 = dense0 + (rank0 >= tok_table[i]).astype(jnp.int32)
        ckey = jnp.where(is_start, iota, (1 << 30) + iota)
        skeys, tok_n = jax.lax.sort((ckey, dense0), num_keys=1,
                                     is_stable=False)
        starts_full = skeys & ((1 << 30) - 1)
        tok = tok_n[:M]            # pad slots carry junk; masked by m
    else:
        # Fused compaction + densify in two sorts (vs one compaction sort
        # + a separate two-sort rerank):
        #  1. value sort: starts first, ordered by seed rank (stable by
        #     position) — group boundaries give dense ranks over start
        #     VALUES via one cumsum;
        #  2. position sort of the first m slots — lands dense ranks in
        #     token-slot order; the carried position doubles as
        #     starts_full[j] = position of the j-th run start (consumed
        #     by the nr fill below).  Partition keys pack above the
        #     position (n < 2^30 per the guard).
        # leading not-a-start key instead of a sentinel band: rank0 may be
        # the raw packed seed key (order-isomorphic, non-dense), whose
        # range collides with any in-band sentinel
        nst = (~is_start).astype(jnp.int32)
        nsts, vks, order1 = jax.lax.sort((nst, rank0, iota), num_keys=2,
                                         is_stable=False)
        new_group = jnp.concatenate([
            jnp.ones((1,), jnp.int32),
            ((vks[1:] != vks[:-1])
             | (nsts[1:] != nsts[:-1])).astype(jnp.int32)])
        dvr = jnp.cumsum(new_group, dtype=jnp.int32) - 1
        pkey = jnp.where(iota < m, order1, (1 << 30) + iota)
        _, dense_rank, starts_full = jax.lax.sort(
            (pkey, dvr, order1), num_keys=1)
        # token-slot arrays shrink to M (slots >= m are inert pads either
        # way; sort2 itself stays n-wide — `starts_full` must remain a
        # full position permutation for the placed sort below)
        tok = jnp.where(iota < m, dense_rank, n + iota)[:M]

    def shifted(r, k):
        padded = jnp.concatenate([r, jnp.full((M,), -1, jnp.int32)])
        out = jax.lax.dynamic_slice(padded, (k,), (M,))
        # the token string ends at slot m, not M: past-the-end reads -1
        return jnp.where(iota_m + k >= m, -1, out)

    # Adaptive rank packing: while the group count G is small, p in 2..5
    # ranks fit one UNSIGNED 32-bit key ((G+1)^p below the pad-key band),
    # so each 2-key sort round covers 2p*k tokens instead of 2k — the
    # early rounds multiply the depth at identical sort cost, with the p
    # selected at runtime via `where` (shapes and the loop body stay
    # static; the loop body keeps 2-key sorts).  uint32 keys (sorted
    # unsigned) double the packable range over int31: p=5 engages up to
    # B = 83 groups instead of 72 — DNA run-token alphabets measure ~74
    # (64 MiB census), exactly the band this unlocks, so round one
    # reaches 25-token depth with 5 keys instead of 24 with 6 (one fewer
    # n-wide sort operand).  Padding slots get keys in the reserved top
    # band (UINT32_MAX - n, UINT32_MAX] so they always sort last
    # whatever the packing.
    lim = (1 << 32) - M - 2
    tp = {}
    for p in (2, 3, 4, 5):
        t = 1
        while (t + 1) ** p <= lim:
            t += 1
        tp[p] = t
    pad_key1 = (jnp.uint32((1 << 32) - 1)
                - (M - 1 - iota_m).astype(jnp.uint32))

    def packed_round(rank, k, nkeys: int = 2, carry=None):
        """One doubling round covering nkeys*p tokens per sort.

        nkeys > 2 widens the lax.sort to nkeys+1 operands — used only by
        the round that runs OUTSIDE the while_loop; the first round's deeper
        coverage (e.g. 25 tokens at nkeys=5, p=5) finishes random text in
        one round where two were needed.

        With `carry`, one extra value operand rides the sort and the
        SORT-ORDER results come back instead of position-order ranks:
        ((ranks_in_order, order, carry_sorted), k', done) — the
        fast-delivery round one (see below) consumes these directly and
        skips the rerank sort entirely when `done`.
        """
        B = jnp.max(jnp.where(iota_m < m, rank, -1)) + 2  # bound + 1 offset
        Bu = B.astype(jnp.uint32)

        def sh(t):
            # shift by t*k, saturating at n (depth past the end reads all
            # -1 anyway); the where discards the wrapped product safely
            off = jnp.where(k > n // t, jnp.int32(n), t * k)
            return shifted(rank, off) + 1
        r = [rank.astype(jnp.uint32)] \
            + [sh(t).astype(jnp.uint32) for t in range(1, 5 * nkeys)]

        def pack(vals):
            acc = vals[0]
            for v in vals[1:]:
                acc = acc * Bu + v       # wraps harmlessly when unselected
            return acc
        # deepest packing whose worst-case key stays below the pad band
        keys = [r[j] for j in range(nkeys)]
        mult = jnp.int32(nkeys)
        for p in (2, 3, 4, 5):
            ok = B <= tp[p]
            keys = [jnp.where(ok, pack(r[j * p:(j + 1) * p]), keys[j])
                    for j in range(nkeys)]
            mult = jnp.where(ok, jnp.int32(nkeys * p), mult)
        keys[0] = jnp.where(iota_m < m, keys[0], pad_key1)
        keys[1:] = [jnp.where(iota_m < m, kk, jnp.uint32(0))
                    for kk in keys[1:]]
        # k invariant: rank entering a round always orders by < n tokens
        # (depth >= n makes all ranks distinct, so done exits first); cap
        # the multiplier where k*mult could wrap int32 (k*2 never can)
        mult = jnp.where(k > ((1 << 31) - 1) // (5 * nkeys), 2, mult)
        if carry is None:
            rank, _, done = _sort_rerank_n(tuple(keys), iota_m)
            return rank, k * mult, done
        out = jax.lax.sort(tuple(keys) + (iota_m, carry),
                           num_keys=nkeys, is_stable=False)
        ks, order, cs = out[:nkeys], out[nkeys], out[nkeys + 1]
        diff = jnp.zeros((M - 1,), jnp.bool_)
        for kk in ks:
            diff = diff | (kk[1:] != kk[:-1])
        new_group = jnp.concatenate([
            jnp.ones((1,), jnp.int32), diff.astype(jnp.int32)])
        rio = jnp.cumsum(new_group, dtype=jnp.int32) - 1
        done = rio[M - 1] == M - 1
        return (rio, order, cs), k * mult, done

    def body(state):
        rank, k, _ = state
        return packed_round(rank, k)

    def cond(state):
        _, k, done = state
        return jnp.logical_and(~done, k < 2 * n)

    if r1_keys is None:
        # default 6: with p=4 packing (DNA-run token alphabets stay under
        # ~215 groups) round 1 orders 24 tokens deep — past the ~21-token
        # distinctness depth of 64 Mi genomic text, so the while_loop
        # usually exits without running a second (3-op sort + rerank)
        # round.  Round 1 runs OUTSIDE the while_loop (see packed_round).
        r1_keys = 6
    fast_ok = (starts_full is not None and nr_mode != "gather"
               and not _scatter_is_cheap())
    if fast_ok:
        # FAST-PATH DELIVERY (round-5): round one carries the delivery
        # key sfm1[j] = starts_full[j-1] as a value operand, so when its
        # ranks come out all-distinct (the common case — 25-token depth
        # vs the ~21-token distinctness depth of 64 Mi genomic text) the
        # next-run rank reaches its run-start position with ONE n-wide
        # 2-operand sort: sort-output r carries (K = starts_full[
        # order[r]-1], rank-of-token-order[r]) — exactly "deliver
        # rank[j+1] to position starts_full[j]".  That replaces the
        # rerank sort (0.8 units) + the n-wide placed sort (1.0) of the
        # old chain.  The slow branch (ties survive round one) runs the
        # classic rerank + while_loop + placed chain inside lax.cond.
        sfm1 = jnp.roll(starts_full[:M], 1)
        (rio, order1, K), k1, done1 = packed_round(
            tok, jnp.int32(1), nkeys=r1_keys, carry=sfm1)
        # when done0 (seed ranks already distinct) nr is never consulted
        # by the final sort, so the fast branch's output is acceptable
        pred = jnp.logical_or(done1, done0)

        def fast(_):
            # order1 == 0 wraps to starts_full[M-1]: when m == M that IS
            # the last run's start, whose next-run rank must be -1 (end
            # of text sorts first); pad tokens (order1 >= m) deliver -1
            # to masked slots anyway
            vals = jnp.where((order1 >= m) | (order1 == 0),
                             jnp.int32(-1), rio)
            K_full = jnp.concatenate([K, starts_full[M:]])
            vals_full = jnp.concatenate(
                [vals, jnp.full((n - M,), -1, jnp.int32)])
            return jax.lax.sort((K_full, vals_full), num_keys=1,
                                is_stable=False)[1]

        def slow(_):
            rank = apply_perm(order1, rio)
            rank, _, _ = jax.lax.while_loop(
                cond, body, (rank, k1, jnp.asarray(False)))
            nrank = shifted(rank, 1)
            nrank_n = (jnp.concatenate(
                [nrank, jnp.full((n - M,), -1, jnp.int32)])
                if M < n else nrank)
            return jax.lax.sort((starts_full, nrank_n), num_keys=1,
                                is_stable=False)[1]

        placed = jax.lax.cond(pred, fast, slow, None)
        nr = fill_fwd_i32(jnp.where(is_start, placed + 1,
                                    jnp.int32(-1))) - 1
    else:
        rank, k1, done1 = packed_round(tok, jnp.int32(1), nkeys=r1_keys)
        rank, _, _ = jax.lax.while_loop(
            cond, body, (rank, k1, done1 | done0))

        # rank of the *next* run's start suffix, broadcast over each run
        nrank = shifted(rank, 1)
        if M < n:
            # back to n-length for the position-space placed sort/gather
            # (slots >= m are garbage either way; masked by is_start)
            nrank = jnp.concatenate(
                [nrank, jnp.full((n - M,), -1, jnp.int32)])
        use_fill = (starts_full is not None and nr_mode != "gather") \
            or nr_mode == "fill"
        if use_fill:
            # Placement sort lands nrank[j] at the j-th run start; the
            # run-wide broadcast is ONE segmented forward fill (scan op
            # "last": nearest marked value at or before each position
            # wins).
            if starts_full is None:          # nr_mode == "fill" on CPU
                _, _, starts_full = jax.lax.sort(
                    ((~is_start).astype(jnp.int32), iota, iota),
                    num_keys=2)
            placed = jax.lax.sort((starts_full, nrank), num_keys=1,
                                  is_stable=False)[1]
            # placed in [-1, n); +1 keeps marked slots non-negative for
            # the fill, -1 marks non-start slots as transparent
            nr = fill_fwd_i32(jnp.where(is_start, placed + 1,
                                        jnp.int32(-1))) - 1
        else:
            # one monotone gather by run id (the only gather here)
            nr = nrank[run_id]

    s_prev = jnp.concatenate([s[n - 1:], s[:n - 1]])
    if pack_seed and n < (1 << 27):
        # fold (position, BWT as a 4-bit dense code) into one value
        # operand — one fewer n-wide operand in the final sort up to
        # 128 Mi; the static alphabet turns codes back into bytes with a
        # sigma-way select (no gather)
        cp = jnp.zeros((n,), jnp.int32)
        for sym in syms:
            cp = cp + (s_prev >= jnp.uint8(sym)).astype(jnp.int32)
        packed_ib = (iota << 4) | cp
        _, _, ob = jax.lax.sort((rank0, nr, packed_ib), num_keys=2,
                                is_stable=False)
        order = ob >> 4
        code = ob & 15
        bwt = jnp.zeros((n,), jnp.uint8)
        for i, sym in enumerate(sorted(syms)):
            bwt = jnp.where(code == i + 1, jnp.uint8(sym), bwt)
    elif n < (1 << 23):
        # fold (position, BWT byte) into one value operand — one fewer
        # n-wide operand in the final sort (fits int31 below 8 Mi)
        packed_ib = (iota << 8) | s_prev.astype(jnp.int32)
        _, _, ob = jax.lax.sort((rank0, nr, packed_ib), num_keys=2,
                                is_stable=False)
        order, bwt = ob >> 8, (ob & 255).astype(jnp.uint8)
    else:
        _, _, order, bwt = jax.lax.sort(
            (rank0, nr, iota, s_prev), num_keys=2)
    return order.astype(jnp.int32), bwt


def dense_table(symbols) -> tuple[np.ndarray, int]:
    """(byte -> dense code) table + static bits for a symbol set."""
    symbols = sorted(int(x) for x in symbols)
    table = np.zeros(256, dtype=np.int32)
    for i, sym in enumerate(symbols):
        table[sym] = i + 1
    bits = max(1, (len(symbols) + 1 - 1).bit_length())
    return table, bits


# ell_bits quantization ladder: few program variants, covers everything
# from clean reads (<=4 Ki runs) to chr1 centromere gaps (~2^25)
ELL_BITS_LADDER = (12, 16, 20, 25, 27)


def runs_ell_bits(s: np.ndarray, mx: int | None = None) -> int | None:
    """Static run-length bit bound for `_suffix_array_runs_jit`
    (host side): the smallest ladder rung covering the longest run, or
    None when no rung does (then the kernel's bit_length(n) default —
    and its pack_seed gate — apply unchanged).  Callers that already
    measured `max_run_length` pass it as `mx` to skip the host pass."""
    if mx is None:
        mx = max_run_length(s)
    bits = max(1, int(mx).bit_length())
    for rung in ELL_BITS_LADDER:
        if bits <= rung:
            return rung
    return None


def runs_token_table(s: np.ndarray, syms: tuple[int, ...] | None,
                     max_entries: int | None = None,
                     ell_bits: int | None = None,
                     _chunk: int = 4 << 20) -> np.ndarray | None:
    """int32[TOK_TABLE_SIZE] of sorted distinct run keys at run starts,
    INT32_MAX-padded (host side), or None.

    Replicates the device's packed seed-key formula exactly
    (`_suffix_array_runs_jit` pack_seed branch): codes are the
    compare-sum dense alphabet, eb = bit_length(n), key =
    (c << (1+eb)) | (above << eb) | (below ? ell : 2^eb - ell).
    Returns None when the packed seed won't engage (alphabet too wide)
    or the table would exceed TOK_TABLE_SIZE (genomic text measures a
    few dozen; pathological inputs fall back to the sort compaction).

    Works in bounded chunks so the fresh-page footprint stays small on
    cold-allocator hosts; runs crossing chunk borders are merged.
    """
    if max_entries is None:
        max_entries = TOK_TABLE_SIZE
    s = np.asarray(s, dtype=np.uint8)
    n = int(s.shape[0])
    if n == 0 or not syms:
        return None
    sym_bits = max(len(syms), 1).bit_length()
    eb = int(n).bit_length() if ell_bits is None \
        else min(int(ell_bits), int(n).bit_length())
    if sym_bits + 1 + eb > 31:
        return None                    # pack_seed can't trigger
    keys: set[int] = set()
    chunk = _chunk
    carry_c = carry_len = None         # open run at the chunk border
    pos = 0
    while pos < n:
        part = s[pos:pos + chunk]
        codes = np.zeros(part.shape[0], np.int64)
        for sym in syms:
            codes += part >= np.uint8(sym)
        bounds = np.flatnonzero(codes[1:] != codes[:-1])
        starts = np.concatenate([[0], bounds + 1])
        ends = np.concatenate([bounds, [part.shape[0] - 1]])
        c = codes[starts]
        ell = (ends - starts + 1).astype(np.int64)
        if carry_c is not None:
            if c[0] == carry_c:
                ell[0] += carry_len
            else:
                # carried run closed at the border: next symbol is c[0]
                below = c[0] < carry_c
                keys.add(int((carry_c << (1 + eb))
                             | ((not below) << eb)
                             | (carry_len if below
                                else (1 << eb) - carry_len)))
        # last run stays open (its 'below' side needs the next chunk)
        carry_c, carry_len = int(c[-1]), int(ell[-1])
        if c.shape[0] > 1:
            nxtc = c[1:]
            cc, ll = c[:-1], ell[:-1]
            below = nxtc < cc
            k = ((cc << (1 + eb)) | ((~below).astype(np.int64) << eb)
                 | np.where(below, ll, (1 << eb) - ll))
            keys.update(int(x) for x in np.unique(k))
            if len(keys) > max_entries:
                return None
        pos += chunk
    # final open run: end-of-text counts as below
    keys.add(int((carry_c << (1 + eb)) | carry_len))
    if len(keys) > max_entries:
        return None
    out = np.full(TOK_TABLE_SIZE, (1 << 31) - 1, np.int32)
    out[:len(keys)] = sorted(keys)
    return out


# m_pad quantization ladder (fractions of n, /16): few program variants
# per block length, and prewarm can guess the DNA-typical rungs (3/4 and
# 13/16 — random/genomic DNA has ~0.74-0.76 runs per byte)
M_PAD_LADDER = (8, 10, 12, 13, 14, 16)


def m_pad_bucket(m: int, n: int) -> int:
    """Round a run count UP to the quantization ladder (static m_pad)."""
    for num in M_PAD_LADDER:
        cand = (num * n) // 16
        if m <= cand:
            return cand
    return n


def runs_m_pad(s: np.ndarray) -> int:
    """Static token-array size for `_suffix_array_runs_jit` (host side).

    One vectorized pass counts the runs of `s`, then rounds UP the
    quantization ladder so only a handful of program variants exist per
    block length (DNA lands on the 3/4 or 13/16 rung).
    """
    s = np.asarray(s)
    n = int(s.shape[0])
    if n == 0:
        return 0
    m = int(np.count_nonzero(s[1:] != s[:-1])) + 1
    return m_pad_bucket(m, n)


def max_run_length(s: np.ndarray, _chunk: int = 4 << 20) -> int:
    """Longest equal-symbol run (host, vectorized).

    Chunked: the obvious one-shot flatnonzero allocates ~8 bytes/run
    (1.5 GB for a chr1 block) — catastrophic on fresh-page-fault-bound
    hosts; bounded chunks keep the working set at a few dozen MB and
    recycle it."""
    s = np.asarray(s)
    n = int(s.shape[0])
    if n == 0:
        return 0
    best = 0
    carry = 0                      # open run length ending at chunk edge
    prev = -1                      # its symbol (-1 = none)
    for pos in range(0, n, _chunk):
        part = s[pos:pos + _chunk]
        m = part.shape[0]
        diff = np.flatnonzero(part[1:] != part[:-1])
        starts = np.concatenate([[0], diff + 1])
        ends = np.concatenate([diff, [m - 1]])
        lens = ends - starts + 1
        if int(part[0]) == prev:
            lens[0] += carry
        else:
            best = max(best, carry)
        if lens.shape[0] > 1:
            best = max(best, int(lens[:-1].max()))
        carry = int(lens[-1])
        prev = int(part[-1])
    return max(best, carry)


def runs_r1_keys(tab: np.ndarray | None) -> int | None:
    """Round-one sort width for `_suffix_array_runs_jit` (host side).

    With uint32 rank packing, the p=5 rung engages while the token
    alphabet stays below ~82 groups — then 5 keys already order 25
    tokens deep (past the measured ~21-token distinctness depth of
    64 MiB genomic text), so the sixth key is a wasted n-wide sort
    operand.  Wider alphabets keep 6 keys (6x4 = 24 deep via p=4).
    None (unknown table) -> kernel default."""
    if tab is None:
        return None
    entries = int(np.count_nonzero(np.asarray(tab) != (1 << 31) - 1))
    return 5 if entries + 2 <= 80 else 6


# k-mer seeding beats run seeding on run-free text (it starts ~7 symbols
# deep); past this run length the extra doubling rounds always lose
RUN_THRESHOLD = 64


def suffix_array_device(s, impl: str = "auto", with_bwt: bool = False,
                        s_dev=None):
    """Suffix array of a uint8 array, computed on the default JAX device.

    impl: 'kmer' (dense-packed prefix doubling), 'runs' (run-key seeding +
    jump doubling), or 'auto' (pick by the longest equal-symbol run).

    with_bwt=True returns (sa, bwt): the runs kernel emits the BWT as a
    free value operand of its final sort, so consumers skip the n-wide
    gather (the kmer variant still derives it with one on-device gather).

    `s_dev` is an optional already-device-resident copy of `s` (e.g. a
    packed upload, utils/xfer.put_packed); the HOST array is still used
    for the cheap bound/table precomputation.
    """
    s = np.asarray(s, dtype=np.uint8)
    if s.shape[0] == 0:
        empty = jnp.zeros((0,), jnp.int32)
        return (empty, jnp.zeros((0,), jnp.uint8)) if with_bwt else empty
    mx = None
    if impl == "auto":
        mx = max_run_length(s)           # measured ONCE; threaded below
        impl = "runs" if mx > RUN_THRESHOLD else "kmer"
    if s_dev is None:
        s_dev = jnp.asarray(s)
    if impl == "runs":
        syms = tuple(int(x) for x in np.unique(s))
        if len(syms) > 7:
            syms = None          # packed seed only pays below 3 sym bits
        ebs = runs_ell_bits(s, mx=mx)
        tab = runs_token_table(s, syms, ell_bits=ebs)
        sa, bwt = _suffix_array_runs_jit(
            s_dev, syms=syms, m_pad=runs_m_pad(s),
            tok_table=None if tab is None else jnp.asarray(tab),
            ell_bits=ebs, r1_keys=runs_r1_keys(tab))
        return (sa, bwt) if with_bwt else sa
    table, bits = dense_table(np.unique(s))
    sa = _suffix_array_jit(s_dev, jnp.asarray(table), bits=bits)
    if with_bwt:
        return sa, bwt_device(s_dev, sa)
    return sa


@jax.jit
def bwt_device(s: jax.Array, sa: jax.Array) -> jax.Array:
    """BWT[i] = s[(sa[i] - 1) mod n] on device."""
    n = s.shape[0]
    idx = jnp.where(sa == 0, n - 1, sa - 1)
    return s[idx]
