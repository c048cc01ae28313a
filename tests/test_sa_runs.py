"""Run-aware device suffix sort vs the oracle (long-run pathology).

The reference's SA-IS (SAIS.java) is run-agnostic; our device prefix
doubling pays ~log2(run length) rounds on equal-symbol runs, which the
run-key variant removes.  Both must compute the identical true suffix
array.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from gecoz_tpu.ops.sa import suffix_array_naive, suffix_array_numpy
from gecoz_tpu.ops.sa_device import (_suffix_array_runs_jit, max_run_length,
                                     suffix_array_device)


def runs_sa(s: np.ndarray) -> np.ndarray:
    sa, bwt = _suffix_array_runs_jit(jnp.asarray(s, jnp.uint8))
    # the fused BWT must match the gather formulation
    from gecoz_tpu.ops.sa import bwt_from_sa
    assert np.array_equal(np.asarray(bwt), bwt_from_sa(s, np.asarray(sa)))
    # both nr-broadcast strategies (GPU: placement sort + segmented cummax
    # fill; CPU default: monotone gather) must agree
    sa_f, bwt_f = _suffix_array_runs_jit(jnp.asarray(s, jnp.uint8),
                                         nr_mode="fill")
    assert np.array_equal(np.asarray(sa_f), np.asarray(sa))
    assert np.array_equal(np.asarray(bwt_f), np.asarray(bwt))
    # the packed 1-key seed (static alphabet) must agree too
    syms = tuple(int(x) for x in np.unique(s))
    if len(syms) <= 7:
        sa_p, bwt_p = _suffix_array_runs_jit(jnp.asarray(s, jnp.uint8),
                                             syms=syms)
        assert np.array_equal(np.asarray(sa_p), np.asarray(sa))
        assert np.array_equal(np.asarray(bwt_p), np.asarray(bwt))
    return np.asarray(sa)


@pytest.mark.parametrize("case", [
    b"banana\0", b"mississippi\0", b"AC\0G\0", b"B\0A\0",
    b"\0\0\0", b"aaaaaaaa\0", b"A", b"ab",
    b"aaaabaaa\0", b"baaaabaaaab\0",
    # run followed by below-tail vs above-tail
    b"NNNNA" b"NNNNT" b"NNNN\0",
    # runs ending at end-of-text (empty tail)
    b"ACGTNNNNNNNN",
    # nested/adjacent runs of different symbols
    b"AAAACCCCGGGGTTTTAAAA\0",
])
def test_runs_fixed_cases(case):
    s = np.frombuffer(case, dtype=np.uint8)
    assert np.array_equal(runs_sa(s), suffix_array_naive(s))


def test_runs_random_small_alphabet(rng):
    for _ in range(15):
        n = int(rng.integers(2, 300))
        s = rng.choice(np.frombuffer(b"AB\0", np.uint8), size=n)
        assert np.array_equal(runs_sa(s), suffix_array_naive(s))


def test_runs_random_with_runs(rng):
    """Texts stitched from random DNA and long runs (the genomic shape)."""
    for trial in range(10):
        parts = []
        for _ in range(int(rng.integers(2, 6))):
            kind = rng.integers(0, 3)
            if kind == 0:
                parts.append(rng.choice(
                    np.frombuffer(b"ACGT", np.uint8),
                    size=int(rng.integers(5, 80))))
            else:
                sym = rng.choice(np.frombuffer(b"ACGTN\0", np.uint8))
                parts.append(np.full(int(rng.integers(20, 200)), sym,
                                     np.uint8))
        parts.append(np.zeros(1, np.uint8))
        s = np.concatenate(parts)
        assert np.array_equal(runs_sa(s), suffix_array_numpy(s)), trial


def test_runs_genomic_block_deep_packing(rng):
    """Bench-shaped block: mostly random DNA + one long N run.

    The long run makes seed ranks dense over positions but sparse over run
    starts; after the token re-densify the packing bound drops to a few
    dozen, so this exercises the deepest (p=5) adaptive-packing branch.
    Bit-exactness against the host oracle is the whole contract.
    """
    n = 1 << 18
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    s[1000:1000 + (1 << 14)] = ord("N")     # 16 Ki N run
    s[n // 2] = 0
    s[n - 1] = 0
    assert np.array_equal(runs_sa(s), suffix_array_numpy(s))


def test_runs_equal_length_runs_different_tails(rng):
    # same (symbol, side, length) run keys, resolved only by tails
    s = np.frombuffer(b"CNNNNAC" b"CNNNNAG" b"CNNNNAA\0", np.uint8)
    assert np.array_equal(runs_sa(s), suffix_array_naive(s))


def test_tpu_sort_paths_on_cpu(rng, monkeypatch):
    """Force the sort strategy (sorts instead of scatters, the GPU's
    branches) on the CPU backend: exercises apply_perm-as-sort, the fused
    compaction+densify two-sort pipeline, and the placement-sort +
    segmented-cummax nr fill — branches plain CPU tests never reach."""
    from gecoz_tpu.ops import sa_device
    monkeypatch.setattr(sa_device, "_scatter_is_cheap",
                        lambda nvals=1: False)
    jax.clear_caches()   # drop traces compiled with the scatter strategy
    try:
        for trial in range(3):
            n = int(rng.integers(200, 2000)) * 2 + 1   # odd, fresh shapes
            s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
            s[50:50 + n // 3] = ord("N")
            s[n - 1] = 0
            syms = tuple(int(x) for x in np.unique(s))
            sa, bwt = sa_device._suffix_array_runs_jit(
                jnp.asarray(s), syms=syms)
            assert np.array_equal(np.asarray(sa), suffix_array_numpy(s))
            from gecoz_tpu.ops.sa import bwt_from_sa
            assert np.array_equal(np.asarray(bwt),
                                  bwt_from_sa(s, np.asarray(sa)))
    finally:
        jax.clear_caches()


def test_m_pad_static_token_bound(rng, monkeypatch):
    """m_pad (static run-count bound) must not change results — on both
    the scatter (CPU) and sort (GPU) compaction strategies, at tight and
    loose bounds, including m_pad == exact run count."""
    from gecoz_tpu.ops import sa_device
    from gecoz_tpu.ops.sa_device import m_pad_bucket, runs_m_pad

    s = np.concatenate([
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=600),
        np.full(400, ord("N"), np.uint8),
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=600),
        np.zeros(1, np.uint8)])
    n = s.shape[0]
    m = int(np.count_nonzero(s[1:] != s[:-1])) + 1
    want = suffix_array_numpy(s)
    syms = tuple(int(x) for x in np.unique(s))
    for force_sorts in (False, True):
        if force_sorts:
            monkeypatch.setattr(sa_device, "_scatter_is_cheap",
                                lambda nvals=1: False)
            jax.clear_caches()
        try:
            for mp in (m, runs_m_pad(s), n - 1, n):
                sa, bwt = sa_device._suffix_array_runs_jit(
                    jnp.asarray(s), syms=syms, m_pad=mp)
                assert np.array_equal(np.asarray(sa), want), \
                    (force_sorts, mp)
                from gecoz_tpu.ops.sa import bwt_from_sa
                assert np.array_equal(np.asarray(bwt), bwt_from_sa(s, want))
        finally:
            if force_sorts:
                jax.clear_caches()
    # bucket helper: ladder rounding, upper clamp
    assert m_pad_bucket(1, 160) == 80
    assert m_pad_bucket(120, 160) == 120        # 3/4 rung
    assert m_pad_bucket(121, 160) == 130        # 13/16 rung
    assert m_pad_bucket(159, 160) == 160
    assert runs_m_pad(np.zeros(0, np.uint8)) == 0


def _naive_start_keys(s, syms):
    """Oracle for runs_token_table: per-start packed run keys, direct."""
    n = s.shape[0]
    eb = int(n).bit_length()
    codes = np.zeros(n, np.int64)
    for sym in syms:
        codes += s >= np.uint8(sym)
    keys = set()
    i = 0
    while i < n:
        j = i
        while j + 1 < n and codes[j + 1] == codes[i]:
            j += 1
        below = (j + 1 >= n) or (codes[j + 1] < codes[i])
        ell = j - i + 1
        keys.add(int((codes[i] << (1 + eb)) | ((not below) << eb)
                     | (ell if below else (1 << eb) - ell)))
        i = j + 1
    return keys


def test_runs_token_table_matches_naive(rng):
    """The chunked host table builder must produce exactly the distinct
    run keys at run starts — including runs crossing chunk borders."""
    from gecoz_tpu.ops.sa_device import TOK_TABLE_SIZE, runs_token_table
    for trial in range(8):
        parts = [rng.choice(np.frombuffer(b"ACGT", np.uint8),
                            size=int(rng.integers(50, 300)))]
        # runs positioned to straddle the tiny chunk size below
        parts.append(np.full(int(rng.integers(100, 400)), ord("N"),
                             np.uint8))
        parts.append(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                size=int(rng.integers(50, 300))))
        parts.append(np.zeros(1, np.uint8))
        s = np.concatenate(parts)
        syms = tuple(int(x) for x in np.unique(s))
        tab = runs_token_table(s, syms, _chunk=64)
        want = _naive_start_keys(s, syms)
        assert tab is not None
        got = {int(v) for v in tab if v != (1 << 31) - 1}
        assert got == want, trial
        assert tab.shape == (TOK_TABLE_SIZE,)
        assert np.all(np.diff(tab.astype(np.int64)) >= 0)   # sorted


def test_tok_table_compaction_path(rng, monkeypatch):
    """The host-tabled compaction (compare-sum densify + one-sort) must
    be bit-exact with the sort compaction and the scatter path."""
    from gecoz_tpu.ops import sa_device
    from gecoz_tpu.ops.sa_device import runs_token_table

    s = np.concatenate([
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=500),
        np.full(700, ord("N"), np.uint8),
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=500),
        np.zeros(1, np.uint8)])
    want = suffix_array_numpy(s)
    syms = tuple(int(x) for x in np.unique(s))
    tab = runs_token_table(s, syms)
    assert tab is not None
    monkeypatch.setattr(sa_device, "_scatter_is_cheap",
                        lambda nvals=1: False)
    jax.clear_caches()
    try:
        for mp in (None, sa_device.runs_m_pad(s)):
            sa, bwt = sa_device._suffix_array_runs_jit(
                jnp.asarray(s), syms=syms, m_pad=mp,
                tok_table=jnp.asarray(tab))
            assert np.array_equal(np.asarray(sa), want), mp
            from gecoz_tpu.ops.sa import bwt_from_sa
            assert np.array_equal(np.asarray(bwt), bwt_from_sa(s, want))
    finally:
        jax.clear_caches()


def test_ell_bits_static_run_length_bound(rng, monkeypatch):
    """A static ell_bits bound must not change results, on both
    compaction strategies, with and without the matching tok_table —
    including the tightest legal bound (bits of the max run)."""
    from gecoz_tpu.ops import sa_device
    from gecoz_tpu.ops.sa_device import (max_run_length, runs_ell_bits,
                                         runs_token_table)

    s = np.concatenate([
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=400),
        np.full(555, ord("N"), np.uint8),
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=400),
        np.zeros(1, np.uint8)])
    want = suffix_array_numpy(s)
    syms = tuple(int(x) for x in np.unique(s))
    tight = max(1, int(max_run_length(s)).bit_length())
    assert runs_ell_bits(s) in sa_device.ELL_BITS_LADDER
    for force_sorts in (False, True):
        if force_sorts:
            monkeypatch.setattr(sa_device, "_scatter_is_cheap",
                                lambda nvals=1: False)
            jax.clear_caches()
        try:
            for ebs in (tight, runs_ell_bits(s), None):
                tab = runs_token_table(s, syms, ell_bits=ebs)
                for t in (None, tab):
                    td = None if t is None else jnp.asarray(t)
                    sa, bwt = sa_device._suffix_array_runs_jit(
                        jnp.asarray(s), syms=syms, ell_bits=ebs,
                        tok_table=td)
                    assert np.array_equal(np.asarray(sa), want), \
                        (force_sorts, ebs, t is not None)
        finally:
            if force_sorts:
                jax.clear_caches()


def test_max_run_length():
    assert max_run_length(np.frombuffer(b"AACCCA", np.uint8)) == 3
    assert max_run_length(np.frombuffer(b"A", np.uint8)) == 1
    assert max_run_length(np.zeros(0, np.uint8)) == 0
    assert max_run_length(np.full(17, 65, np.uint8)) == 17
    # chunked scan: runs crossing chunk borders merge exactly
    s = np.frombuffer(b"AAABBBBBCCBBBB", np.uint8)
    for chunk in (1, 2, 3, 4, 7, 100):
        assert max_run_length(s, _chunk=chunk) == 5, chunk
    assert max_run_length(np.full(1000, 7, np.uint8), _chunk=64) == 1000


def test_device_dispatch_auto_picks_runs(rng):
    s = np.concatenate([
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=200),
        np.full(500, ord("N"), np.uint8),
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=200),
        np.zeros(1, np.uint8)])
    for impl in ("auto", "runs", "kmer"):
        got = np.asarray(suffix_array_device(s, impl=impl))
        assert np.array_equal(got, suffix_array_numpy(s)), impl


def test_pipeline_sa_impl_round_trip(rng):
    from gecoz_tpu.ops.fmq import decode_text_jit, with_lf_table
    from gecoz_tpu.ops.pipeline import index_block
    s = np.concatenate([
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=300),
        np.full(300, ord("N"), np.uint8),
        np.zeros(1, np.uint8)])
    for impl in ("runs", "kmer"):
        blk = with_lf_table(index_block(jnp.asarray(s), sa_impl=impl))
        assert np.array_equal(np.asarray(decode_text_jit(blk)), s), impl


def test_fast_slow_delivery_paths(rng, monkeypatch):
    """Round-5 fast-path delivery (next-run rank delivered via the
    round-one carry + one sort) AND its slow branch (ties survive round
    one -> classic rerank + while_loop + placed chain inside lax.cond)
    are both bit-exact under the forced sort strategy, with and
    without the host token table."""
    from gecoz_tpu.ops import sa_device
    from gecoz_tpu.ops.sa_device import (runs_ell_bits, runs_m_pad,
                                         runs_token_table)
    monkeypatch.setattr(sa_device, "_scatter_is_cheap",
                        lambda nvals=1: False)
    jax.clear_caches()
    try:
        # periodic text -> periodic token string: repeated contexts far
        # past round one's packed depth force the SLOW branch
        s_slow = np.frombuffer(b"AC" * 3000 + b"GT\0", np.uint8)
        # random text finishes in round one -> FAST branch
        s_fast = rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                            size=4097).astype(np.uint8)
        s_fast[-1] = 0
        for s in (s_slow, s_fast):
            syms = tuple(int(x) for x in np.unique(s))
            ebs = runs_ell_bits(s)
            tab = runs_token_table(s, syms, ell_bits=ebs)
            want = suffix_array_numpy(s)
            from gecoz_tpu.ops.sa import bwt_from_sa
            for use_tab in (False, True):
                t = None if (not use_tab or tab is None) \
                    else jnp.asarray(tab)
                sa, bwt = sa_device._suffix_array_runs_jit(
                    jnp.asarray(s), syms=syms, m_pad=runs_m_pad(s),
                    tok_table=t, ell_bits=ebs)
                assert np.array_equal(np.asarray(sa), want), use_tab
                assert np.array_equal(np.asarray(bwt),
                                      bwt_from_sa(s, want))
    finally:
        jax.clear_caches()
