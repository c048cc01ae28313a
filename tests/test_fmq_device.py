"""Device FM query engine vs the host reference engine."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from gecoz_tpu.ops import fmq
from gecoz_tpu.ops.sa_device import suffix_array_device
from gecoz_tpu.ops.sa import suffix_array_numpy
from conftest import random_block
from test_fm import build_fm, brute_find


def make_pair(rng, nseq=3, rate=8, **kw):
    data, seqs = random_block(rng, nseq=nseq, **kw)
    fm = build_fm(data, rate)
    return data, seqs, fm, fmq.device_block_from_fm(fm)


def test_occ_inclusive_matches_host(rng):
    data, _, fm, blk = make_pair(rng)
    pos = rng.integers(0, len(data), size=64).astype(np.int32)
    for s in [0, 65, 67, 71, 84, 78, 90]:
        got = np.asarray(fmq.occ_inclusive(blk, jnp.full(64, s, jnp.int32),
                                           jnp.asarray(pos)))
        want = np.asarray(fm.occ(s, pos.astype(np.int64))) + 1
        want = np.maximum(want, 0)
        if (fm.bwt == s).sum() == 0:
            want = np.zeros_like(want)
        assert np.array_equal(got, want), s


def test_lf_matches_host(rng):
    data, _, fm, blk = make_pair(rng, nseq=4)
    idx = np.arange(len(data), dtype=np.int32)
    got = np.asarray(fmq.lf_batch(blk, jnp.asarray(idx)))
    assert np.array_equal(got, fm.lf[idx])


def test_search_batch(rng):
    data, seqs, fm, blk = make_pair(rng, nseq=2, minlen=100, maxlen=400,
                                    alphabet=b"ACGT")
    pats = []
    for plen in [1, 3, 5, 9]:
        for _ in range(5):
            pats.append(bytes(rng.choice(
                np.frombuffer(b"ACGT", np.uint8), size=plen)))
    L = max(len(p) for p in pats)
    arr = np.zeros((len(pats), L), dtype=np.uint8)
    lens = np.zeros(len(pats), dtype=np.int32)
    for i, p in enumerate(pats):
        arr[i, L - len(p):] = np.frombuffer(p, np.uint8)
        lens[i] = len(p)
    sp, ep = fmq.search_batch(blk, jnp.asarray(arr), jnp.asarray(lens))
    sp, ep = np.asarray(sp), np.asarray(ep)
    for i, p in enumerate(pats):
        hsp, hep = fm.search_range(p)
        assert (sp[i], ep[i]) == (hsp, hep), p


def test_locate_batch(rng):
    data, _, fm, blk = make_pair(rng, nseq=3)
    sa = suffix_array_numpy(data)
    rows = rng.integers(0, len(data), size=200).astype(np.int32)
    got = np.asarray(fmq.locate_batch(blk, jnp.asarray(rows)))
    assert np.array_equal(got, sa[rows])


def test_locate_batch_fused_table(rng, monkeypatch):
    """Fast locate (mark bit in lf_tab bit 31, one gather per step) must
    match the table-free walk, in both packed and plain row formats."""
    # distinct block sizes per format: lf_packed is trace-time static, so
    # one shape must not be traced under both row formats
    for pack_limit, kw in [(1 << 23, {}),
                           (16, dict(minlen=150, maxlen=260))]:
        monkeypatch.setattr(fmq, "_PACK_LIMIT", pack_limit)
        data, _, fm, blk = make_pair(rng, nseq=3, **kw)
        sa = suffix_array_numpy(data)
        rows = rng.integers(0, len(data), size=300).astype(np.int32)
        fast = jax.jit(lambda b: fmq.with_lf_table(b, decode=False))(blk)
        assert fast.lf_packed == (pack_limit > 16)
        got = np.asarray(fmq.locate_batch(fast, jnp.asarray(rows)))
        assert np.array_equal(got, sa[rows]), pack_limit


@pytest.mark.parametrize("rate", [4, 8, 32])
def test_decode_text_device(rate, rng):
    for nseq in [1, 3]:
        data, _, fm, _ = make_pair(rng, nseq=nseq, rate=rate)
        got = fmq.decode_text_device(fm)
        assert bytes(got) == bytes(data)


@pytest.mark.parametrize("rate", [16, 32])
def test_decode_k16_table(rate, rng):
    """rate % 16 == 0 builds the 12-byte LF^16 row and decodes through it."""
    data, _, fm, _ = make_pair(rng, nseq=2, rate=rate,
                               minlen=300, maxlen=900)
    blk = jax.jit(fmq.with_lf_table)(fmq.device_block_from_fm(fm))
    assert blk.lfk_k == 16 and blk.lfk_tab.shape[1] == 3
    got = np.asarray(fmq.decode_text_jit(blk))
    assert bytes(got) == bytes(data)


def test_decode_adversarial_order():
    # first sequence lexicographically larger: breaks uncorrected LF
    data = np.frombuffer(b"TTTGG\0AAACA\0CCC\0", dtype=np.uint8)
    fm = build_fm(data, rate=4)
    got = fmq.decode_text_device(fm)
    assert bytes(got) == bytes(data)


def test_decode_with_unpacked_lf_table(rng, monkeypatch):
    """Blocks past the 24-bit packing limit use the (lf, sym) pair table."""
    from gecoz_tpu.ops import fmq
    monkeypatch.setattr(fmq, "_PACK_LIMIT", 16)
    data, _, fm, _ = make_pair(rng, nseq=2, rate=4, minlen=100, maxlen=400)
    got = fmq.decode_text_device(fm)
    assert bytes(got) == bytes(data)


def test_search_batch_with_kmer_table(rng):
    """Seeded search must agree with the host engine for every length,
    including patterns with symbols absent from the block."""
    data, seqs, fm, blk = make_pair(rng, nseq=2, minlen=200, maxlen=500,
                                    alphabet=b"ACGTN")
    blk = fmq.with_kmer_table(blk)
    assert blk.has_kmer and blk.kmer_k >= 1
    pats = []
    for plen in [1, 2, 3, blk.kmer_k, blk.kmer_k + 1, 14]:
        for _ in range(4):
            pats.append(bytes(rng.choice(
                np.frombuffer(b"ACGTN", np.uint8), size=plen)))
    # absent symbol at various offsets
    pats += [b"Z", b"AZ", b"ZA", b"ACGTZ", b"ZACGTACGT", b"ACGTACGTZ"]
    # substrings guaranteed to occur
    raw = bytes(seqs[0])
    for plen in [1, 5, 11]:
        pats.append(raw[3:3 + plen])
    L = max(len(p) for p in pats)
    arr = np.zeros((len(pats), L), dtype=np.uint8)
    lens = np.zeros(len(pats), dtype=np.int32)
    for i, p in enumerate(pats):
        arr[i, L - len(p):] = np.frombuffer(p, np.uint8)
        lens[i] = len(p)
    sp, ep = fmq.search_batch(blk, jnp.asarray(arr), jnp.asarray(lens))
    sp, ep = np.asarray(sp), np.asarray(ep)
    for i, p in enumerate(pats):
        hsp, hep = fm.search_range(p)
        got = (int(sp[i]), int(ep[i]))
        if hep < hsp:
            assert got[1] < got[0], (p, got, (hsp, hep))
        else:
            assert got == (hsp, hep), p


def test_kmer_table_tiny_block(rng):
    data = np.frombuffer(b"ACGTACGTAC\0", np.uint8)
    fm = build_fm(data, 4)
    blk = fmq.with_kmer_table(fmq.device_block_from_fm(fm))
    arr = np.zeros((3, 6), dtype=np.uint8)
    for i, p in enumerate([b"ACGT", b"GTAC", b"\0"]):
        arr[i, 6 - len(p):] = np.frombuffer(p, np.uint8)
    lens = np.asarray([4, 4, 1], np.int32)
    sp, ep = fmq.search_batch(blk, jnp.asarray(arr), jnp.asarray(lens))
    for i, p in enumerate([b"ACGT", b"GTAC", b"\0"]):
        hsp, hep = fm.search_range(p)
        assert (int(sp[i]), int(ep[i])) == (hsp, hep), p


@pytest.mark.parametrize("rate", [1, 4, 32])
def test_locate_table_one_gather(rate, rng):
    """with_locate_table precomputes every row's walk (pointer doubling);
    locate then answers from one row gather and must match the true SA."""
    data, _, fm, blk = make_pair(rng, nseq=3, rate=rate,
                                 minlen=500, maxlen=2000)
    sa = suffix_array_numpy(data)
    loc = jax.jit(fmq.with_locate_table)(blk)
    assert loc.has_loc and loc.loc_tab.shape == (len(data), 2)
    rows = rng.integers(0, len(data), size=500).astype(np.int32)
    got = np.asarray(fmq.locate_batch(loc, jnp.asarray(rows)))
    assert np.array_equal(got, sa[rows])
    # distances bounded by the sampling rate
    assert int(jnp.max(loc.loc_tab[:, 1])) < rate


def test_locate_table_after_lf_table(rng):
    """Building the locate table over an lf_tab-bearing block reuses the
    fused table's corrected LF."""
    data, _, fm, blk = make_pair(rng, nseq=2, rate=8)
    sa = suffix_array_numpy(data)
    both = jax.jit(lambda b: fmq.with_locate_table(
        fmq.with_lf_table(b, decode=False)))(blk)
    rows = rng.integers(0, len(data), size=200).astype(np.int32)
    got = np.asarray(fmq.locate_batch(both, jnp.asarray(rows)))
    assert np.array_equal(got, sa[rows])


def test_flat_plane_state_matches_fused(rng, monkeypatch):
    """Large blocks use flat word/prefix arrays instead of the fused
    pair table (the [N, 2] tile tax, see DeviceFMBlock); both layouts
    must answer identically.  _PAIR_LIMIT is patched down so the flat
    branch runs at test size."""
    import jax
    import jax.numpy as jnp

    from gecoz_tpu.ops import fmq
    from gecoz_tpu.ops.pipeline import index_block

    s = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=5000)
    s[-1] = 0
    syms = tuple(int(x) for x in np.unique(s))
    blk_fused = index_block(jnp.asarray(s), symbols=syms)
    assert blk_fused.plane_pairs.shape[0] > 0
    monkeypatch.setattr(fmq, "_PAIR_LIMIT", 1)
    jax.clear_caches()
    try:
        blk_flat = index_block(jnp.asarray(s), symbols=syms)
        assert blk_flat.plane_pairs.shape[0] == 0
        assert blk_flat.plane_words.shape[0] > 0
        pats = np.stack([s[i:i + 8] for i in range(0, 512, 8)]).astype(
            np.uint8)
        lens = np.full(len(pats), 8, np.int32)
        a = fmq.search_batch(blk_fused, jnp.asarray(pats),
                             jnp.asarray(lens))
        b = fmq.search_batch(blk_flat, jnp.asarray(pats),
                             jnp.asarray(lens))
        assert np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
        assert np.array_equal(np.asarray(a[1]), np.asarray(b[1]))
        assert np.array_equal(
            np.asarray(fmq.decode_text_jit(blk_flat)), s)
    finally:
        jax.clear_caches()
