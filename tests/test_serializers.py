"""Vectorized serializers vs the streaming emulator (bit-exactness layer 0)."""

import numpy as np
import pytest

from gecoz_tpu.index.rankbv import (RankBitVector, deserialize_rbv, pack_bits,
                                    rbv_bytes, serialize_rbv)
from gecoz_tpu.index.iwt import IndexWaveletTree, deserialize_iwt, iwt_size
from emulator import emulate_iwt, emulate_rbv

LENGTHS = [1, 7, 8, 63, 64, 65, 511, 512, 513, 1000, 4095, 4096,
           65535, 65536, 65537, 70000, 200000]


@pytest.mark.parametrize("n", LENGTHS)
def test_rbv_serialize_matches_streaming_emulator(n, rng):
    bits = rng.integers(0, 2, size=n).astype(np.uint8)
    mine = serialize_rbv(pack_bits(bits), n)
    ref = emulate_rbv(bits)
    assert len(mine) == rbv_bytes(n)
    assert mine == ref


@pytest.mark.parametrize("n", LENGTHS)
def test_rbv_roundtrip(n, rng):
    bits = rng.integers(0, 2, size=n).astype(np.uint8)
    data = pack_bits(bits)
    buf = np.frombuffer(serialize_rbv(data, n), dtype=np.uint8)
    back = deserialize_rbv(buf, n)
    assert np.array_equal(back, data)


@pytest.mark.parametrize("n", [1, 64, 513, 5000, 66000])
def test_rbv_rank_select(n, rng):
    bits = rng.integers(0, 2, size=n).astype(np.uint8)
    bv = RankBitVector.from_bits(bits)
    cum = np.cumsum(bits)
    idx = rng.integers(0, n, size=min(n, 200))
    assert np.array_equal(bv.rank1_inclusive(idx), cum[idx])
    assert np.array_equal(np.asarray(bv.get(idx)), bits[idx])
    ones = np.flatnonzero(bits)
    for k in [1, len(ones) // 2, len(ones)]:
        if k >= 1 and len(ones):
            assert bv.select1(np.array([k]))[0] == ones[k - 1]
    assert bv.select1(np.array([len(ones) + 1]))[0] == -1


def test_select1_superblock_guided_large(rng):
    """select1 at >=100M bits (sparse), vs the known one positions —
    exercises the superblock + word search across 64Kbit segments
    (RankedWTNode.findOne:145-194 scale)."""
    from gecoz_tpu.index.rankbv import RankBitVector
    length = 100_000_019
    ones = np.unique(rng.integers(0, length, size=30_000))
    packed = np.zeros((length + 7) >> 3, dtype=np.uint8)
    np.bitwise_or.at(packed, ones >> 3, (1 << (ones & 7)).astype(np.uint8))
    bv = RankBitVector(packed, length)
    qs = np.unique(rng.integers(1, len(ones) + 1, size=512))
    assert np.array_equal(bv.select1(qs), ones[qs - 1])
    assert bv.select1(1) == ones[0]
    assert bv.select1(len(ones)) == ones[-1]
    assert bv.select1(len(ones) + 1) == -1
    assert np.array_equal(bv.rank1_inclusive(ones[qs - 1]), qs)


@pytest.mark.parametrize("n", [1, 511, 513, 65537, 70000])
def test_rbv_native_and_numpy_paths_agree(n, rng, monkeypatch):
    """The C++ interleaver and the pure-numpy fallback are independent
    implementations; both must produce the reference layout."""
    from gecoz_tpu import native
    import gecoz_tpu.index.rankbv as rankbv
    bits = rng.integers(0, 2, size=n).astype(np.uint8)
    data = pack_bits(bits)
    via_auto = serialize_rbv(data, n)

    monkeypatch.setattr(native, "available", lambda: False)
    via_numpy = serialize_rbv(data, n)
    assert via_auto == via_numpy
    back = deserialize_rbv(np.frombuffer(via_numpy, np.uint8), n)
    assert np.array_equal(back, data)


@pytest.mark.parametrize("n", [1, 2, 3, 63, 64, 65, 513, 1000, 5000])
def test_iwt_serialize_matches_java_scatter(n, rng):
    perm = rng.permutation(n).astype(np.int64)
    mine = IndexWaveletTree(perm).serialize()
    ref = emulate_iwt(perm)
    assert len(mine) == iwt_size(n)
    assert mine == ref


@pytest.mark.parametrize("n", [1, 5, 64, 513, 5000])
def test_iwt_roundtrip(n, rng):
    perm = rng.permutation(n).astype(np.int64)
    buf = np.frombuffer(IndexWaveletTree(perm).serialize(), dtype=np.uint8)
    back = deserialize_iwt(buf, n)
    assert np.array_equal(back, perm)


# -- in-place (interleaved-stream) query tier --------------------------------

INPLACE_LENGTHS = [1, 511, 513, 4096, 65535, 65536, 65537, 200000, 300000]


@pytest.mark.parametrize("n", INPLACE_LENGTHS)
def test_rbv_inplace_rank_select_get(n, rng):
    """Lazy vectors answer rank/select/get straight off the interleaved
    stream (RankedWTNode.count:98-122 / findOne:145-194 semantics) with no
    deinterleave and no prefix rebuild."""
    bits = rng.integers(0, 2, size=n).astype(np.uint8)
    buf = np.frombuffer(serialize_rbv(pack_bits(bits), n), dtype=np.uint8)
    bv = RankBitVector.from_interleaved(buf, n)
    cum = np.cumsum(bits)
    idx = rng.integers(0, n, size=min(n, 300))
    assert np.array_equal(bv.rank1_inclusive(idx), cum[idx])
    assert int(bv.rank1_inclusive(np.int64(n - 1))) == int(cum[-1])
    assert np.array_equal(np.asarray(bv.get(idx)), bits[idx])
    ones = np.flatnonzero(bits)
    zeros = np.flatnonzero(bits == 0)
    if len(ones):
        ks = np.unique(rng.integers(1, len(ones) + 1, size=64))
        assert np.array_equal(bv.select1(ks), ones[ks - 1])
        assert int(bv.select1(len(ones))) == ones[-1]
    assert int(bv.select1(len(ones) + 1)) == -1
    if len(zeros):
        ks = np.unique(rng.integers(1, len(zeros) + 1, size=64))
        assert np.array_equal(bv.select0(ks), zeros[ks - 1])
        assert int(bv.select0(len(zeros))) == zeros[-1]
    assert int(bv.select0(len(zeros) + 1)) == -1
    # every query above stayed on the stream
    assert bv._data is None and not bv._built


@pytest.mark.parametrize("n", [1, 511, 65537])
def test_rbv_select0_built_tier(n, rng):
    bits = rng.integers(0, 2, size=n).astype(np.uint8)
    bv = RankBitVector.from_bits(bits)
    zeros = np.flatnonzero(bits == 0)
    if len(zeros):
        ks = np.unique(rng.integers(1, len(zeros) + 1, size=64))
        assert np.array_equal(bv.select0(ks), zeros[ks - 1])
    assert int(bv.select0(len(zeros) + 1)) == -1


def test_rbv_inplace_skewed_density(rng):
    """Sparse and dense vectors crossing several 64Kbit segments."""
    n = 250_000
    for p in (0.001, 0.999):
        bits = (rng.random(n) < p).astype(np.uint8)
        buf = np.frombuffer(serialize_rbv(pack_bits(bits), n), np.uint8)
        bv = RankBitVector.from_interleaved(buf, n)
        cum = np.cumsum(bits)
        idx = rng.integers(0, n, size=200)
        assert np.array_equal(bv.rank1_inclusive(idx), cum[idx])
        ones = np.flatnonzero(bits)
        if len(ones):
            ks = np.unique(rng.integers(1, len(ones) + 1, size=64))
            assert np.array_equal(bv.select1(ks), ones[ks - 1])
        assert bv._data is None and not bv._built


@pytest.mark.parametrize("n", [1, 2, 5, 64, 513, 5000, 70000])
def test_lazy_iwt_get_find_in_place(n, rng):
    """LazyIWT answers get/find via plane walks (IndexWaveletTree.java:
    127-165) without materializing the permutation."""
    from gecoz_tpu.index.iwt import LazyIWT
    perm = rng.permutation(n).astype(np.int64)
    buf = np.frombuffer(IndexWaveletTree(perm).serialize(), dtype=np.uint8)
    lz = LazyIWT(buf, n)
    pos = rng.integers(0, n, size=min(n, 200))
    assert np.array_equal(np.asarray(lz.get(pos)), perm[pos])
    inv = np.zeros(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    vals = rng.integers(0, n, size=min(n, 200))
    assert np.array_equal(np.asarray(lz.find(vals)), inv[vals])
    assert int(lz.get(np.int64(0))) == int(perm[0])
    assert int(lz.find(np.int64(0))) == int(inv[0])
    for pl in lz.planes:
        assert pl._data is None and not pl._built


def test_cold_count_never_deinterleaves(rng, tmp_path, monkeypatch):
    """Regression for a slow cold count: a count
    (+ locate) on a freshly opened index must answer entirely from the
    interleaved streams — any full-node deinterleave or IWT
    materialization fails the test."""
    from gecoz_tpu.formats.gcz import GecozReader, GecozWriter
    from conftest import random_block
    data, _ = random_block(rng, nseq=3, minlen=3000, maxlen=9000)
    gcz = tmp_path / "t.gcz"
    with GecozWriter(gcz, None, 32, backend="host") as w:
        w.write(["a", "b", "c"], data)
    reader = GecozReader(gcz)
    fm = reader.read(reader.headers[0])
    expected = fm.find(b"ACGT")

    import gecoz_tpu.index.rankbv as rankbv
    import gecoz_tpu.index.iwt as iwt_mod

    def boom(*a, **k):
        raise AssertionError("full deinterleave on the count path")

    monkeypatch.setattr(rankbv, "deserialize_rbv", boom)
    monkeypatch.setattr(iwt_mod, "deserialize_iwt", boom)
    monkeypatch.setattr(rankbv.RankBitVector, "_ensure", boom)
    reader2 = GecozReader(gcz)
    fm2 = reader2.read(reader2.headers[0])
    res = fm2.find(b"ACGT")
    assert set(res) == set(expected)
    for k in expected:
        assert np.array_equal(np.sort(res[k]), np.sort(expected[k]))
    assert fm2.count_total(b"ACGT") == sum(len(v) for v in expected.values())
