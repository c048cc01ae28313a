"""utils: metrics registry, host memory arena, bit streams."""

import numpy as np

from gecoz_tpu.utils import metrics
from gecoz_tpu.utils.bits import BitReader, BitWriter
from gecoz_tpu.utils.hostmem import ensure_arena


def test_metrics_registry():
    metrics.reset()
    with metrics.phase("test.a", 1000):
        pass
    with metrics.phase("test.a", 2000):
        pass
    with metrics.phase("test.b"):
        pass
    st = metrics.stats()
    assert st["test.a"].calls == 2
    assert st["test.a"].bytes == 3000
    assert "test.a" in metrics.report()
    metrics.reset()
    assert metrics.stats() == {}


def test_ensure_arena_idempotent():
    ensure_arena(1 << 16)
    ensure_arena(1 << 10)   # smaller: no-op


def test_bitwriter_drain_keeps_partial():
    w = BitWriter()
    w.write(0b101, 3)
    w.write(0xFF, 8)        # crosses a byte boundary
    first = w.drain()
    assert len(first) == 1
    w.write(0, 5)
    rest = w.getvalue()
    data = first + rest
    r = BitReader(data)
    assert r.read(3) == 0b101
    assert r.read(8) == 0xFF


def test_bitreader_peek_skip_align():
    w = BitWriter()
    for v, n in [(5, 3), (1, 1), (100, 7)]:
        w.write(v, n)
    data = w.getvalue()
    r = BitReader(data)
    assert r.peek(3) == 5
    r.skip(3)
    assert r.read(1) == 1
    assert r.read(7) == 100
    r.align()
    assert r.bitpos % 8 == 0


def test_slice_packed_bits_matches_unpack_repack():
    from gecoz_tpu.index.rankbv import pack_bits, slice_packed_bits
    rng = np.random.default_rng(17)
    for _ in range(200):
        n = int(rng.integers(1, 400))
        bits = rng.integers(0, 2, size=n).astype(np.uint8)
        buf = pack_bits(bits)
        s = int(rng.integers(0, n))
        ln = int(rng.integers(0, n - s + 1))
        want = pack_bits(bits[s:s + ln])
        got = slice_packed_bits(buf, s, ln)
        assert np.array_equal(got, want)
    assert slice_packed_bits(np.zeros(2, np.uint8), 3, 0).size == 0
