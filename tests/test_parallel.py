"""Block-parallel encode: batched padded suffix sorts + scheduling."""

import numpy as np
import pytest

pytest.importorskip("jax")

from gecoz_tpu.parallel.mesh import (encode_blocks, index_fasta_parallel,
                                     largest_first_schedule,
                                     suffix_arrays_batched)
from gecoz_tpu.formats.gcz import encode_block
from gecoz_tpu.ops.sa import suffix_array_numpy
from conftest import random_block, random_dna
from test_gcz_files import write_fasta


def test_schedule_balanced():
    assign = largest_first_schedule([100, 90, 10, 10, 10, 10], 2)
    loads = [sum(s for s, a in zip([100, 90, 10, 10, 10, 10], assign)
                 if a == k) for k in (0, 1)]
    assert abs(loads[0] - loads[1]) <= 20
    assert len(set(assign)) == 2


def test_padded_batched_sa_is_exact(rng):
    blocks = []
    for nseq in (1, 2, 4):
        data, _ = random_block(rng, nseq=nseq, minlen=20, maxlen=700)
        blocks.append(data)
    got = suffix_arrays_batched(blocks)
    for b, sa in zip(blocks, got):
        assert np.array_equal(sa, suffix_array_numpy(b))


def test_padded_batched_sa_with_bwt(rng):
    """with_bwt returns the TRUE per-block BWT off the padded device
    rows — including the wrap row patch for a block not ending in \\0."""
    from gecoz_tpu.ops.sa import bwt_from_sa

    blocks = []
    for nseq in (1, 3):
        data, _ = random_block(rng, nseq=nseq, minlen=20, maxlen=500)
        blocks.append(data)
    # a block that does NOT end in \0 (wrap row reads the padding)
    raw = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=93)
    raw[40] = 0
    assert raw[-1] != 0
    blocks.append(raw)
    got = suffix_arrays_batched(blocks, with_bwt=True)
    for b, (sa, bwt) in zip(blocks, got):
        want_sa = suffix_array_numpy(b)
        assert np.array_equal(sa, want_sa)
        assert np.array_equal(bwt, bwt_from_sa(b, want_sa))


def test_encode_blocks_matches_sequential(rng):
    blocks, headers = [], []
    for i in range(4):
        data, _ = random_block(rng, nseq=2, minlen=50, maxlen=400)
        blocks.append(data)
        headers.append([f"s{i}a", f"s{i}b"])
    par = encode_blocks(blocks, headers)
    for (gcz, gcx), data, hdrs in zip(par, blocks, headers):
        sgcz, sgcx = encode_block(data, hdrs, backend="numpy")
        assert gcz == sgcz
        assert gcx == sgcx


def test_encode_blocks_device_wavelet_identical(rng):
    """backend='device' (jax wavelet kernel) emits the same bytes as the
    host tier — the mesh writer's device path is byte-compatible."""
    blocks, headers = [], []
    for i in range(3):
        data, _ = random_block(rng, nseq=2, minlen=50, maxlen=400)
        blocks.append(data)
        headers.append([f"d{i}a", f"d{i}b"])
    dev = encode_blocks(blocks, headers, backend="device")
    host = encode_blocks(blocks, headers, backend="host")
    assert dev == host


def test_index_fasta_parallel_file_identical(tmp_path, rng):
    records = [(f"chr{i}", random_dna(rng, int(rng.integers(200, 2000))))
               for i in range(6)]
    fa = tmp_path / "in.fa"
    write_fasta(fa, records)
    from gecoz_tpu.tools import driver
    a = tmp_path / "seq.gcz"
    b = tmp_path / "par.gcz"
    driver.index_fasta(fa, a)
    index_fasta_parallel(fa, b)
    assert a.read_bytes() == b.read_bytes()
    assert (tmp_path / "seq.gcx").read_bytes() == \
        (tmp_path / "par.gcx").read_bytes()


def test_prewarm_buckets_compiles_future_buckets(monkeypatch):
    """prewarm_buckets AOT-compiles exactly the large distinct buckets
    (compile-storm mitigation)."""
    import gecoz_tpu.parallel.mesh as mesh

    calls = []

    class _FakeJit:
        def __init__(self, npad, m_pad, use_table):
            self.npad = npad
            self.m_pad = m_pad
            self.use_table = use_table

        def lower(self, shape, *extra):
            calls.append((self.npad, self.m_pad, self.use_table,
                          shape.shape, tuple(e.shape for e in extra)))
            return self

        def compile(self):
            return None

    monkeypatch.setattr(
        mesh, "_single_sa",
        lambda npad, syms, m_pad=None, use_table=False, ell_bits=None,
        r1_keys=None: _FakeJit(npad, m_pad, use_table))
    small = 1 << 20
    big1, big2 = 20 << 20, 70 << 20
    threads = mesh.prewarm_buckets([small, big1, big2, big1],
                                   (0, 65, 67, 71, 84))
    for t in threads:
        t.join(10)
    # each large distinct bucket warms both DNA-typical m_pad rungs, in
    # the tok_table variant (the production-common program)
    want = sorted(
        (b, mp) for b in {mesh._bucket_size(big1), mesh._bucket_size(big2)}
        for mp in ((3 * b) // 4, (13 * b) // 16))
    assert sorted((c[0], c[1]) for c in calls) == want
    from gecoz_tpu.ops.sa_device import TOK_TABLE_SIZE
    for npad, m_pad, use_table, shape, extra in calls:
        assert use_table and shape == (npad,)
        assert extra == ((TOK_TABLE_SIZE,),)
