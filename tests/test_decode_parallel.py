"""Chunked + parallel decompress pipeline (GecoRead.java:83-175 analog)."""

import numpy as np
import pytest

from gecoz_tpu.formats.fasta import (format_fasta_record, record_size,
                                     write_fasta_segment)
from gecoz_tpu.tools import driver
from conftest import random_dna

from test_gcz_files import write_fasta


@pytest.mark.parametrize("seqlen", [1, 49, 50, 100, 137, 250])
def test_segment_writer_matches_record(rng, seqlen):
    """Any chunking of [0, n) reproduces format_fasta_record exactly."""
    data = random_dna(rng, seqlen)
    header = "chrT test"
    want = format_fasta_record(header, data)
    assert len(want) == record_size(header, seqlen)
    hbytes = b">" + header.encode() + b"\n"
    for cuts in ([], [1], [50], [49, 51], list(range(0, seqlen, 7))):
        mm = np.zeros(len(want), dtype=np.uint8)
        mm[:len(hbytes)] = np.frombuffer(hbytes, np.uint8)
        bounds = [0] + [c for c in cuts if 0 < c < seqlen] + [seqlen]
        for p0, p1 in zip(bounds, bounds[1:]):
            write_fasta_segment(mm, 0, len(hbytes), seqlen, p0, p1,
                                data[p0:p1])
        assert bytes(mm) == want, (seqlen, cuts)


def test_record_size_zero_len():
    assert record_size("h", 0) == 3          # '>h\n' ... just the header
    assert format_fasta_record("h", b"") == b">h\n"


@pytest.mark.parametrize("threads", [1, 3])
def test_decompress_parallel_bit_exact(tmp_path, rng, threads):
    # lengths straddling line boundaries, incl. exact multiples of 50
    records = [("chr1", random_dna(rng, 5000)),
               ("chr2 exact", random_dna(rng, 1500, b"ACGTN")),
               ("chr3", random_dna(rng, 49)),
               ("chr4", random_dna(rng, 50)),
               ("chr5", random_dna(rng, 2751))]
    fa = tmp_path / "in.fa"
    write_fasta(fa, records)
    gcz = tmp_path / "out.gcz"
    driver.index_fasta(fa, gcz)
    out = tmp_path / "back.fa"
    driver.decompress(gcz, out, threads=threads)
    want = b"".join(format_fasta_record(h, s) for h, s in
                    sorted(records, key=lambda r: (-len(r[1]), r[0])))
    # NB blocks reorder sequences largest-first inside a block (TFasta
    # ordering); with the default merge policy all 5 land in one block
    assert out.read_bytes() == want


def test_decompress_device_backend_packed_lift(tmp_path, rng):
    """backend='device' decompress goes through the PACKED lift
    (device_block_from_fm_packed + 4-bit text fetch) and stays
    bit-exact."""
    records = [("chr1", random_dna(rng, 6000, b"ACGTN")),
               ("chr2", random_dna(rng, 1234))]
    fa = tmp_path / "in.fa"
    write_fasta(fa, records)
    gcz = tmp_path / "out.gcz"
    driver.index_fasta(fa, gcz, backend="numpy")
    out = tmp_path / "back.fa"
    driver.decompress(gcz, out, backend="device")
    want = b"".join(format_fasta_record(h, s) for h, s in
                    sorted(records, key=lambda r: (-len(r[1]), r[0])))
    assert out.read_bytes() == want


def test_decompress_many_small_chunks(tmp_path, rng, monkeypatch):
    """Tiny DECODE_CHUNK forces many chunk tasks crossing record bounds."""
    monkeypatch.setattr(driver, "DECODE_CHUNK", 128)
    records = [("a", random_dna(rng, 700)), ("b", random_dna(rng, 333)),
               ("c", random_dna(rng, 90))]
    fa = tmp_path / "in.fa"
    write_fasta(fa, records)
    gcz = tmp_path / "out.gcz"
    driver.index_fasta(fa, gcz)
    out = tmp_path / "back.fa"
    driver.decompress(gcz, out, threads=4)
    want = b"".join(format_fasta_record(h, s) for h, s in
                    sorted(records, key=lambda r: (-len(r[1]), r[0])))
    assert out.read_bytes() == want
