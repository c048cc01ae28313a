"""Hand-derived byte fixtures for the format quirks.

No JVM exists in this image (re-checked round 5), so `gecotools.jar`
byte-parity cannot be tested directly.  The streaming emulator
(tests/emulator.py) and the frozen golden fixtures are cross-checks, but
both encode ONE author's reading of the Java sources — a consistently
misread quirk would pass both.  Each fixture below is therefore derived
BY HAND in its comment, from the reference's documented layout rules
alone (file:line cited), with every intermediate value written out so a
reviewer can re-do the arithmetic without running any code from this
repo.
"""

import numpy as np

from gecoz_tpu.index.rankbv import pack_bits, rbv_bytes, serialize_rbv


def test_rbv_short_counter_520_bits():
    """RankedWTNode layout, one interleaved short (RankedWTNode.java:
    213-245): a counter precedes every 64-data-byte group except the
    first, holding the rank WITHIN the current 64 Kbit segment as u16 LE.

    Hand derivation for 520 one-bits (LSB-first pack = 65 bytes 0xFF):
      size  = ((520-1)>>16)*6 + ((520-1)>>9)*2 + ((520+7)>>3)
            = 0*6            + 1*2            + 65         = 67 bytes
      layout: [64 data bytes][u16 counter][1 data byte]
      counter value = ones in the first 512 bits = 512 = 0x0200
                    -> LE bytes 00 02
    """
    bits = np.ones(520, np.uint8)
    expect = b"\xff" * 64 + b"\x00\x02" + b"\xff"
    assert rbv_bytes(520) == 67
    assert serialize_rbv(pack_bits(bits), 520) == expect


def test_rbv_absolute_counter_at_64kbit():
    """The 64 Kbit boundary counter is an 8-byte ABSOLUTE rank replacing
    the short (RankedWTNode.java:213-245; getLong period 8454 = 8192 data
    + 127*2 + 8).

    Hand derivation for 65544 bits of 0x55 (01010101: 4 ones/byte,
    8193 packed bytes):
      size = ((65544-1)>>16)*6 + ((65544-1)>>9)*2 + ((65544+7)>>3)
           = 1*6 + 128*2 + 8193 = 8455 bytes
      group k (64 data bytes each) is preceded, for k >= 1, by:
        k % 128 != 0 -> u16 LE of (ones before group k within segment)
                        = k * 64 bytes * 4 ones = 256k
        k % 128 == 0 -> u64 LE of the ABSOLUTE ones before
                        = 128 * 64 * 4 = 32768
      group 128 holds the single remaining data byte (bits 65536..65543).
    """
    expect = bytearray()
    for k in range(129):
        if k >= 1:
            if k % 128 == 0:
                expect += (32768).to_bytes(8, "little")
            else:
                expect += (256 * k).to_bytes(2, "little")
        expect += b"\x55" * (64 if k < 128 else 1)
    assert len(expect) == 8455 == rbv_bytes(65544)
    bits = np.tile(np.array([1, 0, 1, 0, 1, 0, 1, 0], np.uint8), 8193)
    assert serialize_rbv(pack_bits(bits[:65544]), 65544) == bytes(expect)


def test_sampling_factor_from_sizes():
    """Sampling factor recovered from .gcx size, never stored
    (GSSAIndex.java:62-67, GecozFileReader.java:140-149): the reader
    tries sf = 0, 1, 2, ... until the .gcx payload is large enough.

    Hand derivation for one block of len 100, actual sf = 2:
      index_size(100, sf) = iwt + rbv, where
        rbv(L)  = ((L-1)>>16)*6 + ((L-1)>>9)*2 + ((L+7)>>3)
        iwt     = rbv(m) * bit_length(m),  m = ceil(100 / 2^sf)
      sf=0: m=100, rbv(100) = 0+0+13 = 13, levels = bl(100) = 7
            -> 13*7 + 13 = 104
      sf=1: m=50,  rbv(50)  = 0+0+7,      levels = bl(50)  = 6
            -> 7*6 + 13 = 55
      sf=2: m=25,  rbv(25)  = 0+0+4,      levels = bl(25)  = 5
            -> 4*5 + 13 = 33
      payload of exactly 33 bytes: 33 < 104, 33 < 55, 33 >= 33 -> sf=2.
    """
    from types import SimpleNamespace

    from gecoz_tpu.formats.gcz import SSA_HEADER_LEN, GecozReader
    from gecoz_tpu.index.ssa import index_size

    assert index_size(100, 0) == 104
    assert index_size(100, 1) == 55
    assert index_size(100, 2) == 33
    stub = SimpleNamespace(
        ssa_data=np.zeros(SSA_HEADER_LEN + 33, np.uint8),
        headers=[SimpleNamespace(len=100)])
    assert GecozReader._derive_sampling_factor(stub) == 2


def test_header_hash_by_hand():
    """Java-style 31x string hash mod 2^64 (GecozRefBlockHeader.java:
    120-128): h = 1125899906842597; h = h*31 + ord(ch) per character.

    Hand derivation for headers ["AB"] (no 2^64 wrap yet):
      h0 = 1125899906842597
      h1 = h0*31 + 65  = 34902897112120507  + 65 = 34902897112120572
      h2 = h1*31 + 66  = 1081989810475737732 + 66 = 1081989810475737798

    And for ["zzzzz"] (wraps 2^64 — the overflow quirk):
      h1 = 1125899906842597*31 + 122         = 34902897112120629
      h2 = 34902897112120629*31 + 122        = 1081989810475739621
      h3 = 1081989810475739621*31 + 122      = 33541684124747928373
         mod 2^64 (2^64 = 18446744073709551616)
         -> 33541684124747928373 - 18446744073709551616
         = 15094940051038376757
      h4 = 15094940051038376757*31 + 122
         = 467943141582189679589 mod 2^64
         467943141582189679589 - 25*18446744073709551616
         = 467943141582189679589 - 461168601842738790400
         = 6774539739450889189
      h5 = 6774539739450889189*31 + 122
         = 210010731922977564981 mod 2^64
         210010731922977564981 - 11*18446744073709551616
         = 210010731922977564981 - 202914184810805067776
         = 7096547112172497205
    """
    from gecoz_tpu.formats.gcz import header_hash

    assert header_hash(["AB"]) == 1081989810475737798
    assert header_hash(["zzzzz"]) == 7096547112172497205


def test_ref_block_header_bytes_by_hand():
    """GecozRefBlockHeader layout (write:90-101): magic "GecozBWT",
    version byte 1, size u64 LE, len u64 LE, each header \\0-terminated,
    then a final \\0.

    Hand derivation for headers=["chr1"], size=300 (0x12C), len=120:
      "GecozBWT" + 01
      + 2C 01 00 00 00 00 00 00      (300 LE)
      + 78 00 00 00 00 00 00 00      (120 LE)
      + "chr1" 00 + 00
    total = 8 + 1 + 8 + 8 + 5 + 1 = 31 bytes = 26 + len("chr1") + 1.
    """
    from gecoz_tpu.formats.gcz import RefBlockHeader, ref_header_length

    expect = (b"GecozBWT" + b"\x01"
              + b"\x2c\x01\x00\x00\x00\x00\x00\x00"
              + b"\x78\x00\x00\x00\x00\x00\x00\x00"
              + b"chr1\x00" + b"\x00")
    assert ref_header_length(["chr1"]) == 31
    got = RefBlockHeader(["chr1"], 300, 120).write()
    assert got == expect
    back = RefBlockHeader.parse(expect, 0)
    assert (back.headers, back.size, back.len) == (["chr1"], 300, 120)


def test_ssa_block_header_bytes_by_hand():
    """GecozSSABlockHeader (GecozSSABlockHeader.java:38-79): fixed
    25 bytes = "GecozSSA" + version 01 + len u64 LE + headers-hash u64 LE.

    Hand derivation for headers ["AB"], idx_size = 33:
      "GecozSSA" + 01
      + 21 00 00 00 00 00 00 00          (33 LE)
      + hash(["AB"]) = 1081989810475737798  (derived above)
        = 0x0F 04 54 6A 6E 65 01 46 ... as LE bytes:
        1081989810475737798
          = 0x0F04546A6E650146? verify: the test computes LE bytes from
          the hand-derived integer with int.to_bytes — the integer is
          the hand-derived value, the byte order is the format rule.
    """
    from gecoz_tpu.formats.gcz import write_ssa_header

    expect = (b"GecozSSA" + b"\x01"
              + (33).to_bytes(8, "little")
              + (1081989810475737798).to_bytes(8, "little"))
    assert len(expect) == 25
    assert write_ssa_header(["AB"], 33) == expect


def test_bitwriter_lsb_first_by_hand():
    """LSB-first bit packing (AbstractBitStream.java:38-194 convention).

    Hand derivation: write 5 (3 bits), 1 (2 bits), 7 (3 bits):
      bit 0..2 = 101 (5 = 0b101, LSB first)
      bit 3..4 = 10  (1 = 0b01)
      bit 5..7 = 111 (7)
      byte = 1*1 + 0*2 + 1*4 + 1*8 + 0*16 + 1*32 + 1*64 + 1*128
           = 1 + 4 + 8 + 32 + 64 + 128 = 237 = 0xED
    """
    from gecoz_tpu.utils.bits import BitWriter

    w = BitWriter()
    w.write(5, 3)
    w.write(1, 2)
    w.write(7, 3)
    assert w.getvalue() == b"\xed"


def test_huffman_tie_break_by_hand():
    """Two-minimum merge with first-index-wins ties (HuffmanEncodeTable.
    java:48-111) — the shape-table bytes depend on these exact lengths.

    Hand derivation for counts [5, 2, 2, 1] (symbols s0..s3):
      round 1: scan -> min1 = 1@s3 (strictly smallest, first),
               min2 = 2@s1 (the FIRST 2 — s2's equal 2 does not displace
               it under strict compare).  s3,s1 gain a bit; merged
               weight 3 parks in s1's slot, s3's slot dies.
               lengths [0,1,0,1], weights [5,3,2,-]
      round 2: min1 = 2@s2, min2 = 3@s1(group {s1,s3}).
               lengths [0,2,1,2], weights [5,5,-,-] (5 in s1's slot)
      round 3: min1 = 5@s0 (first of the tied 5s), min2 = 5@s1
               (group {s1,s3,s2}).
               lengths [1,3,2,3]
      Kraft: 2^-1 + 2^-3 + 2^-2 + 2^-3 = 1.  The fingerprint is s1
      getting length 3 while its equal-count twin s2 gets 2 — any other
      tie rule flips them.
    """
    from gecoz_tpu.huffman.core import huffman_bit_lengths

    got = huffman_bit_lengths([5, 2, 2, 1])
    assert got.tolist() == [1, 3, 2, 3]
