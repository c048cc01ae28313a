"""Block-parallel encoding over a device mesh.

The reference scales with a bounded thread pool over independent blocks
(GecozFileWriter.WriterPoolExecutor, GecozFileWriter.java:174-227, with
largest-blocks-first submission, GecoIndex.java:88-98).  The equivalent
here is data parallelism over the mesh's 'block' axis:

* the block plan (gecoz_tpu.tools.blocks) is scheduled largest-first onto
  shards, size-balanced (greedy LPT — the static analog of the reference's
  work queue);
* each batch of equal-bucket blocks is padded with trailing ``\\0`` bytes
  to a common length — appending zeros PRESERVES the relative order of all
  real suffixes (a suffix entering the padding reads ``\\0`` which is
  exactly the virtual-end semantics), so the true per-block SA is the
  padded SA filtered to entries < real length;
* the padded batch runs one vmapped/sharded suffix-sort step on the mesh,
  and hosts serialize their shard's blocks; compressed bytes are gathered
  in header order by the writer (multi-host: process 0 writes).

On a single host this degenerates to efficient batched encoding on the
local devices; under `jax.distributed` each process encodes its shard.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np


def largest_first_schedule(sizes: list[int], n_shards: int) -> list[int]:
    """Greedy LPT: assign each block (largest first) to the least-loaded
    shard; returns shard id per block."""
    order = np.argsort([-s for s in sizes], kind="stable")
    load = np.zeros(n_shards, dtype=np.int64)
    assign = np.zeros(len(sizes), dtype=np.int64)
    for i in order:
        shard = int(np.argmin(load))
        assign[i] = shard
        load[shard] += sizes[i]
    return assign.tolist()


def _bucket_size(n: int) -> int:
    """Round up to the next 1/16-octave step (<= 6.25% padding, at most
    16 compile keys per power of two — the persistent compilation cache
    amortizes them).  Power-of-two rounding padded mid-size genomic
    blocks by up to ~2x (chr9's 145 MB -> 268 MB)."""
    bl = max(8, (n - 1).bit_length())
    step = 1 << max(4, bl - 4)
    return -(-n // step) * step


@functools.cache
def _batched_sa(npad: int, syms: tuple[int, ...] | None,
                m_pad: int | None = None, use_table: bool = False,
                ell_bits: int | None = None, r1_keys: int | None = None):
    import jax

    from gecoz_tpu.ops.sa_device import _suffix_array_runs_jit

    # run-aware variant: the trailing zero padding is one run, fully
    # ordered by the seed sort — the k-mer doubling variant would pay
    # ~log2(pad length) extra rounds on it (and on genomic N runs).
    # `syms` (the batch's static alphabet, when small) enables the packed
    # 1-key seed sort — one fewer n-wide operand in the seed round.
    # With use_table, callers pass the (shared) run-key table as a traced
    # second argument — sort-free compaction, one program for all tables.
    if use_table:
        return jax.jit(jax.vmap(
            lambda s, t: _suffix_array_runs_jit(
                s, syms=syms, m_pad=m_pad, tok_table=t,
                ell_bits=ell_bits, r1_keys=r1_keys),
            in_axes=(0, None)))
    return jax.jit(jax.vmap(lambda s: _suffix_array_runs_jit(
        s, syms=syms, m_pad=m_pad, ell_bits=ell_bits)))


@functools.cache
def _single_sa(npad: int, syms: tuple[int, ...] | None,
               m_pad: int | None = None, use_table: bool = False,
               ell_bits: int | None = None, r1_keys: int | None = None):
    import jax

    from gecoz_tpu.ops.sa_device import _suffix_array_runs_jit

    # singleton buckets skip vmap: chr1-class blocks get the un-batched
    # kernel (minimal memory)
    if use_table:
        return jax.jit(lambda s, t: _suffix_array_runs_jit(
            s, syms=syms, m_pad=m_pad, tok_table=t, ell_bits=ell_bits,
            r1_keys=r1_keys))
    return jax.jit(lambda s: _suffix_array_runs_jit(
        s, syms=syms, m_pad=m_pad, ell_bits=ell_bits))


@functools.cache
def _state_fn(npad: int, n: int, sf: int):
    """Device program deriving the serialization-side SA state:
    (packed mark bits, sampled-value permutation, compacted BWT) from the
    PADDED (sa, bwt) pair, all on device.

    The host only ever serializes DERIVED artifacts: mark bits (n/8),
    sampled values (n/8) and wavelet node bits (~0.3n), so this program
    computes them where the SA already lives instead of fetching the
    full int32 SA + BWT (5 bytes/char).  Kept SEPARATE from the SA
    program so the two programs' peak memory does not add up.
    """
    import jax
    import jax.numpy as jnp

    from gecoz_tpu.ops.fmq import _pack_bits_jit

    rate = 1 << sf
    m = (n + rate - 1) >> sf

    def f(sa_pad, bwt_pad, last_byte):
        iota = jnp.arange(npad, dtype=jnp.int32)
        if npad != n:
            # drop the padding rank slots (sa >= n), keeping order: the
            # position-banded key is distinct, so one unstable 3-op sort
            key = jnp.where(sa_pad < n, iota, jnp.int32(npad) + iota)
            _, sa, bwt = jax.lax.sort((key, sa_pad, bwt_pad), num_keys=1,
                                      is_stable=False)
            sa, bwt = sa[:n], bwt[:n]
        else:
            sa, bwt = sa_pad, bwt_pad
        # the rank-0 row read the zero padding (or wrapped): its true BWT
        # byte is data[n-1] — an unconditional fix, correct in all cases
        bwt = jnp.where(sa == 0, last_byte.astype(jnp.uint8), bwt)
        marked = (sa & (rate - 1)) == 0
        mark_words = _pack_bits_jit(marked)
        iota_n = jnp.arange(n, dtype=jnp.int32)
        pkey = ((~marked).astype(jnp.int32) << 30) | iota_n
        _, perm = jax.lax.sort((pkey, sa >> sf), num_keys=1,
                               is_stable=False)
        return mark_words, perm[:m], bwt

    return jax.jit(f)


def index_states_batched(blocks: list[np.ndarray], sampling_rate: int
                         ) -> list:
    """Device-tier index states for variable-length blocks with MINIMAL
    wire traffic: packed uploads (utils/xfer), per-bucket SA kernels,
    on-device sampling/compaction, device-resident BWT handed to the
    wavelet builder.

    Returns per block: (mark_bytes uint8[ceil(n/8)..], perm int32[m],
    bwt_dev) — bwt_dev is a DEVICE array (or a host ndarray for blocks
    routed through the sharded kernel)."""
    import jax
    import jax.numpy as jnp

    from gecoz_tpu.ops.sa_device import (ELL_BITS_LADDER, TOK_TABLE_SIZE,
                                         max_run_length, runs_m_pad,
                                         runs_r1_keys, runs_token_table)
    from gecoz_tpu.utils import accel, xfer

    sf = sampling_rate.bit_length() - 1

    buckets: dict[int, list[int]] = {}
    sharded: list[int] = []
    for i, b in enumerate(blocks):
        if accel.needs_sharded_sa(len(b)) and len(jax.devices()) > 1:
            sharded.append(i)
        else:
            buckets.setdefault(_bucket_size(len(b)), []).append(i)

    out: list = [None] * len(blocks)
    for i in sharded:
        from gecoz_tpu.parallel.sharded_sa import suffix_array_sharded
        sa_sh, bwt_sh = suffix_array_sharded(blocks[i])
        sa = np.asarray(sa_sh).astype(np.int64)
        bwt = np.asarray(bwt_sh)
        rate = 1 << sf
        marked = (sa & (rate - 1)) == 0
        from gecoz_tpu.index.rankbv import pack_bits
        out[i] = (pack_bits(marked.astype(np.uint8)),
                  (sa[marked] >> sf).astype(np.int32), bwt)

    staged = []
    for npad, idxs in buckets.items():
        batch = np.zeros((len(idxs), npad), dtype=np.uint8)
        for row, i in enumerate(idxs):
            batch[row, :len(blocks[i])] = blocks[i]
        syms = tuple(int(x) for x in np.flatnonzero(
            np.bincount(batch.reshape(-1), minlength=256)))
        if len(syms) > 7:
            syms = None
        m_pad = max(runs_m_pad(batch[row]) for row in range(len(idxs)))
        mx_bits = max(1, int(max(max_run_length(batch[row])
                                 for row in range(len(idxs)))).bit_length())
        ell_bits = next((r for r in ELL_BITS_LADDER if mx_bits <= r), None)
        tabs = [runs_token_table(batch[row], syms, ell_bits=ell_bits)
                for row in range(len(idxs))]
        tab = None
        if all(t is not None for t in tabs):
            union = sorted({int(v) for t in tabs
                            for v in t if v != (1 << 31) - 1})
            if len(union) <= TOK_TABLE_SIZE:
                tab = np.full(TOK_TABLE_SIZE, (1 << 31) - 1, np.int32)
                tab[:len(union)] = union
        if len(idxs) == 1:
            dev = xfer.put_packed(blocks[idxs[0]], pad_to=npad)
        else:
            dev = jnp.asarray(batch)
        staged.append((npad, idxs, syms, m_pad, ell_bits, tab,
                       runs_r1_keys(tab), dev))
        del batch

    for npad, idxs, syms, m_pad, ell_bits, tab, r1, dev in staged:
        if len(idxs) == 1:
            fn = _single_sa(npad, syms, m_pad, tab is not None, ell_bits,
                            r1)
        else:
            fn = _batched_sa(npad, syms, m_pad, tab is not None, ell_bits,
                             r1)
        args = (dev,) if tab is None else (dev, jnp.asarray(tab))
        sa_dev, bwt_dev = fn(*args)
        del dev
        for row, i in enumerate(idxs):
            n = len(blocks[i])
            last = jnp.asarray(np.uint8(blocks[i][n - 1] if n else 0))
            sfn = _state_fn(npad, n, sf)
            sa_row = sa_dev if len(idxs) == 1 else sa_dev[row]
            bwt_row = bwt_dev if len(idxs) == 1 else bwt_dev[row]
            mark_words, perm, bwt_n = sfn(sa_row, bwt_row, last)
            # fetch only the derived artifacts (~n/4 bytes); the BWT
            # stays device-resident for the wavelet kernel
            mark_bytes = np.ascontiguousarray(
                np.asarray(mark_words)).view(np.uint8)[: (n + 7) // 8]
            out[i] = (mark_bytes, np.asarray(perm), bwt_n)
        del sa_dev, bwt_dev
    return out


PREWARM_MIN_BYTES = 16 << 20


def prewarm_buckets(sizes: list[int], syms: tuple[int, ...] | None) -> list:
    """Pre-compile the singleton SA programs for future large buckets on a
    daemon thread (first-run compile-storm mitigation).

    An hg38-profile encode needs ~3 distinct large-block programs;
    compiling them concurrently with the FASTA read + the first window's
    encode hides their compile time.
    AOT lower/compile populates the persistent XLA compilation cache, so
    the later real call deserializes instead of recompiling.  The symbol
    guess comes from the first window's data; a block with a novel byte
    just misses the warmup (correctness unaffected).
    """
    import logging
    import threading

    import jax
    import jax.numpy as jnp

    buckets = sorted({_bucket_size(s) for s in sizes
                      if s >= PREWARM_MIN_BYTES})
    if syms is not None and len(syms) > 7:
        syms = None

    def warm(npad: int, m_pad: int | None) -> None:
        try:
            from gecoz_tpu.ops.sa_device import (ELL_BITS_LADDER,
                                                 TOK_TABLE_SIZE)
            # ell_bits guess: genomic N runs cluster around 1% of the
            # block (telomere/centromere gaps) — warm the rung covering
            # that; a block landing on another rung just misses warmup
            gb = max(1, (npad // 100).bit_length())
            ebs = next((r for r in ELL_BITS_LADDER if gb <= r), None)
            # r1_keys=5 matches runs_r1_keys for DNA-sized token tables
            # (<= ~80 distinct run keys); a wider-alphabet block just
            # misses the warmup
            fn = _single_sa(npad, syms, m_pad, True, ebs, 5)
            fn.lower(
                jax.ShapeDtypeStruct((npad,), jnp.uint8),
                jax.ShapeDtypeStruct((TOK_TABLE_SIZE,), jnp.int32),
            ).compile()
        except Exception:                    # noqa: BLE001 — warmup only
            logging.getLogger("gecoz").debug(
                "prewarm of SA program %d/%s failed", npad, m_pad,
                exc_info=True)

    threads = []
    for npad in buckets:
        # genomic data lands on the 3/4 or 13/16 m_pad rung — warm both
        for m_pad in ((3 * npad) // 4, (13 * npad) // 16):
            t = threading.Thread(target=warm, args=(npad, m_pad),
                                 daemon=True)
            t.start()
            threads.append(t)
    return threads


def suffix_arrays_batched(blocks: list[np.ndarray], with_bwt: bool = False
                          ) -> list:
    """True suffix arrays for variable-length blocks via one padded,
    vmapped device sort per size bucket; with_bwt=True additionally
    returns each block's BWT as (sa, bwt) pairs.

    The run-aware kernel emits the BWT as a free value operand of its
    final sort; the padded rows restricted to sa < n ARE the true BWT
    (padded_s[v-1] = data[v-1] for retained v > 0, and the v == 0 row
    reads the trailing zero padding = the block's own \0 terminator —
    patched on host for blocks that do not end in \0), so consumers skip
    the reference's n-wide host gather s[sa[i]-1] (BWTDataSource,
    GecozFileWriter.java:300-303) entirely.

    Blocks whose estimated device working set exceeds ONE device's memory
    (accel.needs_sharded_sa) route to the in-block sharded kernel across
    the whole mesh instead — the capacity axis the reference bounds with
    its merge-cap policy (README.md:42-44) and we bound per chip."""
    import jax
    import jax.numpy as jnp

    from gecoz_tpu.utils import accel

    buckets: dict[int, list[int]] = {}
    sharded: list[int] = []
    for i, b in enumerate(blocks):
        if accel.needs_sharded_sa(len(b)) and len(jax.devices()) > 1:
            sharded.append(i)
        else:
            buckets.setdefault(_bucket_size(len(b)), []).append(i)

    out: list = [None] * len(blocks)
    for i in sharded:
        from gecoz_tpu.parallel.sharded_sa import suffix_array_sharded
        sa, bwt = suffix_array_sharded(blocks[i])
        sa = np.asarray(sa).astype(np.int64)
        out[i] = (sa, np.asarray(bwt)) if with_bwt else sa

    # pass 1 — stage every bucket: host-side static bounds/tables, then
    # the upload ISSUED (async).  Singleton buckets (the large blocks)
    # go 2-bit packed with run-encoded exceptions (utils/xfer.py);
    # transfers for bucket j+1 stream while bucket j's kernel runs.
    from gecoz_tpu.ops.sa_device import (ELL_BITS_LADDER, TOK_TABLE_SIZE,
                                         max_run_length, runs_m_pad,
                                         runs_token_table)
    from gecoz_tpu.utils import xfer

    staged = []
    for npad, idxs in buckets.items():
        batch = np.zeros((len(idxs), npad), dtype=np.uint8)
        for row, i in enumerate(idxs):
            batch[row, :len(blocks[i])] = blocks[i]
        # static union alphabet (must cover every byte incl. the 0 pad);
        # bincount, not unique — unique sorts the whole batch
        syms = tuple(int(x) for x in np.flatnonzero(
            np.bincount(batch.reshape(-1), minlength=256)))
        if len(syms) > 7:
            syms = None          # packed seed only pays below 3 sym bits
        m_pad = max(runs_m_pad(batch[row]) for row in range(len(idxs)))
        # shared static run-length bound (the zero pad run counts)
        mx_bits = max(1, int(max(max_run_length(batch[row])
                                 for row in range(len(idxs)))).bit_length())
        ell_bits = next((r for r in ELL_BITS_LADDER if mx_bits <= r), None)
        # shared run-key table = union over rows (a superset is safe:
        # dense values shift but stay order-isomorphic per row)
        tabs = [runs_token_table(batch[row], syms, ell_bits=ell_bits)
                for row in range(len(idxs))]
        tab = None
        if all(t is not None for t in tabs):
            union = sorted({int(v) for t in tabs
                            for v in t if v != (1 << 31) - 1})
            if len(union) <= TOK_TABLE_SIZE:
                tab = np.full(TOK_TABLE_SIZE, (1 << 31) - 1, np.int32)
                tab[:len(union)] = union
        if len(idxs) == 1:
            dev = xfer.put_packed(blocks[idxs[0]], pad_to=npad)
        else:
            dev = jnp.asarray(batch)
        from gecoz_tpu.ops.sa_device import runs_r1_keys
        staged.append((npad, idxs, syms, m_pad, ell_bits, tab,
                       runs_r1_keys(tab), dev))
        del batch

    # pass 2 — dispatch all kernels (async; the device serializes them,
    # later buckets' uploads stream underneath)
    launched = []
    for npad, idxs, syms, m_pad, ell_bits, tab, r1, dev in staged:
        if len(idxs) == 1:
            fn = _single_sa(npad, syms, m_pad, tab is not None, ell_bits,
                            r1)
        else:
            fn = _batched_sa(npad, syms, m_pad, tab is not None, ell_bits,
                             r1)
        args = (dev,) if tab is None else (dev, jnp.asarray(tab))
        sa_dev, bwt_dev = fn(*args)
        launched.append((idxs, sa_dev, bwt_dev))

    # pass 3 — fetch in launch order
    for idxs, sa_dev, bwt_dev in launched:
        if len(idxs) == 1:
            sa_pad = np.asarray(sa_dev)[None]
            bwt_pad = np.asarray(bwt_dev)[None] if with_bwt else None
        else:
            sa_pad = np.asarray(sa_dev)
            bwt_pad = np.asarray(bwt_dev) if with_bwt else None
        for row, i in enumerate(idxs):
            n = len(blocks[i])
            sa = sa_pad[row]
            keep = sa < n
            sa_true = sa[keep].astype(np.int64)
            if with_bwt:
                bwt_true = bwt_pad[row][keep]
                if n and blocks[i][n - 1] != 0:
                    # v == 0 row read the zero padding, not data[n-1]
                    bwt_true = bwt_true.copy()
                    bwt_true[int(np.argmin(sa_true))] = blocks[i][n - 1]
                out[i] = (sa_true, bwt_true)
            else:
                out[i] = sa_true
    return out


def encode_blocks(blocks: list[np.ndarray], headers: list[list[str]],
                  sampling_rate: int = 32, backend: str = "auto"
                  ) -> list[tuple[bytes, bytes]]:
    """Encode many blocks: batched device suffix sort, device wavelet
    construction, host serialization overlapped with the next block's
    device work (the mesh analog of the reference's intra-block 2-way
    overlap, GecozFileWriter.java:262-277).

    backend: 'auto' picks the tier up front (`accel.device_tier`);
    'device' forces the jax pipeline (also runs on CPU jax) and raises
    on a device error; 'host' keeps wavelet construction in numpy.
    Returns (gcz_block, gcx_block) per input block, in input order.
    """
    from concurrent.futures import ThreadPoolExecutor

    from gecoz_tpu.formats.gcz import RefBlockHeader, index_size, \
        ref_header_length, write_ssa_header
    from gecoz_tpu.index.hswt import HSWT
    from gecoz_tpu.index.shape import HSWTShape
    from gecoz_tpu.index.ssa import SampledSAIndex

    from gecoz_tpu.utils import metrics

    for b in blocks:
        if len(b) >= 1 << 31:
            raise ValueError("blocks are capped at 2^31 bytes by the "
                             "int32-SA contract (SAIS.java:103)")

    if backend == "auto":
        from gecoz_tpu.utils import accel
        big = max((len(b) for b in blocks), default=0)
        backend = "device" if accel.device_tier(big) else "host"

    sf = sampling_rate.bit_length() - 1

    def serialize(n, hdrs, ssa, shape, hswt):
        with metrics.phase("mesh.serialize", n):
            block_size = ref_header_length(hdrs) + shape.size
            gcz = (RefBlockHeader(hdrs, block_size, n).write()
                   + hswt.serialize())
            gcx = write_ssa_header(hdrs, index_size(n, sf)) + ssa.serialize()
            return gcz, gcx

    if backend == "device":
        # minimal-transfer device pipeline: the SA, the sampled-SA parts
        # and the wavelet bit planes are all derived ON DEVICE; the host
        # fetches only serialization artifacts (~0.55 bytes/char: mark
        # bits n/8 + sampled values n/8 + node bits ~0.3n)
        from gecoz_tpu.index.iwt import IndexWaveletTree
        from gecoz_tpu.index.rankbv import RankBitVector
        from gecoz_tpu.ops.wavelet import build_hswt_device

        with metrics.phase("mesh.sa", sum(len(b) for b in blocks)):
            states = index_states_batched(blocks, sampling_rate)
        futures = []
        with ThreadPoolExecutor(max_workers=2) as pool:
            for data, hdrs, (mark_bytes, perm, bwt_dev) in zip(
                    blocks, headers, states):
                n = len(data)
                shape = HSWTShape.from_counts(
                    np.bincount(data, minlength=256))
                with metrics.phase("mesh.wavelet", n):
                    hswt = HSWT.from_packed(
                        shape, build_hswt_device(bwt_dev, shape))
                ssa = SampledSAIndex(
                    RankBitVector(mark_bytes, n),
                    IndexWaveletTree(perm.astype(np.int64)), sf)
                futures.append(pool.submit(serialize, n, hdrs, ssa,
                                           shape, hswt))
            return [f.result() for f in futures]

    with metrics.phase("mesh.sa", sum(len(b) for b in blocks)):
        sabs = suffix_arrays_batched(blocks, with_bwt=True)

    futures = []
    # serialize workers: block i's sampled-SA build + interleave (the
    # native interleaver releases the GIL) overlap block i+1's wavelet
    # construction — the reference's intra-block 2-way overlap
    # (GecozFileWriter.java:262-277) at mesh scale
    def host_block(data, hdrs, sa, shape, hswt):
        ssa = SampledSAIndex.build(sa, sampling_rate)
        return serialize(len(data), hdrs, ssa, shape, hswt)

    with ThreadPoolExecutor(max_workers=2) as pool:
        for data, hdrs, (sa, bwt) in zip(blocks, headers, sabs):
            shape = HSWTShape.from_counts(np.bincount(data, minlength=256))
            # BWT came back as a free operand of the device SA's final
            # sort (suffix_arrays_batched with_bwt) — the reference's
            # on-the-fly host gather (BWTDataSource) is gone
            with metrics.phase("mesh.wavelet_host", len(data)):
                hswt = HSWT.build(bwt, shape)
            futures.append(pool.submit(host_block, data, hdrs, sa, shape,
                                       hswt))
        out = [f.result() for f in futures]
    return out


@dataclass
class DistributedContext:
    """Multi-host coordination (jax.distributed); single-host fallback."""

    process_index: int = 0
    process_count: int = 1

    @classmethod
    def initialize(cls) -> "DistributedContext":
        import os

        import jax
        if os.environ.get("JAX_COORDINATOR_ADDRESS"):
            jax.distributed.initialize()
        try:
            return cls(jax.process_index(), jax.process_count())
        except Exception:
            return cls()

    def my_blocks(self, sizes: list[int]) -> list[int]:
        assign = largest_first_schedule(sizes, self.process_count)
        return [i for i, a in enumerate(assign) if a == self.process_index]


def index_fasta_parallel(ipath, opath, xpath=None, sampling_rate: int = 32):
    """FASTA -> gcz with batched device suffix sorts across blocks.

    Multi-host: each process encodes its schedule shard, the encoded
    bytes are allgathered over the distributed backend, and process 0
    writes in plan order.
    """
    from pathlib import Path

    from gecoz_tpu.formats.fasta import iter_fasta, read_sequence
    from gecoz_tpu.formats.gcz import GecozWriter, default_gcx_path
    from gecoz_tpu.tools.blocks import plan_blocks

    ipath = Path(ipath)
    sequences = list(iter_fasta(ipath, lazy=True))
    plans = plan_blocks(sequences)

    datas = []
    for plan in plans:
        parts = []
        for seq in plan.sequences:
            parts.append(read_sequence(ipath, seq))
            parts.append(np.zeros(1, dtype=np.uint8))
        datas.append(np.concatenate(parts))

    ctx = DistributedContext.initialize()
    mine = ctx.my_blocks([len(d) for d in datas])
    encoded = {i: blk for i, blk in zip(
        mine, encode_blocks([datas[i] for i in mine],
                            [plans[i].headers for i in mine],
                            sampling_rate))}
    encoded = _allgather_encoded(encoded, ctx)

    if ctx.process_index == 0:
        with GecozWriter(opath, xpath, sampling_rate) as w:
            for i in range(len(datas)):
                gcz, gcx = encoded[i]
                w.write_encoded(gcz, gcx)


def _allgather_encoded(encoded: dict, ctx: "DistributedContext") -> dict:
    """Gather per-process encoded blocks over DCN (the reference-order
    gather step of GecozFileWriter, lifted to multi-host): each process
    contributes its shard; every process ends with the full map."""
    if ctx.process_count <= 1:
        return encoded
    import pickle

    import numpy as np
    from jax.experimental import multihost_utils

    payload = np.frombuffer(pickle.dumps(encoded), np.uint8)
    sizes = np.asarray(multihost_utils.process_allgather(
        np.array([len(payload)], np.int64))).reshape(-1)
    m = int(sizes.max())
    padded = np.zeros(m, np.uint8)
    padded[:len(payload)] = payload
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    out: dict = {}
    for rank in range(ctx.process_count):
        out.update(pickle.loads(gathered[rank, :int(sizes[rank])].tobytes()))
    return out
