"""High-level drivers: fasta->gcz, gcz->fasta, range extract, match, GFF.

These mirror the reference CLI tools' behavior (nova-gecoz tools/
GecoIndex.java, GecoRead.java, GecoMatch.java, SimpleGFFGenerator.java) on
top of the device and host pipelines.
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path

import numpy as np

from gecoz_tpu.formats.fasta import (FastaWriter, format_fasta_record,
                                     iter_fasta, read_sequence)
from gecoz_tpu.formats.gcz import (DEFAULT_SAMPLING_RATE, GecozReader,
                                   GecozWriter, check_format)
from gecoz_tpu.tools.blocks import plan_blocks

log = logging.getLogger("gecoz")


def index_fasta(ipath, opath, xpath=None, sampling=DEFAULT_SAMPLING_RATE,
                backend: str = "auto", threads: int = 1,
                resume: bool = False) -> None:
    """FASTA -> .gcz/.gcx (GecoIndex.index).

    With threads > 1, blocks encode concurrently in a bounded pool (the
    C++ SA-IS and numpy serializers release the GIL); output order stays
    the plan order, in-flight work is capped like the reference's 1-deep
    queue (GecozFileWriter.java:174-201).

    With resume=True, a partially-written output pair is continued: the
    self-describing block chain is scanned, complete leading blocks that
    match the plan are kept, and encoding restarts at the first missing
    block (crash recovery for long encodes; the reference formats make
    this possible but its writer never exploited it).
    """
    t0 = time.time()
    ipath = Path(ipath)
    sequences = list(iter_fasta(ipath, lazy=True))
    if not sequences:
        raise SystemExit(f"no data found in file: {ipath}")
    blocks = plan_blocks(sequences)
    # malloc tuning + arena pre-fault: the encode path churns multi-GB
    # host temps (block buffers, device fetches, serialization scratch);
    # on fresh-page-fault-bound VMs the mitigation is worth minutes per
    # chr1-class block (utils/hostmem.py — the decode path already did
    # this; in-process callers like validate_scale skip the CLI re-exec)
    from gecoz_tpu.utils.hostmem import warm_for_block
    warm_for_block(max((sum(s.length + 1 for s in b.sequences)
                        for b in blocks), default=0))
    log.info("indexing %d sequences in %d blocks", len(sequences), len(blocks))
    skip = _resume_prefix(opath, xpath, blocks, sampling) if resume else 0
    if skip:
        log.info("resuming after %d complete blocks", skip)
        blocks = blocks[skip:]
    from gecoz_tpu.utils import metrics

    def read_block(block):
        parts = []
        with metrics.phase("index.read_fasta"):
            for seq in block.sequences:
                parts.append(read_sequence(ipath, seq))
                parts.append(np.zeros(1, dtype=np.uint8))
            return np.concatenate(parts)

    if backend in ("auto", "device"):
        # device encode path: batched device suffix sorts across blocks
        # (parallel/mesh.py) whenever the device tier is in play — the
        # same policy encode_block applies per block, decided once here
        from gecoz_tpu.utils import accel
        big = max((sum(s.length + 1 for s in b.sequences) for b in blocks),
                  default=0)
        if backend == "device" or accel.device_tier(big):
            with GecozWriter(opath, xpath, sampling, backend=backend,
                             append=skip > 0) as w:
                _index_blocks_mesh(blocks, read_block, w, sampling)
            log.info("finished in %d ms", (time.time() - t0) * 1000)
            return

    with GecozWriter(opath, xpath, sampling, backend=backend,
                     append=skip > 0) as w:
        if threads <= 1:
            for block in blocks:
                data = read_block(block)
                with metrics.phase("index.encode_block", len(data)):
                    w.write(block.headers, data)
        else:
            import concurrent.futures as cf

            from gecoz_tpu.formats.gcz import encode_block
            pool = cf.ThreadPoolExecutor(max_workers=threads)
            pending = []
            try:
                for block in blocks:
                    data = read_block(block)
                    pending.append(pool.submit(
                        encode_block, data, block.headers, sampling, backend))
                    while len(pending) > threads + 1:
                        gcz, gcx = pending.pop(0).result()
                        w.write_encoded(gcz, gcx)
                for fut in pending:
                    gcz, gcx = fut.result()
                    w.write_encoded(gcz, gcx)
            finally:
                pool.shutdown()
    log.info("finished in %d ms", (time.time() - t0) * 1000)


MESH_WINDOW_BYTES = 256 << 20   # text bytes batched per mesh-encode window
MESH_WINDOW_BLOCKS = 16


def _index_blocks_mesh(blocks, read_block, w, sampling) -> None:
    """Encode plan blocks through the batched device path
    (parallel/mesh.py::encode_blocks) in bounded windows.

    Windows keep peak host memory at O(window) rather than O(file) while
    still letting equal-bucket blocks share one vmapped device sort.
    """
    from gecoz_tpu.parallel.mesh import encode_blocks, prewarm_buckets
    from gecoz_tpu.utils import metrics

    window: list[np.ndarray] = []
    hdrs: list[list[str]] = []
    warmed = False

    def flush() -> None:
        if not window:
            return
        nbytes = sum(len(d) for d in window)
        with metrics.phase("index.encode_mesh", nbytes):
            encoded = encode_blocks(window, hdrs, sampling, backend="device")
        for gcz, gcx in encoded:
            w.write_encoded(gcz, gcx)
        window.clear()
        hdrs.clear()

    acc = 0
    for i, block in enumerate(blocks):
        data = read_block(block)
        if not warmed and len(blocks) > 1:
            # pre-compile later windows' large-block SA programs while the
            # page-fault-bound FASTA reads and window 1's encode run
            sizes = [sum(s.length + 1 for s in b.sequences)
                     for b in blocks[i + 1:]]
            syms = tuple(int(x) for x in
                         np.flatnonzero(np.bincount(data, minlength=256)))
            prewarm_buckets(sizes, syms)
            warmed = True
        window.append(data)
        hdrs.append(block.headers)
        acc += len(data)
        if acc >= MESH_WINDOW_BYTES or len(window) >= MESH_WINDOW_BLOCKS:
            flush()
            acc = 0
    flush()


def _resume_prefix(opath, xpath, blocks, sampling) -> int:
    """Count complete leading blocks of an existing output pair matching
    the plan; truncate both files to that prefix.  Returns the count."""
    import os

    from gecoz_tpu.formats.gcz import (RefBlockHeader, SSA_HEADER_LEN,
                                       default_gcx_path, index_size,
                                       parse_ssa_header, header_hash)
    opath = Path(opath)
    gcx_path = Path(xpath) if xpath else default_gcx_path(opath)
    if not opath.is_file() or not gcx_path.is_file():
        return 0
    ref = opath.read_bytes()
    ssa = gcx_path.read_bytes()
    sf = sampling.bit_length() - 1
    pos = xpos = 0
    good = 0
    for block in blocks:
        try:
            h = RefBlockHeader.parse(ref, pos)
        except (ValueError, IndexError):
            break
        expected_len = sum(s.length + 1 for s in block.sequences)
        if h.headers != block.headers or h.len != expected_len \
                or pos + h.size > len(ref):
            break
        xsize = SSA_HEADER_LEN + index_size(h.len, sf)
        if xpos + xsize > len(ssa):
            break
        try:
            blen, hsh = parse_ssa_header(ssa, xpos)
        except ValueError:
            break
        if hsh != header_hash(h.headers) or blen != index_size(h.len, sf):
            break
        pos += h.size
        xpos += xsize
        good += 1
    if good:
        os.truncate(opath, pos)
        os.truncate(gcx_path, xpos)
    return good


DECODE_CHUNK = 4 << 20      # bytes of text per decode task (GecoRead's 4 MiB)


def decompress(ipath, opath, backend: str = "auto", threads: int = 1) -> None:
    """.gcz -> FASTA (GecoRead.fasta:83-175, re-designed).

    The output file is pre-sized from the exact per-record layout (the
    reference reserves mmap regions per sequence, FastaFileWriter.java:142);
    each block then decodes in 4 MiB sampling-aligned chunks written
    straight into the reflowed region — peak memory is O(block tables +
    threads * chunk), never O(text), and `-t` workers decode chunks
    concurrently over the shared read-only LF table.

    backend 'auto' decodes a block on the device when `accel.device_tier`
    says so; 'device' always does.  A device error raises.
    """
    t0 = time.time()
    from gecoz_tpu.utils import metrics
    from gecoz_tpu.utils.hostmem import warm_for_block
    reader = GecozReader(ipath)
    if reader.headers:
        warm_for_block(max(h.len for h in reader.headers))
    with open(opath, "wb"):
        pass                                  # create/truncate
    base = 0
    for bheader in reader.headers:
        with metrics.phase("decode.read_block"):
            fm = reader.read(bheader)
        with metrics.phase("decode.extract", bheader.len):
            base = _decompress_block(fm, bheader.headers, opath, base,
                                     backend, threads)
    log.info("finished in %d ms", (time.time() - t0) * 1000)


def _decompress_block(fm, headers: list[str], opath, base: int,
                      backend: str, threads: int) -> int:
    """Decode one block into its pre-sized region of `opath`; returns the
    file offset following the block's records."""
    from gecoz_tpu.formats.fasta import record_size, write_fasta_segment

    # record layout: (file_off, header_len, header_bytes, lo, hi) per seq
    recs = []
    off = base
    for i, hdr in enumerate(headers):
        b, t = fm.seq_bounds(i)
        hbytes = b">" + hdr.encode() + b"\n"
        recs.append((off, len(hbytes), hbytes, b, t))
        off += record_size(hdr, t - b)
    end = off
    with open(opath, "r+b") as f:
        f.truncate(end)
    mm = np.memmap(opath, dtype=np.uint8, mode="r+")
    for roff, hlen, hbytes, _, _ in recs:
        mm[roff:roff + hlen] = np.frombuffer(hbytes, np.uint8)
    starts = [r[3] for r in recs]             # sequence lo bounds, ascending

    def scatter(lo: int, data: np.ndarray) -> None:
        """Route global text chunk [lo, lo+len) to its record segments."""
        import bisect
        hi = lo + len(data)
        i = max(0, bisect.bisect_right(starts, lo) - 1)
        while i < len(recs) and recs[i][3] < hi:
            roff, hlen, _, b, t = recs[i]
            s0, s1 = max(lo, b), min(hi, t)
            if s1 > s0:
                write_fasta_segment(mm, roff, hlen, t - b, s0 - b, s1 - b,
                                    data[s0 - lo:s1 - lo])
            i += 1

    text = _device_decode(fm, backend)
    if text is not None:
        # device tier returned the full text: scatter it (parallel reflow)
        chunks = [(lo, text[lo:lo + DECODE_CHUNK])
                  for lo in range(0, fm.length, DECODE_CHUNK)]
        _run_tasks([(scatter, c) for c in chunks], threads)
        mm.flush()
        return end

    # host tier: chunked walk decode over the shared read-only LF table
    fm._require_index()
    rate = 1 << fm.index.sampling_factor
    _ = fm.bwt, fm.lf, fm.walk_seeds()        # materialize shared state once
    nwalks = fm.n_walks
    wpc = max(1, DECODE_CHUNK // rate)        # walks per chunk

    def decode_task(w0: int, w1: int) -> None:
        scatter(w0 * rate, fm.decode_walks(w0, w1))

    tasks = [(decode_task, (w0, min(w0 + wpc, nwalks)))
             for w0 in range(0, nwalks, wpc)]
    _run_tasks(tasks, threads)
    mm.flush()
    return end


def _run_tasks(tasks, threads: int) -> None:
    if threads <= 1 or len(tasks) <= 1:
        for fn, args in tasks:
            fn(*args)
        return
    import concurrent.futures as cf
    with cf.ThreadPoolExecutor(max_workers=threads) as pool:
        futs = [pool.submit(fn, *args) for fn, args in tasks]
        for f in futs:
            f.result()


def _device_decode(fm, backend: str) -> np.ndarray | None:
    """Full-text device decode when the backend choice calls for it;
    None -> use the host tier."""
    from gecoz_tpu.utils import accel
    if not (backend == "device"
            or (backend == "auto" and accel.device_tier(fm.length))):
        return None
    import jax

    from gecoz_tpu.ops.fmq import (decode_text_jit,
                                   device_block_from_fm_packed,
                                   fetch_text_packed, with_lf_table)
    from gecoz_tpu.utils import metrics

    # sub-phased version of fmq.decode_text_device: host wavelet->BWT
    # decode vs lift/transfer/LF-table build vs kernel+fetch
    with metrics.phase("decode.host_bwt", fm.length):
        _ = fm.bwt
    with metrics.phase("decode.lift", fm.length):
        # packed lift: 2-bit+runs BWT upload + the two small .gcx
        # arrays; planes/marks built on device
        block, symbols = device_block_from_fm_packed(fm)
        block = jax.block_until_ready(jax.jit(with_lf_table)(block))
    with metrics.phase("decode.kernel_fetch", fm.length):
        # fetch at 4 bits/symbol (2x fewer bytes coming back)
        return fetch_text_packed(decode_text_jit(block), symbols,
                                 fm.length)


def extract_range(ipath, header: str, start: int, end: int | None,
                  opath) -> None:
    """.gcz -> .seq range extraction (GecoRead.sequence)."""
    reader = GecozReader(ipath)
    bheader = reader.find_block(header)
    if bheader is None:
        raise SystemExit(f"no sequence found: {header}")
    fm = reader.read(bheader)
    nstr = bheader.headers.index(header)
    data = fm.extract(nstr, start, end)
    with open(opath, "wb") as f:
        f.write(data)


def match(ipath, header: str | None, pattern: str, show_positions: bool,
          out=None) -> int:
    """Count/search a pattern (GecoMatch.match)."""
    out = sys.stdout if out is None else out
    reader = GecozReader(ipath)
    total = 0
    blocks = reader.headers
    if header is not None:
        b = reader.find_block(header)
        if b is None:
            raise SystemExit(f"no sequence found: {header}")
        blocks = [b]
    for bheader in blocks:
        fm = reader.read(bheader)
        if not fm.has_index:
            # count-only mode: no .gcx, so hits cannot be split/located
            c = fm.count_total(pattern.encode())
            if c:
                print(f">{'|'.join(bheader.headers)} found : {c} "
                      f"(no .gcx: block total, positions unavailable)",
                      file=out)
                total += c
            continue
        res = fm.find(pattern.encode())
        for i, hits in sorted(res.items()):
            if header is not None and bheader.headers[i] != header:
                continue
            print(f">{bheader.headers[i]} found : {len(hits)}", file=out)
            total += len(hits)
            if show_positions:
                for p in hits:
                    print(int(p), file=out)
    log.info("total found: %d", total)
    return total


_COMPLEMENT = bytes.maketrans(b"ATCG", b"TAGC")


def gff_search(ref_path, fasta_path, out=None, backend: str = "auto") -> None:
    """Query-FASTA search emitting GFF3 rows, forward + reverse complement
    (SimpleGFFGenerator.search:45-163).

    With backend="device" all queries x strands run as one batched device
    search per block instead of the reference's per-query loop.
    """
    out = sys.stdout if out is None else out
    reader = GecozReader(ref_path)

    queries = []
    for q in iter_fasta(fasta_path):
        seq = bytes(q.data).replace(b"U", b"T")
        rev = seq[::-1].translate(_COMPLEMENT)
        queries.append((q.header, seq, rev))

    # Stream block-by-block (the reference's per-block loop,
    # GecoMatch.java:109-135): load one block's query state, run every
    # query x strand against it, release it — peak memory is bounded by
    # ONE block plus the accumulated hit lists (tiny), not the whole index.
    results = []              # per block: (seq headers, {strand_idx: hits})
    if backend == "device":
        from gecoz_tpu.tools.batch_search import find_batched
        from gecoz_tpu.utils import metrics
        patterns = [s for _, f, r in queries for s in (f, r)]
        for bheader in reader.headers:
            fm = reader.read(bheader)
            with metrics.phase("search.batched", fm.length):
                results.append((bheader.headers, find_batched(fm, patterns)))
            del fm
    else:
        for bheader in reader.headers:
            fm = reader.read(bheader)
            per = {}
            for qi, (_, fwd, rev) in enumerate(queries):
                per[2 * qi] = fm.find(fwd)
                per[2 * qi + 1] = fm.find(rev)
            results.append((bheader.headers, per))
            del fm

    # emit in the reference's row order: query -> strand -> block -> seq
    for qi, (header, fwd, _) in enumerate(queries):
        for si, reverse in ((2 * qi, False), (2 * qi + 1, True)):
            for seq_headers, per in results:
                for i, hits in sorted(per[si].items()):
                    for p in hits:
                        _gff_row(out, seq_headers[i], int(p), len(fwd),
                                 reverse, header)


def _gff_row(out, target, pos, plen, reverse, qheader):
    strand = "-" if reverse else "+"
    parts = qheader.split("|")
    attrs = f"ID={parts[0]}" if parts else ""
    for extra in parts[1:]:
        attrs += f";Note={extra}"
    print(f"{target}\tgecotools\tdna\t{pos + 1}\t{pos + plen}\t1.000\t"
          f"{strand}\t.\t{attrs}", file=out)


def check(ipath, deep: bool = False, out=None) -> bool:
    """Validate a .gcz/.gcx pair: header chain, index sizes and hashes,
    and (deep) a full decode of every block's wavelet tree.

    The formats are self-describing block chains (GecozFileReader.java:
    81-88 scans them the same way), so verification is streaming.
    """
    out = sys.stdout if out is None else out
    try:
        reader = GecozReader(ipath)
    except (ValueError, IndexError) as ex:
        print(f"CORRUPT: {ex}", file=out)
        return False
    ok = True
    for bheader in reader.headers:
        status = "ok"
        try:
            fm = reader.read(bheader)       # validates gcx hash + length
            if not fm.has_index:
                status = "ok (no .gcx)"
            if deep:
                text = fm.decode_text() if fm.has_index else None
                if text is not None:
                    counts = np.bincount(fm.bwt, minlength=256)
                    if not np.array_equal(np.bincount(text, minlength=256),
                                          counts):
                        raise ValueError("decode histogram mismatch")
        except Exception as ex:
            status = f"CORRUPT: {ex}"
            ok = False
        print(f"block [{', '.join(bheader.headers)}] "
              f"len={bheader.len}: {status}", file=out)
    return ok
