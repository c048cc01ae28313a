"""Smoke test of the main path on one GPU, through the CLI's entry point.

Runs in ONE process (the CLI is called in-process via
`gecoz_tpu.cli.main`), so exactly one process holds the card; the only
child is the host-engine GFF3 reference, which never imports JAX (and
runs with the CPU forced besides).  Every phase raises on failure;
nothing is caught and passed over.

  1 device    the default JAX device must be a GPU; card, power limit
  2 genome    hg38-profile FASTA from a seed (chr1 248 MiB, chr9, chr17,
              chr21, chrM) and a read set for phase 6
  3 index     `-i genome.fa -o genome.gcz --backend device -v INFO`;
              mesh.sa and mesh.wavelet must have run
  4 decode    `-i genome.gcz -o back.fa --backend device`
              (decode.kernel_fetch must have run), per-header md5 against
              the source, then `--check --deep`
  5 queries   count (12/20/40-mers), locate in chr1 and a range extract
              across an N boundary, against naive scans of the source
  6 gff3      `-s reads.fa --backend device` (the batched device engine)
              byte-identical to the host engine's GFF3
  7 identity  a 64 MiB single-sequence .gcz/.gcx from `--backend device`
              byte-identical to `--backend native` (C++ SA-IS host tier)
  8 measure   XLA scans against a same-size copy; apply_perm as a sort
              against as a scatter; peak device memory after the index;
              memory_analysis() of the fused index_block program at
              248 MiB; warm encode times of both tiers at 64 KiB, 512 KiB,
              4 MiB and 16 MiB (the `auto` break-even)

The last stdout line is {"ok": true, "device": {...}}; a JSON file with
every number goes to --out.  Exits non-zero without a GPU.

Usage: python chip_smoke.py [--chr1-kib N] [--ident-kib N] [--reads N]
           [--measure-log2 26,28] [--fused-kib N] [--work DIR] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
BASES = np.frombuffer(b"ACGT", np.uint8)
N_BYTE = ord("N")


# -- helpers -----------------------------------------------------------------

class CompileClock:
    """Seconds XLA spent compiling (summed over threads), from JAX's
    /jax/core/compile/backend_compile_duration events."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self.count = 0

    def install(self) -> "CompileClock":
        import jax

        def listen(event: str, duration: float, **_) -> None:
            if event == "/jax/core/compile/backend_compile_duration":
                self.seconds += duration
                self.count += 1
        jax.monitoring.register_event_duration_secs_listener(listen)
        return self


def cli(*args) -> str:
    """Run the CLI's entry point in this process; returns its stdout."""
    from gecoz_tpu import cli as gecoz_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = gecoz_cli.main([str(a) for a in args])
    if rc != 0:
        raise RuntimeError(f"CLI {' '.join(map(str, args))} exited {rc}")
    return buf.getvalue()


def timed_cli(name: str, clock: CompileClock | None, *args
              ) -> tuple[str, dict]:
    """`cli` with the phase registry reset first; prints wall time,
    compile time and each metrics phase's seconds and MB/s."""
    from gecoz_tpu.utils import metrics
    metrics.reset()
    c0 = clock.seconds if clock else 0.0
    t0 = time.perf_counter()
    out = cli(*args)
    wall = time.perf_counter() - t0
    comp = (clock.seconds - c0) if clock else 0.0
    print(f"[{name}] wall {wall:.3f} s, of which XLA compile "
          f"{comp:.3f} s (summed over threads)", flush=True)
    stats = metrics.stats()
    for key, st in sorted(stats.items()):
        rate = f", {st.mbps:.2f} MB/s" if st.bytes else ""
        print(f"  {key}: {st.seconds:.3f} s over {st.calls} calls{rate}")
    return out, {"wall_s": wall, "compile_s": comp,
                 "phases": {k: {"s": v.seconds, "calls": v.calls,
                                "MBps": v.mbps} for k, v in stats.items()}}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def naive_positions(hay: bytes, pat: bytes) -> list[int]:
    """Every overlapping occurrence of `pat` in `hay`, ascending."""
    out, at = [], hay.find(pat)
    while at >= 0:
        out.append(at)
        at = hay.find(pat, at + 1)
    return out


def nfree_window(rng, src: np.ndarray, length: int) -> int:
    """Start of a random N-free window of `length` bytes in `src`."""
    while True:
        s = int(rng.integers(0, len(src) - length))
        if not (src[s:s + length] == N_BYTE).any():
            return s


# -- phases ------------------------------------------------------------------

def phase_device():
    """The default JAX device, which must be a GPU; prints the card."""
    import jax

    from gecoz_tpu import compile_cache_dir
    from gecoz_tpu.utils import accel
    dev = accel.require_gpu()
    card = accel.gpu_name_and_power_limit()
    print(f"card: {card}")
    print(f"device_kind: {dev.device_kind}, devices: {len(jax.devices())}, "
          f"jax {jax.__version__}, compile cache: {compile_cache_dir()}",
          flush=True)
    return dev, card


def make_reads(rng, chroms: dict[str, np.ndarray], count: int
               ) -> list[bytes]:
    """`count` reads of 100-150 bp: 90% sampled from N-free stretches of
    the genome with 1% substitutions, 10% uniformly random."""
    names = list(chroms)
    weights = np.array([len(chroms[k]) for k in names], np.float64)
    weights /= weights.sum()
    reads = []
    for i in range(count):
        length = int(rng.integers(100, 151))
        if i % 10 == 9:
            reads.append(BASES[rng.integers(0, 4, length)].tobytes())
            continue
        src = chroms[names[int(rng.choice(len(names), p=weights))]]
        s = nfree_window(rng, src, length)
        r = src[s:s + length].copy()
        sub = np.flatnonzero(rng.random(length) < 0.01)
        if len(sub):
            code = np.searchsorted(BASES, r[sub])
            r[sub] = BASES[(code + rng.integers(1, 4, len(sub))) % 4]
        reads.append(r.tobytes())
    return reads


def phase_genome(work: Path, chr1_bytes: int, n_reads: int,
                 seed: int = 2024) -> dict:
    """Write the hg38-profile FASTA and read set; return what the later
    phases check against (md5s, count/locate/extract expectations)."""
    from gecoz_tpu.tools.validate_scale import (hg38_sizes, synth_seq,
                                                write_fasta)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    chroms = {k: synth_seq(rng, n)
              for k, n in hg38_sizes(chr1_bytes).items()}
    fa = work / "genome.fa"
    write_fasta(fa, chroms)
    md5 = {k: hashlib.md5(v.tobytes()).hexdigest()
           for k, v in chroms.items()}
    raw = {k: v.tobytes() for k, v in chroms.items()}
    chr1 = chroms["chr1"]

    counts = []
    for plen in (12, 20, 40):
        s = nfree_window(rng, chr1, plen)
        pat = raw["chr1"][s:s + plen]
        counts.append((pat, sum(len(naive_positions(v, pat))
                                for v in raw.values())))
    s = nfree_window(rng, chr1, 20)
    loc_pat = raw["chr1"][s:s + 20]
    loc_want = naive_positions(raw["chr1"], loc_pat)
    # 60 bytes across the start of chr1's longest N run (a gap region)
    edge = np.diff(np.concatenate(([0], (chr1 == N_BYTE).view(np.int8),
                                   [0])))
    starts, ends = np.flatnonzero(edge == 1), np.flatnonzero(edge == -1)
    rlo = max(0, int(starts[np.argmax(ends - starts)]) - 30)
    extract = ("chr1", rlo, rlo + 60, raw["chr1"][rlo:rlo + 60])

    reads = make_reads(rng, chroms, n_reads)
    rfa = work / "reads.fa"
    with open(rfa, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b">read%d\n%s\n" % (i, r))
    total = sum(len(v) for v in chroms.values())
    print(f"[genome] {total} bytes in {len(chroms)} sequences "
          f"({', '.join(f'{k} {len(v)}' for k, v in chroms.items())}), "
          f"{len(reads)} reads, {time.perf_counter() - t0:.3f} s",
          flush=True)
    return {"fa": fa, "reads": rfa, "md5": md5, "counts": counts,
            "locate": (loc_pat, loc_want), "extract": extract,
            "total": total, "nseq": len(chroms)}


def phase_index(work: Path, genome: dict, clock=None) -> dict:
    """Index the genome through the CLI on the device tier."""
    gcz = work / "genome.gcz"
    _, rec = timed_cli("index", clock, "-i", genome["fa"], "-o", gcz,
                       "--backend", "device", "-v", "INFO")
    for key in ("mesh.sa", "mesh.wavelet"):
        require(rec["phases"].get(key, {}).get("calls", 0) > 0,
                f"{key} did not run: the device tier was bypassed")
    from gecoz_tpu.formats.gcz import GecozReader
    rec["MBps"] = genome["total"] / 1e6 / rec["wall_s"]
    rec["gcz"] = gcz
    rec["blocks"] = len(GecozReader(gcz).headers)
    return rec


def start_host_gff(gcz: Path, reads: Path, out: Path) -> subprocess.Popen:
    """The host engine's GFF3 for the read set, in a child process that
    overlaps phases 4-5 (its path never imports JAX; the CPU is forced
    besides)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    with open(out, "wb") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "gecoz_tpu.cli", "-i", str(gcz),
             "-s", str(reads), "--backend", "native"],
            stdout=f, cwd=REPO, env=env)


def phase_decode(work: Path, genome: dict, gcz: Path, blocks: int,
                 clock=None) -> dict:
    """Decode on the device tier, compare md5s, then --check --deep."""
    from gecoz_tpu.tools.validate_scale import md5s_of_fasta
    back = work / "back.fa"
    _, rec = timed_cli("decode", clock, "-i", gcz, "-o", back,
                       "--backend", "device")
    fetched = rec["phases"].get("decode.kernel_fetch", {}).get("calls", 0)
    require(fetched == blocks, f"decode.kernel_fetch ran {fetched} times "
            f"for {blocks} blocks: device decode bypassed")
    got = md5s_of_fasta(back)
    require(got == genome["md5"], f"md5 mismatch: {got} != {genome['md5']}")
    print(f"  md5 equal on all {len(got)} headers", flush=True)
    rec["MBps"] = genome["total"] / 1e6 / rec["wall_s"]
    back.unlink()
    out, chk = timed_cli("check --deep", clock, "-i", gcz, "--check",
                         "--deep")
    lines = out.strip().splitlines()
    require(lines and all(line.endswith(": ok") for line in lines),
            f"--check --deep: {out}")
    rec["check_deep_s"] = chk["wall_s"]
    return rec


def phase_queries(work: Path, genome: dict, gcz: Path) -> dict:
    """Count, locate and extract through the CLI against naive scans."""
    rec = {}
    for pat, want in genome["counts"]:
        t0 = time.perf_counter()
        out = cli("-i", gcz, "-c", pat.decode())
        got = sum(int(line.split(" found : ")[1].split()[0])
                  for line in out.splitlines() if " found : " in line)
        require(got == want, f"count {pat!r}: {got} != naive {want}")
        rec[f"count_{len(pat)}mer_s"] = time.perf_counter() - t0
        print(f"[count] {len(pat)}-mer: {got} hits = naive", flush=True)
    pat, want = genome["locate"]
    out = cli("-i", gcz, "-s", "chr1", pat.decode())
    got = [int(x) for x in out.splitlines() if not x.startswith(">")]
    require(got == want, f"locate {pat!r}: {got} != naive {want}")
    print(f"[locate] chr1 20-mer: {len(got)} positions = naive", flush=True)
    name, lo, hi, want_bytes = genome["extract"]
    seq = work / "range.seq"
    cli("-i", gcz, "-o", seq, name, lo, hi)
    require(seq.read_bytes() == want_bytes, "range extract mismatch")
    print(f"[extract] {name}[{lo}:{hi}] across an N boundary = source",
          flush=True)
    return rec


def phase_gff(genome: dict, gcz: Path, blocks: int,
              host: subprocess.Popen, host_out: Path, clock=None) -> dict:
    """Device-engine GFF3 must equal the host engine's, byte for byte."""
    out, rec = timed_cli("gff3 device", clock, "-i", gcz, "-s",
                         genome["reads"], "--backend", "device")
    batched = rec["phases"].get("search.batched", {}).get("calls", 0)
    require(batched == blocks, f"search.batched ran {batched} times for "
            f"{blocks} blocks: device engine bypassed")
    t0 = time.perf_counter()
    rc = host.wait()
    require(rc == 0, f"host GFF3 engine exited {rc}")
    print(f"  waited {time.perf_counter() - t0:.3f} s for the host engine",
          flush=True)
    want = host_out.read_text()
    rows = out.count("\n")
    require(rows > 0, "GFF3 has no rows")
    require(out == want, "device GFF3 != host GFF3")
    print(f"[gff3] {rows} rows, device engine byte-identical to host",
          flush=True)
    rec["rows"] = rows
    return rec


def phase_identity(work: Path, nbytes: int, clock=None,
                   seed: int = 64) -> dict:
    """.gcz/.gcx of one sequence: device tier == native host tier."""
    from gecoz_tpu.tools.validate_scale import synth_seq, write_fasta
    rng = np.random.default_rng(seed)
    fa = work / "one.fa"
    write_fasta(fa, {"seq1": synth_seq(rng, nbytes)})
    rec = {}
    for tier in ("device", "native"):
        _, r = timed_cli(f"identity {tier}", clock, "-i", fa, "-o",
                         work / f"one_{tier}.gcz", "--backend", tier)
        rec[f"{tier}_s"] = r["wall_s"]
    for ext in ("gcz", "gcx"):
        a = (work / f"one_device.{ext}").read_bytes()
        b = (work / f"one_native.{ext}").read_bytes()
        require(a == b, f".{ext} of the device tier != native tier")
    print(f"[identity] {nbytes} bytes: .gcz and .gcx byte-identical "
          "(device vs native)", flush=True)
    return rec


def best_time(fn, *args, repeat: int = 5) -> float:
    """Best wall time of `fn(*args)` (warm, ended by block_until_ready)."""
    import jax
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def measure_scans(log2_sizes: list[int]) -> dict:
    """XLA's scans and the segmented fills against a same-size copy."""
    import jax
    import jax.numpy as jnp

    from gecoz_tpu.ops.scan import fill_fwd_i32, fill_rev_i32
    fns = {
        "copy": jax.jit(lambda x: x + 1),
        "cumsum": jax.jit(lambda x: jnp.cumsum(x, dtype=jnp.int32)),
        "cummax": jax.jit(jax.lax.cummax),
        "cummin_rev": jax.jit(lambda x: jax.lax.cummin(x, reverse=True)),
        "fill_fwd": jax.jit(fill_fwd_i32),
        "fill_rev": jax.jit(fill_rev_i32),
    }
    rec = {}
    for lg in log2_sizes:
        n = 1 << lg
        key = jax.random.key(lg)
        x = jax.random.randint(key, (n,), 0, 1 << 30, jnp.int32)
        x = jnp.where(x % 4 == 0, x, -1)       # 1 in 4 marked for fills
        times = {k: best_time(f, x) for k, f in fns.items()}
        for k, t in times.items():
            rec[f"{k}_2^{lg}_ms"] = t * 1e3
            print(f"[scan] {k} 2^{lg} int32: {t * 1e3:.3f} ms, "
                  f"{8 * n / t / 1e9:.1f} GB/s read+write, "
                  f"{t / times['copy']:.2f}x copy", flush=True)
        del x
    return rec


def measure_apply_perm(log2_sizes: list[int]) -> dict:
    """apply_perm's two strategies: one sort carrying the values against
    plain scatters, with one and three value arrays."""
    import jax
    import jax.numpy as jnp
    rec = {}
    for lg in log2_sizes:
        n = 1 << lg
        dest = jax.random.permutation(jax.random.key(lg), n).astype(
            jnp.int32)
        vals = tuple(jnp.arange(n, dtype=jnp.int32) * (i + 1)
                     for i in range(3))
        for nv in (1, 3):
            sort = jax.jit(lambda d, *v: jax.lax.sort(
                (d,) + v, num_keys=1, is_stable=False)[1:])
            scat = jax.jit(lambda d, *v: tuple(
                jnp.zeros_like(a).at[d].set(a) for a in v))
            a = sort(dest, *vals[:nv])
            b = scat(dest, *vals[:nv])
            require(all(bool(jnp.array_equal(p, q)) for p, q in zip(a, b)),
                    "apply_perm strategies disagree")
            del a, b
            ts = best_time(sort, dest, *vals[:nv])
            tc = best_time(scat, dest, *vals[:nv])
            rec[f"sort_{nv}v_2^{lg}_ms"] = ts * 1e3
            rec[f"scatter_{nv}v_2^{lg}_ms"] = tc * 1e3
            print(f"[apply_perm] 2^{lg}, {nv} value(s): sort "
                  f"{ts * 1e3:.3f} ms, scatter {tc * 1e3:.3f} ms "
                  f"(scatter/sort {tc / ts:.2f})", flush=True)
        del dest, vals
    return rec


def measure_fused_index(nbytes: int) -> dict:
    """compiled.memory_analysis() of the fused index_block program (SA +
    query state in one program) at `nbytes`; read only."""
    import jax
    import jax.numpy as jnp

    from gecoz_tpu.ops.pipeline import index_block
    from gecoz_tpu.ops.sa_device import TOK_TABLE_SIZE
    t0 = time.perf_counter()
    compiled = index_block.lower(
        jax.ShapeDtypeStruct((nbytes,), jnp.uint8),
        m_pad=(13 * nbytes) // 16,
        tok_table=jax.ShapeDtypeStruct((TOK_TABLE_SIZE,), jnp.int32),
        ell_bits=25, r1_keys=5).compile()
    ma = compiled.memory_analysis()
    rec = {"compile_s": time.perf_counter() - t0}
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes"):
        rec[k] = int(getattr(ma, k, -1))
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    rec["bytes_limit"] = limit
    print(f"[fused index_block] {nbytes} bytes: compile "
          f"{rec['compile_s']:.3f} s, temp {rec['temp_size_in_bytes']}, "
          f"args {rec['argument_size_in_bytes']}, out "
          f"{rec['output_size_in_bytes']} bytes; device limit {limit}",
          flush=True)
    return rec


def measure_breakeven(sizes: list[int], seed: int = 5) -> dict:
    """Warm encode time of one block on each tier (the `auto` rule's
    break-even); both tiers' bytes must agree."""
    from gecoz_tpu.formats.gcz import encode_block
    from gecoz_tpu.parallel.mesh import encode_blocks
    from gecoz_tpu.tools.validate_scale import synth_seq
    rng = np.random.default_rng(seed)
    rec = {}
    for n in sizes:
        data = np.concatenate([synth_seq(rng, n - 1),
                               np.zeros(1, np.uint8)])
        dev = encode_blocks([data], [["b"]], 32, backend="device")[0]
        host = encode_block(data, ["b"], 32, backend="native")
        require(dev == host, f"encode tiers disagree at {n} bytes")
        td = best_time(lambda: encode_blocks([data], [["b"]], 32,
                                             backend="device"), repeat=3)
        th = best_time(lambda: encode_block(data, ["b"], 32,
                                            backend="native"), repeat=3)
        rec[f"device_{n}_ms"] = td * 1e3
        rec[f"native_{n}_ms"] = th * 1e3
        print(f"[break-even] {n} bytes: device {td * 1e3:.3f} ms, native "
              f"{th * 1e3:.3f} ms ({'device' if td < th else 'native'} "
              "faster)", flush=True)
    return rec


def result_line(dev, count: int) -> str:
    """The script's last stdout line."""
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}})


# -- main --------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chr1-kib", type=int, default=248 << 10)
    ap.add_argument("--ident-kib", type=int, default=64 << 10)
    ap.add_argument("--reads", type=int, default=4096)
    ap.add_argument("--measure-log2", default="26,28")
    ap.add_argument("--fused-kib", type=int, default=248 << 10)
    ap.add_argument("--work", type=Path, default=REPO / ".smoke_work")
    ap.add_argument("--out", type=Path, default=REPO / "smoke_out")
    a = ap.parse_args(argv)

    t_start = time.perf_counter()
    dev, card = phase_device()
    clock = CompileClock().install()
    shutil.rmtree(a.work, ignore_errors=True)
    a.work.mkdir(parents=True)
    a.out.mkdir(parents=True, exist_ok=True)
    record: dict = {"card": card, "device_kind": dev.device_kind}
    host = None
    try:
        genome = phase_genome(a.work, a.chr1_kib << 10, a.reads)
        record["index"] = phase_index(a.work, genome, clock)
        gcz = record["index"].pop("gcz")
        peak = dev.memory_stats()["peak_bytes_in_use"]
        record["peak_bytes_after_index"] = peak
        print(f"[memory] peak_bytes_in_use after the index: {peak} "
              f"({peak / ((a.chr1_kib << 10) + 1):.2f} bytes per chr1 "
              "byte)", flush=True)
        host_out = a.work / "gff_host.txt"
        host = start_host_gff(gcz, genome["reads"], host_out)
        blocks = record["index"]["blocks"]
        record["decode"] = phase_decode(a.work, genome, gcz, blocks, clock)
        record["queries"] = phase_queries(a.work, genome, gcz)
        record["gff3"] = phase_gff(genome, gcz, blocks, host, host_out,
                                   clock)
        host = None
        record["identity"] = phase_identity(a.work, a.ident_kib << 10,
                                            clock)
        sizes = [int(x) for x in a.measure_log2.split(",") if x]
        record["scans"] = measure_scans(sizes)
        record["apply_perm"] = measure_apply_perm(sizes)
        record["fused_index_block"] = measure_fused_index(a.fused_kib << 10)
        record["breakeven"] = measure_breakeven(
            [64 << 10, 512 << 10, 4 << 20, 16 << 20])
    finally:
        if host is not None:
            host.kill()
            host.wait()
        shutil.rmtree(a.work, ignore_errors=True)
    record["total_s"] = time.perf_counter() - t_start
    record["compile_s"] = clock.seconds
    (a.out / "chip_smoke.json").write_text(
        json.dumps(record, indent=1, default=str))
    print(f"[total] {record['total_s']:.3f} s, XLA compile "
          f"{clock.seconds:.3f} s over {clock.count} programs", flush=True)
    import jax
    print(result_line(dev, len(jax.devices())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
