"""Packed host<->device transfers for genomic byte blocks.

The device tier moves whole blocks to the accelerator (and text back, for
decode).  DNA is <= 3 bits/symbol, so raw bytes never cross the host
link:

* host -> device (`put_packed`): 2-bit-pack the four most frequent
  symbols (A/C/G/T in any genomic block) into one uint8 per 4 positions;
  everything else (N runs, separators, trailing \\0 padding, IUPAC
  codes) goes into a RUN list of (start, end, value) for maximal
  constant-byte runs >= 32 plus a POINT list of (position, byte) for
  scattered singles.  The device unpacks with a 4-way select, a
  searchsorted run paint, and one bounded scatter.  Wire bytes:
  n/4 + 13R + 5E ~= n/3.5 on hg38-like data (megabase N runs are a
  handful of run entries, isolated Ns are the point list).
* device -> host (`pack_nibbles_device` / `unpack_nibbles_host`, the
  decode fetch): 4-bit plane codes, two symbols per byte — a flat 2x
  with no device-side run detection needed (every FM block has
  sigma <= 16 by the plane-engine contract).

There is no reference analog: the reference is single-process shared
memory (SURVEY §2.8), so "transport" does not exist there.
"""

from __future__ import annotations

import numpy as np

# run/point lists are padded to the next bucket so jit programs don't
# fragment per exception count
_BUCKET_MIN = 1 << 8
_MIN_RUN = 32          # exception runs shorter than this go to the points


def _pad_len(e: int) -> int:
    if e == 0:
        return 0                     # exception-free (pure ACGT) blocks
    p = _BUCKET_MIN
    while p < e:
        p <<= 1
    return p


def should_pack(counts: np.ndarray) -> bool:
    """Upload packing pays when the top-4 symbols cover most of the
    block; long runs of anything are cheap (run list), so the real
    criterion is scattered exceptions — approximated by top-4 coverage
    (genomic data is ~99% covered; BAM/binary payloads are not)."""
    c = np.sort(np.asarray(counts, np.int64))[::-1]
    total = int(c.sum())
    return total > 0 and int(c[:4].sum()) >= (total * 7) // 10


def _long_run_counts(data: np.ndarray, min_run: int = _MIN_RUN,
                     chunk: int = 4 << 20) -> np.ndarray:
    """Per-symbol count of positions inside runs >= min_run (chunked,
    bounded working set — same discipline as ops.sa_device helpers)."""
    out = np.zeros(256, np.int64)
    n = len(data)
    carry_val, carry_len = -1, 0
    for pos in range(0, n, chunk):
        part = data[pos:pos + chunk]
        m = len(part)
        diff = np.flatnonzero(part[1:] != part[:-1])
        starts = np.concatenate([[0], diff + 1])
        ends = np.concatenate([diff, [m - 1]])
        lens = (ends - starts + 1).astype(np.int64)
        vals = part[starts]
        if int(vals[0]) == carry_val:
            lens[0] += carry_len
        elif carry_len >= min_run:
            out[carry_val] += carry_len
        if len(lens) > 1:
            mid_vals, mid_lens = vals[:-1], lens[:-1]
            big = mid_lens >= min_run
            np.add.at(out, mid_vals[big], mid_lens[big])
        carry_val, carry_len = int(vals[-1]), int(lens[-1])
    if carry_len >= min_run:
        out[carry_val] += carry_len
    return out


def pack_block(data: np.ndarray, counts: np.ndarray | None = None,
               pad_to: int | None = None):
    """Host-side pack.  Returns (packed u8 [ceil(n/4)], base (4,) u8,
    runs i32 [R, 3] of (start, end, value), exc_pos i32 [E],
    exc_val u8 [E], n_total).

    `pad_to` > len(data) appends virtual zero bytes: they never touch
    the wire (the pad is one run entry, or an extension of a trailing
    zero run).  Run/point lists are bucket-padded with inert entries.
    """
    data = np.asarray(data, dtype=np.uint8)
    n = len(data)
    total = pad_to if pad_to is not None and pad_to > n else n
    if counts is None:
        counts = np.bincount(data, minlength=256)
    # base = top-4 by SCATTERED count (long runs are cheap whoever owns
    # them — a centromeric N megarun must not displace a real base
    # letter and turn its every occurrence into a point exception);
    # ties broken by byte value, deterministic across calls
    scattered = np.asarray(counts, np.int64) - _long_run_counts(data)
    order = np.argsort(-scattered, kind="stable")
    base = np.sort(order[:4]).astype(np.uint8)

    code_tab = np.zeros(256, dtype=np.uint8)
    for i, b in enumerate(base):
        code_tab[b] = i
    is_base = np.zeros(256, dtype=bool)
    is_base[base] = True

    codes = code_tab[data]
    exc_mask = ~is_base[data]

    # maximal constant-value exception runs
    run_list = []                    # (start, end, val)
    exc_idx = np.flatnonzero(exc_mask).astype(np.int64)
    if len(exc_idx):
        brk = np.flatnonzero((np.diff(exc_idx) != 1)
                             | (data[exc_idx[1:]] != data[exc_idx[:-1]]))
        starts = exc_idx[np.concatenate([[0], brk + 1])]
        ends = exc_idx[np.concatenate([brk, [len(exc_idx) - 1]])] + 1
        big = (ends - starts) >= _MIN_RUN
        for s, e in zip(starts[big], ends[big]):
            run_list.append((int(s), int(e), int(data[s])))
            exc_mask[s:e] = False    # big runs leave the point list
    if total > n:
        if run_list and run_list[-1][1] == n and run_list[-1][2] == 0:
            s, _, v = run_list.pop()
            run_list.append((s, total, 0))
        else:
            run_list.append((n, total, 0))
    exc_pos = np.flatnonzero(exc_mask).astype(np.int32)
    exc_val = data[exc_pos]

    pad4 = (-n) % 4
    if pad4:
        codes = np.concatenate([codes, np.zeros(pad4, np.uint8)])
    quads = codes.reshape(-1, 4)
    packed = (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
              | (quads[:, 3] << 6))

    rp = _pad_len(len(run_list))
    runs = np.full((rp, 3), total, dtype=np.int32)   # inert: start=end
    for i, (s, e, v) in enumerate(run_list):
        runs[i] = (s, e, v)
    ep = _pad_len(len(exc_pos))
    if ep != len(exc_pos):
        fill_val = data[0] if n else 0
        exc_pos = np.concatenate(
            [exc_pos, np.zeros(ep - len(exc_pos), np.int32)])
        exc_val = np.concatenate(
            [exc_val, np.full(ep - len(exc_val), fill_val, np.uint8)])
    return packed, base, runs, exc_pos, exc_val, total


def wire_bytes(n: int, n_runs: int, n_exc: int) -> int:
    """Bytes a packed upload costs on the transport."""
    return -(-n // 4) + 13 * n_runs + 5 * n_exc + 8


def unpack_device(packed, base: tuple[int, int, int, int], runs,
                  exc_pos, exc_val, n: int):
    """Device-side unpack (jittable; `base` and `n` static = total
    length INCLUDING any virtual zero padding).

    2-bit codes -> 4-way select; exception runs painted via one
    searchsorted over the (sorted, inert-padded) run table; scattered
    exceptions restored by one bounded scatter (padded entries rewrite
    position 0 with its true value — idempotent by construction).
    """
    import jax.numpy as jnp

    shifts = jnp.arange(4, dtype=jnp.uint8) * 2
    codes = ((packed[:, None] >> shifts[None, :]) & 3).reshape(-1)
    out = jnp.full(codes.shape, jnp.uint8(base[0]))
    for i in range(1, 4):
        out = jnp.where(codes == i, jnp.uint8(base[i]), out)
    out = out[:n] if out.shape[0] >= n else jnp.concatenate(
        [out, jnp.zeros((n - out.shape[0],), jnp.uint8)])
    if runs.shape[0]:
        iota = jnp.arange(n, dtype=jnp.int32)
        j = jnp.clip(jnp.searchsorted(runs[:, 0], iota, side="right") - 1,
                     0, runs.shape[0] - 1)
        covered = (iota >= runs[j, 0]) & (iota < runs[j, 1])
        out = jnp.where(covered, runs[j, 2].astype(jnp.uint8), out)
    if exc_pos.shape[0]:
        out = out.at[exc_pos].set(exc_val)
    return out


def put_packed(data: np.ndarray, counts: np.ndarray | None = None,
               device=None, pad_to: int | None = None):
    """Host -> device: pack, transfer, unpack.  Returns the uint8 device
    array (async — not blocked on).  Falls back to a plain device_put
    for blocks too small to matter or too exception-heavy to win."""
    import jax
    import jax.numpy as jnp

    data = np.asarray(data, dtype=np.uint8)
    n = len(data)
    if n >= (1 << 20) and counts is None:
        counts = np.bincount(data, minlength=256)
    if n < (1 << 20) or not should_pack(counts):
        if pad_to is not None and pad_to > n:
            data = np.concatenate([data, np.zeros(pad_to - n, np.uint8)])
        arr = jnp.asarray(data)
        return jax.device_put(arr, device) if device else arr
    packed, base, runs, exc_pos, exc_val, total = pack_block(
        data, counts, pad_to)
    unpack = jax.jit(unpack_device, static_argnames=("base", "n"))
    args = [jnp.asarray(packed), jnp.asarray(runs), jnp.asarray(exc_pos),
            jnp.asarray(exc_val)]
    if device is not None:
        args = [jax.device_put(a, device) for a in args]
    return unpack(args[0], tuple(int(b) for b in base), args[1], args[2],
                  args[3], total)


# -- device -> host fetch: flat 4-bit nibbles (decode path) ------------------

def pack_nibbles_device(text, symbols: tuple[int, ...]):
    """Device-side 4-bit pack (jittable; `symbols` static, sigma <= 16 —
    the plane-engine contract).  Returns uint8 [ceil(n/2)]: two plane
    codes per byte."""
    import jax.numpy as jnp

    n = text.shape[0]
    code = jnp.zeros((n,), jnp.uint8)
    for i, s in enumerate(symbols):
        code = jnp.where(text == jnp.uint8(s), jnp.uint8(i), code)
    if n % 2:
        code = jnp.concatenate([code, jnp.zeros((1,), jnp.uint8)])
    # strided slices, not a [P, 2] reshape (a rank-2 u8 array with a
    # 2-wide minor dim may be tile-padded)
    return code[0::2] | (code[1::2] << 4)


def unpack_nibbles_host(packed: np.ndarray, symbols: tuple[int, ...],
                        n: int) -> np.ndarray:
    """Host-side unpack of a 4-bit device fetch (vectorized numpy)."""
    packed = np.asarray(packed, np.uint8)
    table = np.zeros(16, np.uint8)
    table[: len(symbols)] = np.asarray(symbols, np.uint8)
    codes = np.empty((len(packed), 2), np.uint8)
    codes[:, 0] = packed & 15
    codes[:, 1] = packed >> 4
    return table[codes.reshape(-1)[:n]]
