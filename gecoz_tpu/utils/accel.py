"""Device-tier choice for the `auto` backend, and the device memory budget.

`auto` runs a block on the device tier when this process's default JAX
backend is a GPU and the block is at least `DEVICE_MIN_BYTES`; otherwise
the host tier encodes it.  The choice is made before any device work, so
a device error afterwards is an error, never a silent host fallback.
"""

from __future__ import annotations

import os
import subprocess

# Below this many bytes the native host tier encodes a block at least as
# fast as the device tier (warm, one block).  chip_smoke.py break-even on
# an H100 80GB HBM3 at 400 W, device vs native: 64 KiB 14.1 vs 7.3 ms,
# 512 KiB 58.2 vs 49.7 ms, 4 MiB 415 vs 546 ms, 16 MiB 1805 vs 2245 ms;
# on a 700 W H100 host, 4 MiB was a tie (613 vs 598 ms).
DEVICE_MIN_BYTES = 4 << 20


def device_tier(nbytes: int) -> bool:
    """True when `auto` should run `nbytes` of work on the device tier."""
    import jax
    return jax.default_backend() == "gpu" and nbytes >= DEVICE_MIN_BYTES


def require_gpu():
    """The first JAX device, which must be a GPU (SystemExit otherwise)."""
    import jax
    try:
        dev = jax.devices()[0]
    except RuntimeError as ex:
        raise SystemExit(f"no accelerator: {ex}") from ex
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev.platform}")
    return dev


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


# Single-device suffix-sort working set per input byte (sort operands,
# rerank keys and their buffers): peak_bytes_in_use after chip_smoke.py's
# hg38 index was 28.07 GB, 107.9 bytes per byte of the 248 MiB chr1 block
# (H100 80GB HBM3, 400 W; the peak also holds chr9's staged upload).
SA_DEVICE_BYTES_PER_CHAR = 108


def device_hbm_bytes() -> int | None:
    """Usable accelerator memory per device, or None when unknown.

    Queried from the live backend (memory_stats when exposed); the
    GECOZ_HBM_BYTES env var overrides (also the test hook for exercising
    the sharded-dispatch path on CPU meshes)."""
    env = os.environ.get("GECOZ_HBM_BYTES")
    if env:
        return int(env)
    import jax
    d = jax.devices()[0]
    if d.platform == "cpu":
        return None                     # host RAM: not the constraint
    limit = (d.memory_stats() or {}).get("bytes_limit")
    return int(limit) if limit else None


def needs_sharded_sa(nbytes: int) -> bool:
    """True when one block's device suffix sort cannot fit a single
    device's memory and must take the sharded kernel
    (gecoz_tpu.parallel.sharded_sa) across the mesh."""
    budget = device_hbm_bytes()
    if budget is None:
        return False
    return nbytes * SA_DEVICE_BYTES_PER_CHAR > budget
