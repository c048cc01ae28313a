"""Tier choice and failure behaviour of the device path.

`auto` picks the device tier only for a GPU backend and a block of at
least DEVICE_MIN_BYTES, before any device work; with `--backend device`
(or an `auto` that chose the device) a device error raises — there is no
silent host fallback at any of the four places that used to have one.
"""

import os

import numpy as np
import pytest

import jax

from conftest import random_dna
from gecoz_tpu.utils import accel, metrics
from test_gcz_files import write_fasta


class DeviceDown(RuntimeError):
    pass


def _boom(*_a, **_k):
    raise DeviceDown("device step failed")


def _fasta(tmp_path, rng, n=3000):
    fa = tmp_path / "in.fa"
    write_fasta(fa, [("chr1", random_dna(rng, n, b"ACGTN")),
                     ("chr2", random_dna(rng, n // 3))])
    return fa


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("delta", [-1, 0, 1 << 20])
def test_auto_rule(platform, delta, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    nbytes = accel.DEVICE_MIN_BYTES + delta
    assert accel.device_tier(nbytes) == (platform == "gpu" and delta >= 0)


def test_require_gpu_exits_on_cpu():
    with pytest.raises(SystemExit) as ex:
        accel.require_gpu()
    assert "no GPU" in str(ex.value)


def test_encode_block_device_error_raises(rng, monkeypatch):
    from gecoz_tpu.formats import gcz
    monkeypatch.setattr(gcz, "_encode_on_device", _boom)
    data = np.concatenate([rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                      2000), np.zeros(1, np.uint8)])
    with pytest.raises(DeviceDown):
        gcz.encode_block(data, ["a"], 32, backend="device")


def test_encode_blocks_device_error_raises(rng, monkeypatch):
    from gecoz_tpu.parallel import mesh
    monkeypatch.setattr(mesh, "index_states_batched", _boom)
    data = np.concatenate([rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                      2000), np.zeros(1, np.uint8)])
    with pytest.raises(DeviceDown):
        mesh.encode_blocks([data], [["a"]], 32, backend="device")


def test_index_fasta_device_error_raises(tmp_path, rng, monkeypatch):
    from gecoz_tpu.parallel import mesh
    from gecoz_tpu.tools import driver
    monkeypatch.setattr(mesh, "encode_blocks", _boom)
    with pytest.raises(DeviceDown):
        driver.index_fasta(_fasta(tmp_path, rng), tmp_path / "o.gcz",
                           backend="device")


def test_decompress_device_error_raises(tmp_path, rng, monkeypatch):
    from gecoz_tpu.ops import fmq
    from gecoz_tpu.tools import driver
    gcz = tmp_path / "o.gcz"
    driver.index_fasta(_fasta(tmp_path, rng), gcz, backend="native")
    monkeypatch.setattr(fmq, "device_block_from_fm_packed", _boom)
    with pytest.raises(DeviceDown):
        driver.decompress(gcz, tmp_path / "back.fa", backend="device")


@pytest.mark.parametrize("gpu", [False, True])
def test_auto_routes_by_rule(gpu, tmp_path, rng, monkeypatch):
    """auto takes the device pipeline exactly when the rule says so, and
    both tiers write the same bytes."""
    from gecoz_tpu.tools import driver
    monkeypatch.setattr(accel, "device_tier", lambda nbytes: gpu)
    fa = _fasta(tmp_path, rng)
    metrics.reset()
    driver.index_fasta(fa, tmp_path / "auto.gcz", backend="auto")
    ran_device = metrics.stats().get("mesh.sa") is not None
    assert ran_device == gpu
    driver.index_fasta(fa, tmp_path / "nat.gcz", backend="native")
    for ext in ("gcz", "gcx"):
        assert ((tmp_path / f"auto.{ext}").read_bytes()
                == (tmp_path / f"nat.{ext}").read_bytes())


@pytest.mark.parametrize("env,platforms,want", [
    ("/elsewhere/cache", "", "/elsewhere/cache"),
    (None, "", "default"),
    ("/elsewhere/cache", "cpu", None),
])
def test_compile_cache_dir(env, platforms, want, monkeypatch):
    import gecoz_tpu
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    monkeypatch.setenv("JAX_PLATFORMS", platforms)
    got = gecoz_tpu.compile_cache_dir()
    if want == "default":
        assert got == gecoz_tpu.DEFAULT_COMPILE_CACHE
        # fixed, inside the checkout, and gitignored
        root = os.path.dirname(gecoz_tpu.DEFAULT_COMPILE_CACHE)
        assert got == os.path.join(root, ".jax_cache")
        with open(os.path.join(root, ".gitignore")) as f:
            ignore = f.read()
        assert ".jax_cache/" in ignore.split()
    else:
        assert got == want


@pytest.mark.parametrize("platform,nvals,scatter", [
    ("cpu", 1, True), ("cpu", 3, True),
    ("gpu", 1, False), ("gpu", 2, True), ("gpu", 3, True),
])
def test_permutation_write_rule(platform, nvals, scatter, rng, monkeypatch):
    """GPU: one value rides a 2-operand (radix) sort, more values scatter;
    CPU: always scatter.  Both strategies write the same arrays."""
    import jax.numpy as jnp

    from gecoz_tpu.ops import sa_device
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert sa_device._scatter_is_cheap(nvals) == scatter
    n = 1000
    dest = rng.permutation(n).astype(np.int32)
    vals = [rng.integers(0, 1 << 30, n).astype(np.int32)
            for _ in range(nvals)]
    got = sa_device.apply_perm(jnp.asarray(dest),
                               *(jnp.asarray(v) for v in vals))
    got = got if nvals > 1 else (got,)
    for g, v in zip(got, vals):
        want = np.zeros_like(v)
        want[dest] = v
        assert np.array_equal(np.asarray(g), want)
