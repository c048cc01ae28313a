"""chip_smoke.py's phases at tiny sizes on the CPU, and its contract.

The script itself refuses to run without a GPU; its phase functions are
plain functions, so the CPU tests drive them directly (the device tier
runs on CPU JAX here).  The `gpu` test runs the script on a card and
skips where there is none.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cs():
    return _load("chip_smoke")


@pytest.fixture(scope="module")
def indexed(cs, tmp_path_factory):
    """hg38-profile genome (chr1 64 KiB) indexed through the CLI on the
    device tier."""
    work = tmp_path_factory.mktemp("smoke")
    genome = cs.phase_genome(work, 64 << 10, 48)
    rec = cs.phase_index(work, genome)
    return work, genome, rec


def test_index_runs_device_phases(indexed):
    _, genome, rec = indexed
    assert rec["phases"]["mesh.sa"]["calls"] > 0
    assert rec["phases"]["mesh.wavelet"]["calls"] > 0
    assert 1 < rec["blocks"] < genome["nseq"]     # chr1-capped merging


def test_decode_and_queries(cs, indexed):
    work, genome, rec = indexed
    dec = cs.phase_decode(work, genome, rec["gcz"], rec["blocks"])
    assert dec["phases"]["decode.kernel_fetch"]["calls"] == rec["blocks"]
    cs.phase_queries(work, genome, rec["gcz"])


def test_gff3_device_equals_host(cs, indexed):
    work, genome, rec = indexed
    host_out = work / "gff_host.txt"
    host = cs.start_host_gff(rec["gcz"], genome["reads"], host_out)
    try:
        out = cs.phase_gff(genome, rec["gcz"], rec["blocks"], host,
                           host_out)
    finally:
        host.kill()
        host.wait()
    assert out["rows"] > 0


def test_phases_detect_wrong_output(cs, indexed):
    """A wrong expectation fails the phase instead of passing over it."""
    work, genome, rec = indexed
    bad = dict(genome, md5=dict(genome["md5"], chr1="0" * 32))
    with pytest.raises(AssertionError, match="md5"):
        cs.phase_decode(work, bad, rec["gcz"], rec["blocks"])
    pat, want = genome["counts"][0]
    bad = dict(genome, counts=[(pat, want + 1)])
    with pytest.raises(AssertionError, match="count"):
        cs.phase_queries(work, bad, rec["gcz"])


def test_identity_device_equals_native(cs, tmp_path):
    rec = cs.phase_identity(tmp_path, 64 << 10)
    assert set(rec) == {"device_s", "native_s"}


def test_reads_shape(cs):
    import numpy as np
    rng = np.random.default_rng(0)
    src = {"a": np.frombuffer(b"ACGTN" * 200, np.uint8).copy()}
    src["a"][:500] = ord("A")
    reads = cs.make_reads(rng, src, 40)
    assert len(reads) == 40
    assert all(100 <= len(r) <= 150 for r in reads)
    assert all(b"N" not in r for r in reads)


def test_measure_helpers_agree_across_strategies(cs):
    rec = cs.measure_apply_perm([10])
    assert set(rec) == {f"{k}_{v}v_2^10_ms" for k in ("sort", "scatter")
                        for v in (1, 3)}
    be = cs.measure_breakeven([4 << 10])
    assert set(be) == {"device_4096_ms", "native_4096_ms"}


def test_result_line_format(cs):
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"
    line = cs.result_line(Dev(), 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_main_exits_without_gpu(cs, tmp_path, capsys):
    with pytest.raises(SystemExit) as ex:
        cs.main(["--work", str(tmp_path / "w"), "--out", str(tmp_path)])
    assert ex.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_bench_exits_without_gpu(capsys):
    bench = _load("bench")
    with pytest.raises(SystemExit) as ex:
        bench.main([])
    assert ex.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_script_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py the script fails and
    prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture
def gpu_card():
    """Skip unless an NVIDIA card answers nvidia-smi."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.gpu
def test_chip_smoke_small_on_gpu(gpu_card, tmp_path):
    """The whole script at small sizes on the card, in a child process
    (this one pins JAX to the CPU)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run(
        [sys.executable, "chip_smoke.py", "--chr1-kib", "4096",
         "--ident-kib", "4096", "--reads", "256", "--measure-log2", "20",
         "--fused-kib", "4096", "--work", str(tmp_path / "w"),
         "--out", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
