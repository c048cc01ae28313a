import os

# Tests run on a virtual 8-device CPU mesh; the GPU path is exercised by
# chip_smoke.py on the card.  Both the env var and jax.config pin the CPU.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_dna(rng, n, alphabet=b"ACGT", weights=None):
    syms = np.frombuffer(bytes(alphabet), dtype=np.uint8)
    return rng.choice(syms, size=n, p=weights)


def random_block(rng, nseq=3, minlen=5, maxlen=200, alphabet=b"ACGTN"):
    """Concatenated \0-terminated sequences, like one gecoz block."""
    seqs = [random_dna(rng, int(rng.integers(minlen, maxlen)), alphabet)
            for _ in range(nseq)]
    parts = []
    for s in seqs:
        parts.append(s)
        parts.append(np.zeros(1, dtype=np.uint8))
    return np.concatenate(parts), seqs
