"""gecoz_tpu: a lossless genomic compression framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the reference
Java toolkit (redmitry/gecoz): FASTA <-> `.gcz` FM-index compression
(suffix array -> BWT -> Huffman-shaped wavelet tree with rank-indexed bit
vectors + sampled suffix array), batched FM-index count/locate/extract,
a from-scratch deflate/gzip/BGZF codec, and BAM/SAM readers — with
block-level data parallelism over device meshes.
"""

import os

__version__ = "0.1.0"

# fixed, so the compile cache keeps hitting across processes of one checkout
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compile_cache_dir() -> str | None:
    """Directory of JAX's persistent compilation cache, or None (no cache).

    `$JAX_COMPILATION_CACHE_DIR` when set, else `.jax_cache` at the root of
    the checkout.  None when the CPU is forced: CPU compiles are fast, and
    XLA:CPU's cache loader warns across machine-feature changes.
    """
    if os.environ.get("JAX_PLATFORMS", "").split(",")[0] == "cpu":
        return None
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_COMPILE_CACHE


def _enable_compile_cache() -> None:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`.

    The device programs (suffix sort, wavelet, decode) take seconds to
    compile each; the cache lets later processes of the same checkout
    load them instead.
    """
    path = compile_cache_dir()
    if path is None:
        return
    os.makedirs(path, exist_ok=True)
    import jax
    jax.config.update("jax_compilation_cache_dir", path)
    # cache every program that takes >= 1 s to compile, however small
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


_enable_compile_cache()
