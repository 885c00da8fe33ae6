"""Seeded inputs shared by the port's CPU parity tests and its card tests,
and the JAX package's native-library guard of the parity tests.

Imports neither jax nor the JAX package at import time, so that the card
tests, run on a host without jax, can use it too.
"""
import os
import subprocess

import numpy as np


def viterbi_pairs(rng, B, R, W, err):
    """Pair-HMM inputs: read segments drawn from their hap windows with
    substitutions at rate `err` and deletions at `err / 2` (some padded,
    some empty), N codes sprinkled in the windows."""
    haps = rng.integers(0, 4, (B, W)).astype(np.int8)
    haps[rng.random((B, W)) < 0.01] = 4
    segs = np.full((B, R), 4, np.int8)
    lens = rng.integers(0, R + 1, B).astype(np.int32)
    for b in range(B):
        s = haps[b, rng.integers(0, 5):][:lens[b]].copy()
        mut = rng.random(len(s)) < err
        s[mut] = rng.integers(0, 4, int(mut.sum()))
        s = s[rng.random(len(s)) > err / 2]
        n = min(len(s), lens[b])
        segs[b, :n] = s[:n]
        segs[b, n:lens[b]] = rng.integers(0, 4, lens[b] - n)
    return segs, lens, haps


def ensure_reference_native_lib():
    """Load the JAX package's native library, whole, in this process.

    That package's native loader (volcanosv_tpu/native/__init__.py) has g++ write
    straight to the library's final path and only checks that the file
    exists, so a test worker can load another worker's half-written file;
    get_lib() then answers None for the rest of the process, and the
    inversion rescue takes its Python soup scan, which has no cap on its
    runs: the JAX package's calls change.  This builds the library under a
    temporary name and renames it into place when it is missing or does not
    load, then asserts that get_lib() holds it."""
    import volcanosv_tpu.native as native
    if native._lib is not None:
        return native._lib
    path = native._lib_path()

    def build():
        tmp = f"{path}.tmp{os.getpid()}"
        srcs = [os.path.join(native._HERE, s) for s in native._SOURCES]
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        "-std=c++17", *srcs, "-o", tmp, "-lz", "-lpthread"],
                       check=True, capture_output=True)
        os.replace(tmp, path)

    if not os.path.exists(path):
        build()
    try:
        lib = native.get_lib()
    except OSError:                  # a half-written library: rebuild it
        lib = None
    if lib is None:
        build()
        native._tried = False
        lib = native.get_lib()
    assert lib is not None, (
        "the JAX package's native library did not load: its build races "
        "parallel test workers (g++ writes the final .so path in place)")
    return lib
