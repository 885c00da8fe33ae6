"""Seeded inputs shared by the port's CPU parity tests and its card tests.

Imports neither jax nor the JAX package, so that the card tests, run on a
host without jax, can use it too.
"""
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
