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


# the edge batches of the pair-HMM Viterbi: (B, W, err, what), R = W + 16
VITERBI_EDGES = {
    "B1": (1, 41, 0.1, None),
    "B37": (37, 41, 0.1, None),
    "lens_0_and_R": (64, 41, 0.1, "lens_0_and_R"),
    "all_N_haps": (64, 41, 0.1, "all_N_haps"),
    "W9": (64, 9, 0.1, None),
    "W200": (64, 200, 0.1, None),
}


def viterbi_edge_case(name):
    """One VITERBI_EDGES batch: (segs, lens, haps, err, W).  lens_0_and_R:
    every second segment empty, the others R random bases; all_N_haps:
    every window all N (code 4)."""
    B, W, err, what = VITERBI_EDGES[name]
    R = W + 16
    rng = np.random.default_rng(B * 1000 + W)
    segs, lens, haps = viterbi_pairs(rng, B, R, W, err)
    if what == "lens_0_and_R":
        lens[::2] = 0
        lens[1::2] = R
        segs[::2] = 4
        segs[1::2] = rng.integers(0, 4, (len(segs[1::2]), R))
    elif what == "all_N_haps":
        haps[:] = 4
    return segs, lens, haps, err, W


def viterbi_mixed_case(W, B=64):
    """A pair-HMM batch whose warps mix segment lengths (segs, lens, haps,
    err, W), R = W + 16: lengths cycle through 0, R, 1, 3, W // 2, R - 1
    and W, so every group design's warp (4 to 8 pairs at W <= 64) holds
    empty, full and short segments side by side; a quarter of the pairs
    read N bases inside their segments (1 in 8), and pair 5's segment is
    all N."""
    R = W + 16
    rng = np.random.default_rng(W)
    segs, lens, haps = viterbi_pairs(rng, B, R, W, 0.1)
    cycle = [0, R, 1, 3, W // 2, R - 1, W]
    for b in range(B):
        n = cycle[b % len(cycle)]
        lens[b] = n
        segs[b, n:] = 4
        segs[b, :n] = haps[b, rng.integers(0, W, n)]
        if b % 4 == 1:
            segs[b, :n][rng.random(n) < 0.125] = 4
    segs[5, :lens[5]] = 4
    return segs, lens, haps, 0.1, W


# the vote kernel hashes 2048 windows a block (csrc/kmer.cu's TILE)
VOTE_TILE = 2048


def kmer_tile_case(seed, k):
    """A vote chunk across the vote kernel's tile seams: (codes (8, 8192) int8,
    lens (8,) int32, tables (4, 4^k) int32), on kmer_vote_case's tables
    and reads (table 0 alone holds the homopolymer k-mer, hash 0).  Rows:
    0, the case's reads joined to fill the row (the last tile partial);
    1, 6000 bases with a run of 3000 A across the seams at 2048 and 4096
    (one unique k-mer, its table count added once); 2, 5000 bases with k +
    2 A at 300 and again at 3000 (one unique k-mer in two tiles); 3, k - 1
    bases (no window); 4, empty; 5, 4096 + k - 1 bases (exactly two full
    tiles); 6, 2048 + k bases (a second tile of one window); 7, 3000 N."""
    codes0, lens0, tables = kmer_vote_case(seed, k)
    joined = np.concatenate([codes0[i, :lens0[i]] for i in range(10)]
                            + [codes0[-1, :lens0[-1]]] * 3)
    L = 8192
    rows = [joined[:L].copy(), joined[100:6100].copy(),
            joined[200:5200].copy(), joined[:k - 1].copy(),
            np.zeros(0, np.int8), joined[:VOTE_TILE * 2 + k - 1].copy(),
            joined[:VOTE_TILE + k].copy(), np.full(3000, 4, np.int8)]
    rows[1][1500:4500] = 0
    for at in (300, 3000):
        rows[2][at:at + k + 2] = 0
    codes = np.full((len(rows), L), 4, np.int8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        codes[i, :len(r)] = r
        lens[i] = len(r)
    return codes, lens, tables


# the coverage HMM's state-multiplier ladders (qc/flagger.py::state_mults)
STATE_MULTS = {3: [0.05, 1.0, 2.0], 4: [0.05, 0.5, 1.0, 2.0],
               5: [0.05, 0.5, 1.0, 2.0, 4.0]}


def hmm_tie_case(rng, n_states, B, T):
    """A ragged coverage batch rich in Viterbi ties: (means, tau, cov,
    valid).  Row 0 is full, row 1 all padding (equal scores in every
    state), the rest ragged; the two highest states share one mean, so
    their emissions are the same bits."""
    mults = np.asarray(STATE_MULTS[n_states])
    lam = float(rng.uniform(5, 40))
    cov = rng.poisson(lam * rng.choice(mults, (B, T))).astype(float)
    lens = rng.integers(1, T + 1, B)
    lens[0] = T
    valid = np.arange(T)[None] < lens[:, None]
    if B > 1:
        valid[1] = False
    cov[~valid] = 0
    means = mults * lam
    means[-1] = means[-2]
    return means, float(rng.uniform(1, 3)), cov, valid


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


# the k-mer partition kernels' inputs (chip_smoke.py holds copies of
# kmer_vote_case and kmer_count_case, since the smoke run imports no tests)


def kmer_vote_case(seed, k, long_row=False, zero_tables=False):
    """A chunk of reads and four haplotype tables for the vote: (codes
    (16, L) int8, lens (16,) int32, tables (4, 4^k) int32).

    Haplotypes 0 and 1 are one 8 kb genome with SNPs at 1/150 each,
    haplotypes 2 and 3 another (130 kb with `long_row`), with SNPs at 1/150
    and 1/20.  Table j holds each k-mer of haplotype j at a random count
    1-15, table 0 also the homopolymer k-mer (hash 0).  Rows 0-9 are reads
    of 300-4000 bases from a random haplotype with 1% substitutions (row 0
    with `long_row`: 120,000 bases of haplotype 2, whose windows unique to
    table 2 overflow the vote's shared memory at k 12), then two empty
    rows, an all-N row of 2000, 1500 A, a read with an N run, and a read
    of min(L, 8000) bases of haplotype 0.  L is the partition's bucket,
    pow2ceil(longest, 512).  `zero_tables`: tables 2 and 3 all zero, the
    partition's layout for a single candidate block."""
    from volcanosv_tpu_torch.ops.kmer import kmer_hashes_np
    rng = np.random.default_rng(seed)

    def snps(g, rate):
        g = g.copy()
        at = rng.random(len(g)) < rate
        g[at] = (g[at] + rng.integers(1, 4, int(at.sum()))) % 4
        return g

    ga = rng.integers(0, 4, 8000).astype(np.int8)
    gb = rng.integers(0, 4, 130_000 if long_row else 8000).astype(np.int8)
    haps = [snps(ga, 1 / 150), snps(ga, 1 / 150), snps(gb, 1 / 150),
            snps(gb, 1 / 20)]
    tables = np.zeros((4, 4**k), np.int32)
    for j, hp in enumerate(haps):
        h, v = kmer_hashes_np(hp, k)
        present = np.bincount(h[v], minlength=4**k) > 0
        tables[j, present] = rng.integers(1, 16, int(present.sum()))
    tables[0, 0] = 7
    tables[1:, 0] = 0
    if zero_tables:
        tables[2:] = 0

    def read(hp, n):
        s0 = int(rng.integers(0, len(hp) - n + 1))
        r = hp[s0:s0 + n].copy()
        err = rng.random(n) < 0.01
        r[err] = rng.integers(0, 4, int(err.sum()))
        return r

    rows = []
    for i in range(10):
        if long_row and i == 0:
            rows.append(read(haps[2], 120_000))
            continue
        j = int(rng.integers(0, 4))
        rows.append(read(haps[j], int(rng.integers(300, 4001))))
    rows += [np.zeros(0, np.int8), np.zeros(0, np.int8),
             np.full(2000, 4, np.int8), np.zeros(1500, np.int8)]
    r = read(haps[1], 3000)
    r[1000:1040] = 4
    rows.append(r)
    L = 512
    while L < max(len(r) for r in rows):
        L *= 2
    rows.append(read(haps[0], min(L, len(haps[0]))))
    codes = np.full((len(rows), L), 4, np.int8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        codes[i, :len(r)] = r
        lens[i] = len(r)
    return codes, lens, tables


def kmer_count_case(seed, k, chunk=4096):
    """A code stream of reads joined by single N separators, as
    partition.py's build_hap_tables makes it (read lengths 5-3000, 1% N),
    cut into chunks of `chunk` codes overlapping by k - 1, three chunks
    and a short tail: (stream (n,) int8, [chunks])."""
    rng = np.random.default_rng(seed)
    parts, n = [], 0
    while n < 3 * chunk:
        r = rng.integers(0, 4, int(rng.integers(5, 3001))).astype(np.int8)
        r[rng.random(len(r)) < 0.01] = 4
        parts += [r, np.full(1, 4, np.int8)]
        n += len(r) + 1
    stream = np.concatenate(parts)
    step = chunk - (k - 1)
    chunks = [stream[i:i + chunk] for i in range(0, len(stream), step)
              if len(stream[i:i + chunk]) >= k]
    return stream, chunks


# the MEC votes' inputs (phasing/phase.py::_mec_phase; chip_smoke.py holds
# copies of mec_case and the edge cases, since the smoke run imports no tests)


def mec_case(rng, n_reads, S, per_read, flip=0.15, zero=0.05):
    """Noisy observations of a random truth (h, a), shaped as a pileup makes
    them: read r observes 1 .. 2 * per_read - 1 consecutive SNPs from a
    start that grows with r, ordered by read; `flip` of the alleles
    flipped, `zero` of them 0.  Returns (obs_read int32, obs_snp int32,
    obs_allele int8)."""
    truth_h = rng.choice([-1, 1], S)
    truth_a = rng.choice([-1, 1], n_reads)
    n = rng.integers(1, 2 * per_read, n_reads)
    start = np.sort(rng.integers(0, S, n_reads))
    obs_read = np.repeat(np.arange(n_reads), n)
    first = np.repeat(np.cumsum(n) - n, n)
    obs_snp = np.minimum(np.repeat(start, n) + np.arange(n.sum()) - first,
                         S - 1)
    o = truth_a[obs_read] * truth_h[obs_snp]
    o[rng.random(len(o)) < flip] *= -1
    o[rng.random(len(o)) < zero] = 0
    return obs_read.astype(np.int32), obs_snp.astype(np.int32), \
        o.astype(np.int8)


# the MEC edge cases (mec_edge_case): the threshold between the kernel's two
# designs is a card property, so its pair is made in the card tests
MEC_EDGES = ("n_iter_0", "n_iter_1", "n_iter_30", "uncovered", "all_zero",
             "one_obs", "no_obs", "duplicates", "tie", "unsorted")
MEC_TIE_SEED = 3


def mec_edge_case(name):
    """One MEC_EDGES case: (obs_read, obs_snp, obs_allele, S, n_reads,
    n_iter, h_init, seed); h_init None means chain_init's.  uncovered:
    reads 0-9 and 90-99 and every third SNP without observations; all_zero:
    every allele 0; one_obs / no_obs: one or no observation; duplicates:
    observations repeated up to three times, some with the other allele;
    tie: two SNPs read together, a bad h_init and no iteration, so that
    restart 0 loses and random restarts tie on the lowest MEC (seed
    MEC_TIE_SEED); unsorted: the observations shuffled, then an SV-marker
    column's appended at the end, as the pileup appends them."""
    rng = np.random.default_rng(MEC_EDGES.index(name) + 100)
    n_iter = {"n_iter_0": 0, "n_iter_1": 1, "n_iter_30": 30}.get(name, 5)
    h_init, seed = None, MEC_EDGES.index(name)
    if name in ("one_obs", "no_obs"):
        n = 1 if name == "one_obs" else 0
        return (np.full(n, 3, np.int32), np.full(n, 2, np.int32),
                np.full(n, -1, np.int8), 4, 5, 2, None, seed)
    if name == "tie":
        r = np.repeat(np.arange(6), 2).astype(np.int32)
        s = np.tile([0, 1], 6).astype(np.int32)
        return (r, s, np.ones(12, np.int8), 2, 6, 0,
                np.array([1, -1], np.int32), MEC_TIE_SEED)
    r, s, o = mec_case(rng, 80, 40, 5)
    S, n_reads = 40, 80
    if name == "uncovered":
        r, s, S, n_reads = r + 10, s * 3 // 2, 60, 100
    elif name == "all_zero":
        o[:] = 0
    elif name == "duplicates":
        k = rng.integers(1, 4, len(r))
        r, s, o = np.repeat(r, k), np.repeat(s, k), np.repeat(o, k)
        flip = rng.random(len(o)) < 0.1
        o[flip] *= -1
    elif name == "unsorted":
        p = rng.permutation(len(r))
        marker = np.sort(rng.choice(n_reads, 20, replace=False))
        r = np.concatenate([r[p], marker])
        s = np.concatenate([s[p], np.full(20, S)])
        o = np.concatenate([o[p], rng.choice([-1, 1], 20)])
        S += 1
    return (r.astype(np.int32), s.astype(np.int32), o.astype(np.int8), S,
            n_reads, n_iter, h_init, seed)


def mec_restart_mecs(obs_read, obs_snp, obs_allele, h0, n_reads):
    """Each restart's MEC with no iteration (numpy): the read vote from its
    h0 row, then the inconsistent observations."""
    o = obs_allele.astype(np.int64)
    out = []
    for h in h0.astype(np.int64):
        va = np.zeros(n_reads, np.int64)
        np.add.at(va, obs_read, h[obs_snp] * o)
        a = np.where(va >= 0, 1, -1)
        out.append(int(((a[obs_read] * h[obs_snp] * o < 0) & (o != 0)).sum()))
    return out


# read groups for the all-vs-all overlap pass (ops/overlap.py); chip_smoke.py
# holds a copy of ava_group, since the smoke run imports no tests


def ava_group(seed, hap_len=250_000, coverage=14.0, read_len=13_500,
              read_sd=3_000, err=0.002, repeats=0, tandem=0, min_len=200):
    """One haplotype's reads as 2-bit code arrays: a random haplotype (with
    `repeats` copies of a 2 kb unit and 300 copies of a 40 bp one spread
    over it, when asked, so that hash runs pass the 64-hit cap and the
    occurrence filter; with `tandem` copies of a 1 kb unit in one array at
    a third of its length, so that a read pair inside the array shares
    tens of thousands of anchors), reads at random starts, half
    reverse-complemented, with substitutions at err / 2 and 1-3 bp
    insertions and deletions at err / 4 each a base."""
    rng = np.random.default_rng(seed)
    hap = rng.integers(0, 4, hap_len).astype(np.int8)
    if repeats:
        unit = rng.integers(0, 4, 2000).astype(np.int8)
        short = rng.integers(0, 4, 40).astype(np.int8)
        for at in rng.integers(0, hap_len - 2000, repeats):
            hap[at:at + 2000] = unit
        for at in rng.integers(0, hap_len - 40, 300):
            hap[at:at + 40] = short
    if tandem:
        unit = rng.integers(0, 4, 1000).astype(np.int8)
        at = hap_len // 3
        hap[at:at + 1000 * tandem] = np.tile(unit, tandem)
    n = max(1, int(round(coverage * hap_len / read_len)))
    reads = []
    for _ in range(n):
        L = int(np.clip(rng.normal(read_len, read_sd), min_len, hap_len))
        s = int(rng.integers(0, hap_len - L + 1))
        r = hap[s:s + L]
        u = rng.random(L)
        sub = u < err / 2
        ins = (u >= err / 2) & (u < 3 * err / 4)
        dele = (u >= 3 * err / 4) & (u < err)
        r = np.where(sub, (r + rng.integers(1, 4, L)) % 4, r).astype(np.int8)
        parts, last = [], 0
        for i in np.nonzero(ins | dele)[0]:
            parts.append(r[last:i])
            size = int(rng.integers(1, 4))
            if ins[i]:
                parts.append(rng.integers(0, 4, size).astype(np.int8))
                last = i
            else:
                last = min(L, i + size)
        parts.append(r[last:])
        r = np.concatenate(parts).astype(np.int8)
        if rng.random() < 0.5:
            r = (3 - r[::-1]).astype(np.int8)
        reads.append(np.ascontiguousarray(r))
    return reads
