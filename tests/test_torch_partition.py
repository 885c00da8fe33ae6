"""The k-mer partition in the port against the JAX package, on the CPU:
every ops/kmer.py function, the flat-stream table build on the inputs of
tests/test_partition_tables.py (incl. the chunk seam and the read-joint
separators), the read-chunk hashes, and `partition_reads` assignments on a
three-block diploid case.  All outputs are integers: equal exactly."""
import numpy as np
import pytest
import torch

import volcanosv_tpu.partition.partition as ref_pp
import volcanosv_tpu_torch.partition.partition as pp
from volcanosv_tpu.config import PartitionConfig as RefPartitionConfig
from volcanosv_tpu.ops import kmer as ref_kmer
from volcanosv_tpu_torch.config import PartitionConfig
from volcanosv_tpu_torch.ops import kmer


def _mk(rng, L):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, L))


def _codes(rng, B, L):
    """(B, L) int8 codes with N runs and N padding, as pad_codes gives."""
    c = rng.integers(0, 4, (B, L)).astype(np.int8)
    c[rng.random((B, L)) < 0.01] = 4
    for b in range(B):
        c[b, int(rng.integers(L // 2, L + 1)):] = 4
    return c


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [6, 12, 15])
def test_kmer_ops_match(k):
    rng = np.random.default_rng(k)
    codes = _codes(rng, 9, 400)
    h_w, v_w = ref_kmer.kmer_hashes(codes, k)
    h, v = kmer.kmer_hashes(torch.from_numpy(codes), k)
    _eq(h, h_w)
    _eq(v, v_w)
    _eq(kmer.canonical_hashes(h, k), ref_kmer.canonical_hashes(h_w, k))
    if k <= 12:
        _eq(kmer.count_kmers_dense(h, v, k),
            ref_kmer.count_kmers_dense(h_w, v_w, k))
    for row in codes[:3]:
        for a, b in zip(kmer.kmer_hashes_np(row, k),
                        ref_kmer.kmer_hashes_np(row, k)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(kmer.count_kmers_dense_np(codes, min(k, 8)),
                                  ref_kmer.count_kmers_dense_np(codes,
                                                                min(k, 8)))
    s_w, f_w, r_w = ref_kmer.distinct_runs(h_w, v_w)
    s, f, r = kmer.distinct_runs(h, v)
    _eq(s, s_w)
    _eq(f, f_w)
    _eq(r, r_w)
    # H = 4 tables over a 4^8 space (hashes folded into it), repeats and
    # shared k-mers among the tables
    k8 = 8
    tabs = rng.integers(0, 3, (4, 4**k8)).astype(np.int32)
    tabs[:, rng.random(4**k8) < 0.5] = 0
    u_w = ref_kmer.unique_mask(tabs)
    u = kmer.unique_mask(torch.from_numpy(tabs))
    _eq(u, u_w)
    hf, hf_w = h % 4**k8, np.asarray(h_w) % 4**k8
    s_w, f_w, r_w = ref_kmer.distinct_runs(hf_w, v_w)
    s, f, r = kmer.distinct_runs(hf, v)
    _eq(kmer.overlap_scores(s, f, r, torch.from_numpy(tabs), u),
        ref_kmer.overlap_scores(s_w, f_w, r_w, tabs, u_w))


def _tables_equal(seq_sets, k):
    got = pp.build_hap_tables(seq_sets, k, device="cpu")
    want = ref_pp.build_hap_tables(seq_sets, k)
    assert sorted(got) == sorted(want)
    for name in want:
        _eq(got[name], want[name])
    return got


def test_flat_tables_match(rng):
    """tests/test_partition_tables.py's inputs: reads of many lengths, two
    reads joined by a separator, empty and all-N read sets."""
    _tables_equal({"h": [_mk(rng, L) for L in (500, 301, 50, 7, 8, 1203)],
                   "j": [_mk(rng, 40), _mk(rng, 40)],
                   "e": [], "n": ["ACGNNNNNNNNNNGT"]}, 8)
    _tables_equal({"h": [_mk(rng, 40), _mk(rng, 40)]}, 10)


def test_flat_tables_chunk_seam(rng, monkeypatch):
    """A tiny _FLAT so reads straddle many chunk seams."""
    monkeypatch.setattr(pp, "_FLAT", 256)
    monkeypatch.setattr(ref_pp, "_FLAT", 256)
    _tables_equal({"h": [_mk(rng, L) for L in (100, 700, 255, 256, 257,
                                               31)]}, 6)


def test_read_hashes_match(rng):
    """The vote's chunk of reads (`_read_codes`) hashed and clipped to the
    reads' lengths as `kmer_vote` does: the JAX package's `_read_hashes`."""
    seqs = [_mk(rng, 100), _mk(rng, 50), "ACGTN" * 30]
    codes, lens, n = pp._read_codes(seqs, torch.device("cpu"))
    h, v = kmer._valid_windows(codes, 8, lens)
    h_w, v_w, n_w = ref_pp._read_hashes(seqs, 8)
    assert n == n_w == 3 and h.shape[0] == pp._CHUNK
    assert codes.dtype == torch.int8 and lens.dtype == torch.int32
    _eq(h, h_w)
    _eq(v, v_w)


@pytest.fixture(scope="module")
def partition_case():
    """Three phase blocks of 10 kb on a diploid genome whose haplotypes
    differ by a SNP every ~120 bp; per (block, hap) twelve phased 3 kb
    reads; 90 unphased reads (some shorter than min_read_len, some
    between blocks) from either haplotype, 1-6 kb."""
    rng = np.random.default_rng(17)
    g = np.array(list(_mk(rng, 30_000)))
    h2 = g.copy()
    at = np.nonzero(rng.random(len(g)) < 1 / 120)[0]
    h2[at] = np.array(list("ACGT"))[(np.searchsorted(list("ACGT"), g[at])
                                      + 1 + rng.integers(0, 3, len(at))) % 4]
    haps = {1: "".join(g), 2: "".join(h2)}
    blocks = [(1, 0, 9_999), (10_001, 10_000, 19_999),
              (20_001, 20_000, 29_999)]
    phased, unphased, seqs = {}, {}, {}
    for bid, s0, e0 in blocks:
        for hp in (1, 2):
            for i in range(12):
                s = int(rng.integers(s0, e0 - 3_000))
                name = f"p{bid}_{hp}_{i}"
                phased[name] = (hp, bid)
                seqs[name] = haps[hp][s:s + 3_000]
    for i in range(90):
        L = int(rng.integers(1_000, 6_000)) if i % 9 else 300
        s = int(rng.integers(0, 30_000 - L))
        seq = haps[1 + i % 2][s:s + L]
        unphased[f"u{i}"] = (seq, (s, s + L))
        seqs[f"u{i}"] = seq
    return phased, unphased, seqs, blocks


@pytest.mark.parametrize("blocks_used", ["three", "one"])
def test_partition_reads_match(partition_case, blocks_used):
    """Assignment dicts and single/double counts equal: with three blocks
    (4-way votes between neighbouring blocks) and with one block (the
    2-way vote with empty tables in the duplicate slots)."""
    phased, unphased, seqs, blocks = partition_case
    if blocks_used == "one":
        blocks = blocks[:1]
        phased = {n: v for n, v in phased.items() if v[1] == 1}
    got = pp.partition_reads(phased, unphased, seqs, blocks,
                             PartitionConfig(), device="cpu")
    want = ref_pp.partition_reads(phased, unphased, seqs, blocks,
                                  RefPartitionConfig())
    assert got.assignment == want.assignment
    assert (got.blocks, got.n_single, got.n_double) == \
        (want.blocks, want.n_single, want.n_double)
    assert want.n_single > 0 and len(want.assignment) == \
        len(phased) + len(unphased)
