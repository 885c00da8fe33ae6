"""The k-mer partition's kernel wrappers (ops/kmer.py: kmer_count_into,
unique_mask, kmer_vote) against the JAX package's jitted k-mer functions,
on the CPU, where each wrapper runs its plain version.  Inputs are seeded
numpy (tests/torch_inputs.py: kmer_count_case, kmer_vote_case,
kmer_tile_case), the same
the card tests hold the kernels to; k = 6 and 12.  All outputs are
integers: equal exactly.

    JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_kmer.py
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_inputs import kmer_count_case, kmer_tile_case, kmer_vote_case
from volcanosv_tpu.ops import kmer as ref_kmer
from volcanosv_tpu_torch.ops import kmer


def _ref_count(chunks, k):
    """Σ over chunks of the JAX count_kmers_dense(kmer_hashes(chunk))."""
    table = np.zeros(4**k, np.int64)
    for c in chunks:
        table += np.asarray(ref_kmer.count_kmers_dense(
            *ref_kmer.kmer_hashes(jnp.asarray(c[None, :]), k), k))
    return table.astype(np.int32)


def _ref_vote(codes, lens, k, tables):
    """The JAX chain of the vote: kmer_hashes, the length clip of
    partition.py's `_read_hashes`, unique_mask, distinct_runs and
    overlap_scores."""
    h, v = ref_kmer.kmer_hashes(jnp.asarray(codes), k)
    idx = jnp.arange(h.shape[1])[None, :]
    v = v & (idx < (jnp.asarray(lens)[:, None] - k + 1))
    u = ref_kmer.unique_mask(jnp.asarray(tables))
    return (np.asarray(ref_kmer.overlap_scores(
        *ref_kmer.distinct_runs(h, v), jnp.asarray(tables), u)),
        np.asarray(u))


@pytest.mark.parametrize("k", [6, 12])
def test_kmer_count_into_matches_jax_over_chunk_seams(k):
    """Three chunks and a tail counted into one table: the JAX package's
    per-chunk tables summed, and the count of the whole stream in one
    chunk (each window once across the seams)."""
    stream, chunks = kmer_count_case(k, k)
    table = torch.zeros(4**k, dtype=torch.int32)
    for c in chunks:
        assert kmer.kmer_count_into(table, torch.from_numpy(c)[None, :],
                                    k) is table
    want = _ref_count(chunks, k)
    np.testing.assert_array_equal(table.numpy(), want)
    np.testing.assert_array_equal(want, _ref_count([stream], k))
    assert table.sum() > 0


@pytest.mark.parametrize("k", [6, 12])
def test_kmer_count_into_lens_match_jax(k):
    """(B, L) rows with lengths, as the sharded step counts its windows:
    the JAX package's count of the hashes clipped to w < len - k + 1,
    added to a table that already holds counts."""
    codes, lens, _ = kmer_vote_case(k + 1, k)
    lens[3] = k - 1                      # shorter than one window
    base = np.random.default_rng(k).integers(0, 3, 4**k).astype(np.int32)
    table = torch.from_numpy(base.copy())
    kmer.kmer_count_into(table, torch.from_numpy(codes), k,
                         torch.from_numpy(lens))
    h, v = ref_kmer.kmer_hashes(jnp.asarray(codes), k)
    v = v & (jnp.arange(h.shape[1])[None, :]
             < (jnp.asarray(lens)[:, None] - k + 1))
    want = base + np.asarray(ref_kmer.count_kmers_dense(h, v, k))
    np.testing.assert_array_equal(table.numpy(), want)


@pytest.mark.parametrize("zero_tables", [False, True])
@pytest.mark.parametrize("k", [6, 12])
def test_unique_mask_and_kmer_vote_match_jax(k, zero_tables):
    """16 reads with the edge rows (two empty rows, an all-N row, a
    homopolymer, an N run, a full row) against four haplotype tables, and
    the partition's single-block layout with two zero tables: unique
    masks and (B, 4) votes equal to the JAX package's."""
    codes, lens, tables = kmer_vote_case(k, k, zero_tables=zero_tables)
    want, u_want = _ref_vote(codes, lens, k, tables)
    t = torch.from_numpy(tables)
    u = kmer.unique_mask(t)
    assert u.dtype == torch.bool
    np.testing.assert_array_equal(u.numpy(), u_want)
    got = kmer.kmer_vote(torch.from_numpy(codes), torch.from_numpy(lens),
                         k, t, u)
    assert got.dtype == torch.int32 and got.shape == (16, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[10:13] == 0).all()            # empty and all-N rows
    assert want[13, 0] > 0 and (want[13, 1:] == 0).all()  # homopolymer
    assert want[:10].sum() > 0
    if zero_tables:
        assert (want[:, 2:] == 0).all()


@pytest.mark.parametrize("k", [6, 12])
def test_kmer_vote_matches_jax_across_tile_seams(k):
    """Rows across the card's vote tiles (2048 windows): a unique k-mer's
    run across two seams, one unique k-mer in two tiles, reads shorter
    than k, empty and all-N rows, partial and one-window last tiles: votes
    equal to the JAX package's, the homopolymer k-mer's table count once
    in row 1."""
    codes, lens, tables = kmer_tile_case(k + 7, k)
    want, _ = _ref_vote(codes, lens, k, tables)
    t = torch.from_numpy(tables)
    got = kmer.kmer_vote(torch.from_numpy(codes), torch.from_numpy(lens),
                         k, t, kmer.unique_mask(t))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[[3, 4, 7]] == 0).all()
    assert want[1, 0] >= (3000 - k + 1) + 7


def test_wrappers_run_plain_versions_for_cpu_tensors(monkeypatch):
    """Each wrapper takes its plain version for CPU tensors, launches no
    kernel and builds nothing."""
    from volcanosv_tpu_torch.ops import cuda_build
    calls = []
    for name in ("_kmer_count_plain", "_unique_mask_plain",
                 "_kmer_vote_plain"):
        fn = getattr(kmer, name)
        monkeypatch.setattr(kmer, name, lambda *a, _fn=fn, _n=name, **kw:
                            calls.append(_n) or _fn(*a, **kw))

    def no_build(*a, **kw):
        raise AssertionError("a CPU call built the kernels")
    monkeypatch.setattr(cuda_build, "lib", no_build)
    fns = (kmer.kmer_count_into, kmer.unique_mask, kmer.kmer_vote)
    before = [fn.launches for fn in fns]
    codes, lens, tables = kmer_vote_case(3, 6)
    c, ln, t = (torch.from_numpy(x) for x in (codes, lens, tables))
    kmer.kmer_count_into(torch.zeros(4**6, dtype=torch.int32), c, 6, ln)
    u = kmer.unique_mask(t)
    kmer.kmer_vote(c, ln, 6, t, u)
    assert calls == ["_kmer_count_plain", "_unique_mask_plain",
                     "_kmer_vote_plain"]
    assert [fn.launches for fn in fns] == before


def test_wrappers_reject_bad_inputs():
    """Wrong dtypes, ranks or shapes, strided inputs, mixed devices and k
    outside 1..15 raise ValueError before any work."""
    codes, lens, tables = kmer_vote_case(4, 6)
    c, ln, t = (torch.from_numpy(x) for x in (codes, lens, tables))
    u = kmer.unique_mask(t)
    table = torch.zeros(4**6, dtype=torch.int32)
    bad_count = [(table.long(), c, 6, None), (table, c.int(), 6, None),
                 (table, c.T.contiguous().T, 6, None),
                 (table, c, 6, ln.long()), (table, c, 6, ln[:3]),
                 (table[:100], c, 6, None), (table, c, 0, None),
                 (torch.zeros(4**16, dtype=torch.int32, device="meta"), c,
                  16, None),
                 (table.to("meta"), c, 6, None)]
    for args in bad_count:
        with pytest.raises(ValueError):
            kmer.kmer_count_into(*args)
    for bad in (t.long(), t[0], t.T.contiguous().T):
        with pytest.raises(ValueError):
            kmer.unique_mask(bad)
    bad_vote = [(c.int(), ln, 6, t, u), (c, ln.long(), 6, t, u),
                (c, ln, 6, t, u.int()), (c, ln, 6, t[:, :100], u),
                (c, ln, 5, t, u), (c, ln, 16, t, u),
                (c, ln[:3], 6, t, u), (c, ln.to("meta"), 6, t, u)]
    for args in bad_vote:
        with pytest.raises(ValueError):
            kmer.kmer_vote(*args)



@pytest.mark.parametrize("k", [6, 12])
def test_kmer_count_into_edge_chunks_match_jax(k):
    """Chunks of one repeated k-mer (poly-A: hash 0; poly-T: hash 4^k - 1),
    an all-N chunk and a random one with N runs, each added to a table that
    already holds counts: the JAX package's count plus the counts (the
    card tests hold the kernel to the same chunks)."""
    rng = np.random.default_rng(k + 40)
    codes = rng.integers(0, 4, (4, 5000)).astype(np.int8)
    codes[0], codes[1], codes[2] = 0, 3, 4
    codes[3, 2040:2050] = 4
    base = rng.integers(0, 5, 4**k).astype(np.int32)
    for row in codes:
        got = kmer.kmer_count_into(torch.from_numpy(base.copy()),
                                   torch.from_numpy(row)[None], k)
        want = base + _ref_count([row], k)
        np.testing.assert_array_equal(got.numpy(), want)
    assert _ref_count([codes[0]], k)[0] == 5000 - k + 1
    assert _ref_count([codes[1]], k)[4**k - 1] == 5000 - k + 1
