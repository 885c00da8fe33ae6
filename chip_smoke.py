#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (volcanosv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--profile]

Run from the root of a checkout; it needs one CUDA card, builds the CUDA
kernels from `volcanosv_tpu_torch/csrc/` with nvcc, and writes its data
under `build/chip_smoke/`.  It imports nothing of JAX or of the JAX package.

Phase 1  each kernel against its plain PyTorch version on the card, at the
         shapes the vc-large-indel path gives it (and the consensus vote's
         W=64 traceback): scores, end columns, row-0 profiles and
         traceback bytes (rows < qlen) bit-equal, packed walk streams and
         done flags bit-equal (at the bucketed step bound and at a bound
         that cuts about half the walks short), decoded CIGARs equal.
         banded_dp's design of the band (a warp per alignment at W <= 512,
         W/512 warps per alignment above; the wide bands are those of
         edit_sim_batch's length buckets, half the pairs unrelated) and the
         block-per-alignment design are both checked and timed, in turns
         (block, warp or group, warp or group, block); tb_walk's two designs
         (a warp per alignment over tiles in shared memory, or a thread
         per alignment) likewise (thread, warp, warp, thread).  Kernel
         times are device time per launch of a queue of launches held
         behind a sleep kernel, so that the host's launch cost is not
         timed; the plain versions: their one checked call.  Each row
         gives the design the launcher picks, GCUPS = B*M*W / time (DP),
         the bound (`_dp_bound`, `_walk_bound`: one yardstick for every
         design, the DP's counted on the band cells inside the matrix) and
         the share of it.  A
         walk row adds `chain_ms`: the longest walk's steps times the
         card's shared-memory load-to-use latency, measured once by one
         warp chasing pointers through shared memory (the floor of any
         design that walks step by step), and its share of the time.
Phase 2  `vc-large-indel` through the port's CLI with `--device cuda` on a
         simulated 10 Mb chromosome (80 DEL + 80 INS of 50-2000 bp,
         120 kb phase-block contigs, HiFi reads at 10x); both kernels must
         have launched in that run (with the default seed: 17 and 15
         times), and the port's `eval` must
         give recall and precision >= 0.85 against the implanted truth.
         The (mode, design, B, M, W) of every banded_dp launch and the
         (design, B, M, W) of every tb_walk launch are listed.  A user's
         unit is a whole chromosome (50-250 Mb); 10 Mb only fits the run's
         time limit.  With --profile the run is traced with torch.profiler
         and the device time by kernel is printed.
Phase 2b the port's `eval` of phase 2's calls against a truth VCF with the
         inserted sequences in ALT, so that the ALT-sequence gate runs the
         edit-distance DP on every INS pair (W = 128 ... 2048 by length
         bucket), on the card and on the CPU: equal results, recall and
         precision >= 0.85, and the W/512-warp design launched (its count
         is the `banded_dp_group` entry's `launches`).
Phase 3  the same CLI on a 200 kb case with `--device cuda` and with
         `--device cpu` (the plain versions): the two VCFs must be
         byte-identical.
Phase 4  `asm --device cuda` (pileup with pair-HMM realignment, MEC
         phasing, k-mer read partition, OLC assembly) on a simulated 2 Mb
         chromosome (20 DEL + 20 INS of 50-2000 bp, het and hom SNPs at
         1/1500, HiFi reads at 30x, 9 kb: the golden recipe's coverage and
         read length), then `vc-large-indel --device cuda` on its
         `final_contigs.fa` with the same reads, and the port's `eval`:
         recall >= 0.8 and precision >= 0.7, and both kernels launched
         during `asm`.  The stage times, the DP launches by (mode, design,
         B, M, W) and the calls of the torch-op device functions are
         listed.  A user's chromosome is 50-250 Mb; the k-mer tables
         (4^12 int32 each, up to 8 resident) are at full size at any
         length.  With --profile the `asm` run is traced too.
Phase 4b `asm` with `--device cuda` and with `--device cpu` on the
         pipeline test's recipe (80 kb, 24x, 7 kb reads, seed 21), once
         with HiFi reads (`-d Hifi`, error 0.001) and once with CLR reads
         (`-d CLR`, substitutions 0.09 and indels 0.045, where every
         candidate site is realigned through the pair-HMM Viterbi, which
         must have been called on the card): final_contigs.fa,
         phased_snps.vcf, read_hp_chr1.tsv and phased.bam byte-identical
         in each.  Then each torch-op device function of the path on
         the card against the CPU, timed on both beside its bound: the
         pair-HMM Viterbi (8192 pairs, R = 57, W = 41, error 0.002 and 0.1;
         scores bit-equal), the MEC votes (8 restarts on phase 4's largest
         observation set), the k-mer hashes and count of one table-build
         chunk, the unique mask of four tables, and the distinct runs and
         4-way vote of one chunk of 64 reads (phase 4's own inputs; equal).
Phase 5  `run --device cuda` (reads -> asm -> the large-indel, small-indel
         and complex-SV callers -> merged VCF) on the golden recipe of
         tests/test_golden_e2e.py (4 x 250 kb, every SV type, a
         translocation, small indels, HiFi reads at 30x, 9 kb), simulated
         by the port's `sim`, whose truth.vcf must be the pinned
         tests/data/golden_truth.vcf; then the golden test's gates through
         the port's eval: SV F1 and recall >= 0.99, GT >= 0.98, small-indel
         recall >= 0.93, precision >= 0.95 and GT >= 0.90, SNP recall,
         precision and zygosity >= 0.95, switch error <= 0.02, the
         translocation as a 1|1 reciprocal BND pair.  Stage times, the DP
         launches by shape, and those made inside the complex-SV stage
         (counted around call_complex_svs), which must include the
         haplotype pairing's edit distances at W = 128.  With --profile
         the run is traced too.
Phase 5b `run` with `--device cuda` and with `--device cpu` on
         tests/test_torch_run.py's recipe (2 x 50 kb, an INV, a DUP, a
         translocation and small indels, 20x): the merged VCF, the three
         callers' VCFs, final_contigs.fa, phased_snps.vcf and phased.bam
         byte-identical.
Phase 6  QC and SD recovery on the card, each with `--device cuda` and
         with `--device cpu`: `qc` on phase 4's contigs and reads
         (flagger_blocks.bed byte-identical); the coverage HMM at
         chromosome scale (the two haplotypes of a 250 Mb chromosome at
         window 1000 in contigs of 120 kb - 5 Mb, 500,095 windows, a
         padded (190, 4970, 4) batch): fit_coverage_hmm (the same
         iterations, means and tau within rtol 1e-4), Viterbi labels
         equal, the card's posteriors no further from a float64
         forward-backward than twice the CPU's, each timed beside its bound;
         `sd_recover` on tests/test_sd_recovery.py's recipe (equal
         contigs, a re-assembled hap swapped in); `asm --sd` on phase 4b's
         HiFi case (final_contigs.fa and phased_snps.vcf byte-identical).
Phase 7  two ranks of one process group on the one card
         (`python -m volcanosv_tpu_torch.parallel.multihost`; both on
         cuda:0, device collectives over gloo, since NCCL takes one rank a
         card): `run` on phase 5's golden sim, whose six outputs must be
         phase 5's bytes; `vc-large-indel`, `vc-small-indel` and
         `vc-complex-sv` on phase 5b's recipe, equal to one rank's; the
         sharded step equal to one rank's on a 2 x 4 mesh of the card.
         Each rank's device, backend, chromosomes, times and launches are
         printed; every rank must launch both kernels.  Then the aligner's
         DP batch split over an in-process mesh of the card twice: the
         CIGARs of the unsplit call and of the CPU.

Any failure raises.  On success the last four lines of standard
output are the phases' summary (launches by shape, stage times, eval), the
card's `nvidia-smi` name and power limit, one JSON object with the kernels'
launches, errors, times and bounds (each path's entry is checked and
timed at the shape that path launched most: phase 1's row there, or a
check made at that shape after the paths ran), and the
`{"ok": true, ...}` line.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")

# Published peaks of one H100 SXM at its 700 W limit: HBM3 at 3.35 TB/s;
# int32 at 132 SMs x 64 int32 lanes x 1.98 GHz (the boost clock).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# fp32 outside the tensor cores: 132 SMs x 128 lanes x 1.98 GHz, one
# operation a lane a cycle (the data sheet's 67 TFLOP/s counts an FMA as two)
FP32_OPS_PER_S = 132 * 128 * 1.98e9

# int32 operations of one DP cell, counted from the recurrence of
# ops/banded_align.py::banded_dp_plain; an add, max, compare or select
# counts one.  Affine, score only (13): the match compare and the
# substitution select; E = max(H_up + go + ge, E_up + ge) (3); Htmp =
# max(H_diag + sub, E) (2); F: Htmp - ge*l, the running prefix max, + ge*l
# + go (3); H = max(Htmp, F) (1); the band masks of H and E (2).  A
# traceback adds the E-open, up, F-open (an add and a compare) and left
# tests and two to merge them into the byte (7).  Dual-affine adds E2, its
# prefix F2 and their maxes and mask (9), and with a traceback their four
# tests and one merge (7).  Edit distance (go = 0, one gap class), the least
# its recurrence needs (5): the match compare and the add of the
# substitution to H_diag (2); E = H_up + ge, since E_up never exceeds H_up
# (1); Htmp = max(H_diag + sub, E) (1); in the space H - ge*l (lane l), F is
# the exclusive running max of Htmp and H = max(Htmp, F) the inclusive one,
# one max for both (1); cells outside the matrix are not counted, so no
# mask.  Its traceback adds the up, F-open (an add and a compare) and left
# tests and the merge (6; E always opens).
DP_OPS_PER_CELL = {("edit", False): 5, ("edit", True): 11,
                   ("affine", False): 13, ("affine", True): 20,
                   ("dual", False): 22, ("dual", True): 36}
# int32 operations of one walk step, counted from the least a step needs
# (the table-driven step of csrc/tb_walk.cu): the hold test, the choice
# bits against the state's (an and, a compare: 2), the move's select (1),
# the table index from the state and the byte (a shift, a merge: 2), the
# offset update (1), the op packed into the stream (a shift, an or: 2).
# The step's two loads are no int32 operations: the traceback byte counts
# in the bytes, the transition table is no input.
WALK_OPS_PER_STEP = 8
# the main path's kernel launches on the 10 Mb slice with the default seed
# (the path is deterministic)
EXPECTED_LAUNCHES = {"banded_dp": 17, "tb_walk": 15}


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _time_queued_ms(fn, runs: int = 10) -> float:
    """Device milliseconds per call of `fn`: `runs` calls queued behind a
    sleep kernel, so that the events time the kernels and not the host's
    launch cost.  The sleep doubles until it outlasts the enqueueing."""
    import torch
    for _ in range(2):
        fn()
    cycles = 2_000_000
    while True:
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        s.record()
        for _ in range(runs):
            fn()
        e.record()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        # the sleep lasts at least cycles / 2 GHz (the SM clock is below
        # 2 GHz); keep a fifth of that as margin
        if host_s < 0.8 * cycles / 2e9:
            return s.elapsed_time(e) / runs
        cycles *= 2


def _smem_latency() -> dict:
    """One warp chasing 2^20 dependent shared-memory loads: cycles and
    nanoseconds per load (the load-to-use latency)."""
    import torch

    from volcanosv_tpu_torch.ops import cuda_build
    n = 1 << 20
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    cuda_build.check(cuda_build.lib("tb_walk").smem_chase(
        n, out.data_ptr(), torch.cuda.current_stream().cuda_stream),
        "smem_chase")
    cycles, ns, _ = out.tolist()
    return dict(cycles=cycles / n, ns=ns / n)


def _bound(n_bytes: float, n_ops: float,
           ops_per_s: float = INT32_OPS_PER_S) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their rate (int32 unless said)."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = n_ops / ops_per_s * 1e3
    return dict(bound_ms=max(b_ms, o_ms),
                bound_by="bytes" if b_ms >= o_ms else "operations",
                bytes=int(n_bytes), ops=int(n_ops))


def _dp_kind(scores) -> str:
    """The row of DP_OPS_PER_CELL: edit (go = 0, one gap class), affine or
    dual."""
    if scores.dual:
        return "dual"
    return "edit" if scores.gap_open == 0 else "affine"


def _dp_bound(qlen, tlen, M: int, W: int, d_lo: int, kind: str, tb: bool,
              row0: bool) -> dict:
    """Bound of one banded_dp call on these inputs, the same yardstick for
    every design.  Operations: the band cells inside the matrix (rows <
    qlen, 0 <= j < tlen), the function's least work, which a design may
    skip.  Bytes: each query and target byte read once, the lengths, the
    outputs (score, end column, the traceback of rows < qlen, the row-0
    profile) written once."""
    import numpy as np
    ql = np.asarray(qlen, np.int64)
    tl = np.asarray(tlen, np.int64)
    B = len(ql)
    rows = np.minimum(np.maximum(ql, 0), M)
    i = np.arange(M, dtype=np.int64)
    j_lo = np.maximum(0, -(i + d_lo))                         # first lane j >= 0
    cells = 0
    for s in range(0, B, 256):
        hi = np.minimum(W, tl[s:s + 256, None] - i - d_lo)    # lanes j < tlen
        n = np.maximum(hi - j_lo, 0) * (i < rows[s:s + 256, None])
        cells += int(n.sum())
    n_bytes = rows.sum() + tl.sum() + 16 * B \
        + (int(rows.sum()) * W if tb else 0) + (4 * M * B if row0 else 0)
    return dict(_bound(n_bytes, cells * DP_OPS_PER_CELL[(kind, tb)]),
                cells=cells)


def _walk_bound(ops, n_steps: int, B: int) -> dict:
    """Bound of one tb_walk call: the steps each walk takes before it is
    done, one traceback byte read per step, the lengths read, the packed
    stream and done flags written."""
    from volcanosv_tpu_torch.ops.banded_align import walk_lengths
    steps = int(walk_lengths(ops).sum())
    n_bytes = steps + 8 * B + n_steps // 4 * B + B
    return _bound(n_bytes, steps * WALK_OPS_PER_STEP)


def _pairs(rng, B: int, M: int, W: int, d_lo: int, unrelated=False):
    """Seeded alignment inputs in the style of tests/test_pallas_dp.py::_case:
    target = query with ~3% substitutions and ~1% 1-3 bp indels, lengths
    kept inside the band ((tlen - qlen) - d_lo < W).  With `unrelated`,
    every second pair is two unrelated sequences of lengths within 2x of
    each other, as edit_sim_batch receives them (scores far below zero)."""
    import numpy as np
    q = rng.integers(0, 4, (B, M), dtype=np.int8)
    t = np.full((B, M + W), 4, dtype=np.int8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b in range(B):
        ql = M - int(rng.integers(0, 8))
        if unrelated and b % 2:
            tl = int(rng.integers(max(1, ql + d_lo + 1, ql // 2),
                                  min(ql + d_lo + W - 1, 2 * ql) + 1))
            t[b, :tl] = rng.integers(0, 4, tl)
            q[b, ql:] = 4
            qlen[b], tlen[b] = ql, tl
            continue
        seq = q[b, :ql].copy()
        sub = rng.random(ql) < 0.03
        seq[sub] = rng.integers(0, 4, int(sub.sum()))
        seq = seq[rng.random(ql) > 0.005]
        at = np.sort(rng.integers(0, len(seq), int(0.005 * ql) + 1))
        seq = np.insert(seq, at, rng.integers(0, 4, len(at)).astype(np.int8))
        tl = min(len(seq), ql + d_lo + W - 1)
        tl = max(tl, 1, ql + d_lo + 1)
        if tl > len(seq):
            seq = np.concatenate(
                [seq, rng.integers(0, 4, tl - len(seq)).astype(np.int8)])
        t[b, :tl] = seq[:tl]
        q[b, ql:] = 4
        qlen[b], tlen[b] = ql, tl
    return q, t, qlen, tlen


def _scores_of(preset: str):
    from volcanosv_tpu_torch.config import AlignConfig
    from volcanosv_tpu_torch.ops import banded_align as ba
    c = AlignConfig.preset(preset)
    return ba.Scores(c.match, c.mismatch, c.gap_open, c.gap_extend,
                     c.gap_open2, c.gap_extend2)


def _timed_once(fn):
    import torch
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def phase1_kernels(seed: int):
    import numpy as np

    from volcanosv_tpu_torch.ops import banded_align as ba

    asm5, asm20 = _scores_of("asm5"), _scores_of("asm20")
    # the consensus vote's scores (olc.py::_vote_scores in the JAX package)
    vote = ba.Scores(match=2, mismatch=-3, gap_open=-4, gap_extend=-2)
    row0 = dict(with_traceback=False, row0_scores=True)
    score_only = dict(with_traceback=False)
    edit = ba.Scores.edit()
    cases = [  # case, B, M, W, d_lo, scores, DP flags, half unrelated
        ("traceback", 4096, 256, 256, -128, asm5, {}, False),
        ("traceback", 256, 8192, 256, -128, asm5, {}, False),
        ("row0", 1024, 1024, 128, -64, asm5, row0, False),
        ("edit", 1024, 4096, 4096, -2048, edit, score_only, False),
        ("dual-affine traceback", 1024, 1024, 256, -128, asm20, {}, False),
        ("free_t_end", 256, 512, 128, -64, asm5,
         dict(with_traceback=False, free_t_end=True), False),
        # the main path's small batches, a batch that is not a multiple of
        # the warps per block, and the widest band of the warp design
        ("traceback", 64, 256, 256, -128, asm5, {}, False),
        ("traceback", 64, 1024, 256, -128, asm5, {}, False),
        ("traceback", 64, 8192, 256, -128, asm5, {}, False),
        ("row0", 64, 1024, 128, -64, asm5, row0, False),
        ("traceback", 1001, 512, 256, -128, asm5, {}, False),
        ("edit", 1024, 512, 512, -256, edit, score_only, False),
        ("dual-affine traceback", 256, 512, 512, -256, asm20, {}, False),
        # the consensus vote's band (olc.py::_batched_cigars), and its
        # largest batch on phase 4's asm run
        ("consensus traceback", 2048, 1024, 64, -32, vote, {}, False),
        ("consensus traceback", 8192, 256, 64, -32, vote, {}, False),
        # the wide bands of edit_sim_batch's length buckets (L = 1024,
        # 2048, >= 4096: W = 1024, 2048, 4096), half the pairs unrelated
        ("edit", 64, 1024, 1024, -512, edit, score_only, True),
        ("edit", 1024, 1024, 1024, -512, edit, score_only, True),
        ("edit", 64, 2048, 2048, -1024, edit, score_only, True),
        ("edit", 64, 8192, 4096, -2048, edit, score_only, True),
        ("affine", 1024, 2048, 2048, -1024, asm5, score_only, True),
        # the complex-SV haplotype pairing's edit distances (clip_to = 10:
        # W = 128) on the golden run: 21 pairs padded to 64, in the length
        # buckets 512 and 1024
        ("pairing edit", 64, 512, 128, -64, edit, score_only, False),
        ("pairing edit", 64, 1024, 128, -64, edit, score_only, False),
    ]
    rng = np.random.default_rng(seed)
    dp_rows, walk_rows = [], []
    smem = _smem_latency()
    _log(f"shared-memory load-to-use latency: {smem['cycles']:.2f} cycles, "
         f"{smem['ns']:.3f} ns (one warp, pointer chase)")
    for case in cases:
        row, wrow = _check_case(rng, smem, *case)
        dp_rows.append(row)
        if wrow is not None:
            walk_rows.append(wrow)
    return dp_rows, walk_rows, smem


def _check_case(rng, smem: dict, case: str, B: int, M: int, W: int,
                d_lo: int, sc, kw: dict, unrelated: bool):
    """One phase-1 case on seeded `_pairs`: banded_dp's designs against
    the plain DP, then (with a traceback) tb_walk's designs against the
    plain walk, each checked and timed.  Returns (DP row, walk row or
    None)."""
    import numpy as np
    import torch

    from volcanosv_tpu_torch.ops import banded_align as ba
    dev = torch.device("cuda")
    mode = ba.dp_mode(sc, **kw)     # as banded_dp.shapes records it
    q, t, ql, tl = _pairs(rng, B, M, W, d_lo, unrelated)
    args = [torch.from_numpy(x).to(dev) for x in (q, t, ql, tl)]
    plain, plain_ms = _timed_once(
        lambda: ba.banded_dp_plain(*args, W, d_lo, sc, **kw))
    rows = torch.arange(M, device=dev)[None, :] < args[2][:, None]
    taken = ba.banded_dp_branch(W)          # "warp" or "group"
    branches = ["block", taken]
    err = 0
    for br in branches + ["auto"]:
        kern = ba.banded_dp(*args, W, d_lo, sc, **kw, branch=br)
        torch.cuda.synchronize()
        err = max(err, int((kern[0] - plain[0]).abs().max()),
                  int((kern[1] - plain[1]).abs().max()))
        if kern[3] is not None:
            err = max(err, int((kern[3] - plain[3]).T[rows].abs().max()))
        if kern[2] is not None:
            err = max(err, int((kern[2][rows].int()
                                - plain[2][rows].int()).abs().max()))
        if err:
            raise AssertionError(f"banded_dp {case} B={B} M={M} W={W} "
                                 f"{br}: kernel != plain (max abs err "
                                 f"{err})")
    times = {br: [] for br in branches}
    for br in branches + branches[::-1]:
        times[br].append(_time_queued_ms(lambda: ba.banded_dp(
            *args, W, d_lo, sc, **kw, branch=br)))
    ms = statistics.mean(times[taken])
    bound = _dp_bound(ql, tl, M, W, d_lo, _dp_kind(sc),
                      kw.get("with_traceback", True),
                      kw.get("row0_scores", False))
    row = dict(case=case, mode=mode, B=B, M=M, W=W, d_lo=d_lo,
               unrelated=unrelated,
               branch=taken, max_abs_err=err, ms=ms,
               ms_by_branch={br: statistics.mean(v)
                             for br, v in times.items()},
               plain_ms=plain_ms, gcups=B * M * W / ms / 1e6,
               share_of_bound=bound["bound_ms"] / ms, **bound)
    _log(f"banded_dp {json.dumps(row)}")
    if kern[2] is None:
        return row, None
    tb = kern[2]
    n_steps, _full = ba.walk_steps(M, W, ql, tl)
    (pp, dp), wplain = _timed_once(lambda: ba.tb_walk_plain(
        tb, args[2], args[3], d_lo, n_steps))
    ops_p = ba._unpack_ops(pp.cpu().numpy())
    lengths = ba.walk_lengths(ops_p)
    # a bound that cuts about half the walks short (done = false)
    n_cut = max(4, int(np.median(lengths)) // 4 * 4)
    pcut, dcut = ba.tb_walk_plain(tb, args[2], args[3], d_lo, n_cut)
    ops_cut = ba._unpack_ops(pcut.cpu().numpy())
    if not bool(dp.all()):
        raise AssertionError(f"tb_walk {case}: plain walks unfinished "
                             "at the bucketed bound")
    werr = 0
    for br in ("thread", "warp", "auto"):
        for steps, want, want_done in ((n_steps, ops_p, dp),
                                       (n_cut, ops_cut, dcut)):
            pk, dk = ba.tb_walk(tb, args[2], args[3], d_lo, steps,
                                branch=br)
            ops_k = ba._unpack_ops(pk.cpu().numpy())
            werr = max(werr, int(np.abs(ops_k.astype(np.int16)
                                        - want).max()))
            if werr or not torch.equal(dk, want_done):
                raise AssertionError(
                    f"tb_walk {case} B={B} M={M} W={W} {br} at "
                    f"{steps} steps: kernel != plain (streams or done)")
            if steps == n_steps:
                ops_full = ops_k
    ops_k = ops_full                 # "auto", the last design checked
    # end to end: kernel DP + kernel walk vs plain DP + plain walk
    pp2, _ = ba.tb_walk_plain(plain[2], args[2], args[3], d_lo, n_steps)
    cig_k = ba._rle_columns(ops_k, B)
    cig_p = ba._rle_columns(ba._unpack_ops(pp2.cpu().numpy()), B)
    if cig_k != cig_p:
        raise AssertionError(f"{case}: CIGARs differ between kernels "
                             "and plain versions")
    wtimes = {"thread": [], "warp": []}
    for br in ("thread", "warp", "warp", "thread"):
        wtimes[br].append(_time_queued_ms(lambda: ba.tb_walk(
            tb, args[2], args[3], d_lo, n_steps, branch=br)))
    wtaken = "warp"                  # the design of "auto"
    wms = statistics.mean(wtimes[wtaken])
    wbound = _walk_bound(ops_k, n_steps, B)
    chain_ms = int(lengths.max()) * smem["ns"] * 1e-6
    wrow = dict(case=case, mode=mode, B=B, M=M, W=W, n_steps=n_steps,
                n_cut=n_cut,
                cut_unfinished=int((~dcut).sum()), branch=wtaken,
                max_abs_err=werr, ms=wms,
                ms_by_branch={br: statistics.mean(v)
                              for br, v in wtimes.items()},
                plain_ms=wplain, longest_walk=int(lengths.max()),
                chain_ms=chain_ms, share_of_chain=chain_ms / wms,
                share_of_bound=wbound["bound_ms"] / wms, **wbound)
    _log(f"tb_walk {json.dumps(wrow)}")
    del kern, plain, tb
    torch.cuda.empty_cache()
    return row, wrow


def _write_case(d: str, seed: int, length: int, n_del: int, n_ins: int):
    """Simulate one chromosome with the port's `sim` and write ref, contigs,
    reads and two truth VCFs under d (`_write_truth`)."""
    import numpy as np

    from volcanosv_tpu_torch import sim
    from volcanosv_tpu_torch.io.fasta import write_fasta
    from volcanosv_tpu_torch.io.fastq import write_fastq
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    ref = sim.random_genome(rng, length)
    hap1, hap2, truth = sim.implant_svs(rng, ref, n_del=n_del, n_ins=n_ins,
                                        min_len=50, max_len=2000)
    contigs = sim.contigs_from_haplotypes(hap1, hap2)
    reads = sim.simulate_reads(rng, {1: hap1, 2: hap2}, coverage=10.0)
    write_fasta(os.path.join(d, "ref.fa"), ref)
    write_fasta(os.path.join(d, "contigs.fa"), contigs)
    write_fastq(os.path.join(d, "reads.fastq"),
                ((n, s, None) for n, s, *_ in reads))
    _write_truth(d, ref, truth)
    return len(contigs), len(reads)


def _write_truth(d: str, ref: dict, truth: list) -> None:
    """Two truth VCFs under d: `truth.vcf` with symbolic ALTs, and
    `truth_seq.vcf` with the sequences (REF = the anchor base and the
    deleted bases, ALT = the anchor base and the inserted ones)."""
    from volcanosv_tpu_torch.io.vcf import VcfRecord, make_header, write_vcf

    def alleles(t):
        anchor = ref[t.chrom][t.pos]
        if t.svtype == "INS":
            return anchor, anchor + t.seq
        return ref[t.chrom][t.pos:t.pos + 1 + t.svlen], anchor

    header = make_header({c: len(s) for c, s in ref.items()})
    for name, resolved in (("truth.vcf", False), ("truth_seq.vcf", True)):
        recs = [VcfRecord(
            chrom=t.chrom, pos=t.pos + 1, id=f"truth-{i}",
            ref=alleles(t)[0] if resolved else "N",
            alt=alleles(t)[1] if resolved else f"<{t.svtype}>",
            gt="1|1" if t.gt == (1, 1) else ("1|0" if t.gt[0] else "0|1"),
            info={"SVTYPE": t.svtype, "SVLEN": t.svlen,
                  "END": t.pos + 1 + t.svlen}) for i, t in enumerate(truth)]
        write_vcf(os.path.join(d, name), header, recs)


def _vc_args(d: str, out: str, device: str,
             contigs: str = "contigs.fa") -> list[str]:
    return ["vc-large-indel", "--ref", os.path.join(d, "ref.fa"),
            "--contig", os.path.join(d, contigs),
            "--fastq", os.path.join(d, "reads.fastq"),
            "-o", out, "--device", device]


def _asm_args(d: str, out: str, device: str) -> list[str]:
    return ["asm", "--ref", os.path.join(d, "ref.fa"),
            "--fastq", os.path.join(d, "reads.fastq"),
            "-o", out, "--device", device]


def _profile_summary(prof, wall_s: float) -> dict:
    """Device time by kernel name (ms) from a torch.profiler trace, the
    summed device time and its share of the wall time."""
    by_name = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_name[e.key] = (by_name.get(e.key, (0.0, 0))[0] + us / 1e3,
                          by_name.get(e.key, (0.0, 0))[1] + e.count)
    busy = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(busy_ms=busy, wall_s=wall_s,
                busy_share=busy / (wall_s * 1e3),
                kernels=[dict(name=k[:120], ms=v[0], count=v[1])
                         for k, v in top])


def phase2_slice(seed: int, profile: bool):
    import contextlib

    import torch

    from volcanosv_tpu_torch import cli
    from volcanosv_tpu_torch.eval import EvalParams, evaluate_files
    from volcanosv_tpu_torch.ops import banded_align as ba
    from volcanosv_tpu_torch.utils.logging import STAGE_TIMES, stage_report
    d = os.path.join(WORK, "slice")
    t0 = time.perf_counter()
    n_ctg, n_reads = _write_case(d, seed, 10_000_000, 80, 80)
    sim_s = time.perf_counter() - t0
    _log(f"phase 2: simulated 10 Mb, {n_ctg} contigs, {n_reads} reads "
         f"in {sim_s:.1f} s")
    out = os.path.join(d, "out")
    STAGE_TIMES.clear()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profile \
        else contextlib.nullcontext()
    ba.reset_launch_counts()
    t0 = time.perf_counter()
    with prof:
        rc = cli.main(_vc_args(d, out, "cuda"))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"banded_dp": ba.banded_dp.launches,
                "tb_walk": ba.tb_walk.launches}
    dp_shapes = _dp_shapes(ba.banded_dp.shapes)
    walk_shapes = _walk_shapes(ba.tb_walk.shapes)
    if rc != 0:
        raise AssertionError(f"vc-large-indel exited {rc}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    if seed == 0 and launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"launches {launches} != {EXPECTED_LAUNCHES}")
    _log(f"phase 2: vc-large-indel {wall:.1f} s, launches {launches}\n"
         f"phase 2: banded_dp launches by shape {json.dumps(dp_shapes)}\n"
         f"phase 2: tb_walk launches by shape {json.dumps(walk_shapes)}\n"
         + stage_report())
    profile_info = None
    if profile:
        profile_info = _profile_summary(prof, wall)
        _log(f"phase 2: profile {json.dumps(profile_info)}")
    res = evaluate_files(os.path.join(d, "truth.vcf"),
                         os.path.join(out, "volcanosv_large_indel.vcf"),
                         EvalParams(), device=torch.device("cuda"))
    summary = res.summary()
    _log(f"phase 2: eval {json.dumps(summary)}")
    if res.recall < 0.85 or res.precision < 0.85:
        raise AssertionError(f"accuracy gate failed: {summary}")
    stages = {k: round(v[0], 3) for k, v in STAGE_TIMES.items()}
    return launches, dict(wall_s=wall, sim_s=sim_s, eval=summary,
                          stages=stages, launches=launches,
                          banded_dp_shapes=dp_shapes,
                          tb_walk_shapes=walk_shapes, profile=profile_info)


def _dp_shapes(shapes) -> list[dict]:
    """banded_dp launches by (mode, design, B, M, W), with their count."""
    from collections import Counter
    return [dict(mode=m, branch=br, B=B, M=M, W=W, count=n)
            for (m, br, B, M, W), n in Counter(map(tuple, shapes)).items()]


def _walk_shapes(shapes) -> list[dict]:
    """tb_walk launches by (design, B, M, W), with their count."""
    from collections import Counter
    return [dict(branch=br, B=B, M=M, W=W, count=n)
            for (br, B, M, W), n in Counter(map(tuple, shapes)).items()]


def phase2b_eval_alt() -> dict:
    """The port's `eval` of phase 2's calls against the sequence-resolved
    truth: the ALT-sequence gate (pctsim) sends every INS pair through
    edit_sim_batch, one launch per length bucket (W = 128 ... 2048).  Run on
    the card and on the CPU (the plain DP); the results must be equal and
    the group design must have launched (W > 512)."""
    import torch

    from volcanosv_tpu_torch.eval import EvalParams, evaluate_files
    from volcanosv_tpu_torch.ops import banded_align as ba
    d = os.path.join(WORK, "slice")
    files = (os.path.join(d, "truth_seq.vcf"),
             os.path.join(d, "out", "volcanosv_large_indel.vcf"))
    ba.reset_launch_counts()
    t0 = time.perf_counter()
    res = evaluate_files(*files, EvalParams(), device=torch.device("cuda"))
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    shapes = _dp_shapes(ba.banded_dp.shapes)
    launches = {"banded_dp": ba.banded_dp.launches,
                "group": sum(r["count"] for r in shapes
                             if r["branch"] == "group")}
    t0 = time.perf_counter()
    res_cpu = evaluate_files(*files, EvalParams(), device="cpu")
    cpu_s = time.perf_counter() - t0
    info = dict(eval=res.summary(), launches=launches,
                banded_dp_shapes=shapes, cuda_s=cuda_s, cpu_s=cpu_s)
    _log(f"phase 2b: eval with ALT sequences {json.dumps(info)}")
    if (res.summary(), res.matches) != (res_cpu.summary(), res_cpu.matches):
        raise AssertionError(f"phase 2b: cuda eval {res.summary()} != cpu "
                             f"eval {res_cpu.summary()}")
    if launches["group"] <= 0:
        raise AssertionError("phase 2b: no banded_dp launch at W > 512")
    if res.recall < 0.85 or res.precision < 0.85:
        raise AssertionError(f"phase 2b: accuracy gate failed: {info}")
    return info


def phase3_cuda_vs_cpu(seed: int) -> None:
    from volcanosv_tpu_torch import cli
    d = os.path.join(WORK, "cuda_vs_cpu")
    _write_case(d, seed + 1, 200_000, 4, 4)
    vcfs = []
    for device in ("cuda", "cpu"):
        out = os.path.join(d, f"out_{device}")
        t0 = time.perf_counter()
        if cli.main(_vc_args(d, out, device)) != 0:
            raise AssertionError(f"vc-large-indel --device {device} failed")
        _log(f"phase 3: --device {device} {time.perf_counter() - t0:.1f} s")
        with open(os.path.join(out, "volcanosv_large_indel.vcf"), "rb") as fh:
            vcfs.append(fh.read())
    if vcfs[0] != vcfs[1] or not vcfs[0]:
        raise AssertionError("phase 3: cuda and cpu VCFs differ")
    _log(f"phase 3: VCFs byte-identical ({len(vcfs[0])} bytes)")


# The asm path's torch-op device functions (the JAX package's jitted XLA
# code): module of the call site, attribute, and which call's inputs phase
# 4b keeps (None: the first).
WATCHED = (("phasing.realign", "_viterbi_batch", None),
           ("phasing.phase", "_mec_phase",
            lambda args: args[0].numel()),       # the most observations
           ("partition.partition", "kmer_hashes",
            lambda args: args[0].shape[0] == 1 and args[0].numel()),
           ("partition.partition", "count_kmers_dense", None),
           ("partition.partition", "unique_mask", None),
           ("partition.partition", "distinct_runs", None),
           ("partition.partition", "overlap_scores", None))
# operations of one pair-HMM cell (phasing/realign.py::_viterbi_batch), the
# least the recurrence needs: the match compare and the emission's select
# (2); M: three transitions, their two maxes and the emission's add (6); I:
# two transitions, their max and the insert emission (4); D: the column
# offset, the running max and two adds (4).
VITERBI_OPS_PER_CELL = 16


def _watch(calls: dict, kept: dict):
    """Wrap each WATCHED function where the path calls it: count its calls
    and keep the inputs of one call.  Returns the undo."""
    import importlib
    undo = []
    for mod_name, attr, key in WATCHED:
        mod = importlib.import_module(f"volcanosv_tpu_torch.{mod_name}")
        fn = getattr(mod, attr)

        def wrapper(*args, _fn=fn, _attr=attr, _key=key, **kw):
            calls[_attr] = calls.get(_attr, 0) + 1
            old = kept.get(_attr)
            if _key is None and old is None or _key is not None and \
                    _key(args) and (old is None or _key(args) > _key(old[0])):
                kept[_attr] = (args, kw)
            return _fn(*args, **kw)
        setattr(mod, attr, wrapper)
        undo.append((mod, attr, fn))
    return lambda: [setattr(m, a, f) for m, a, f in undo]


def _write_asm_case(d: str, seed: int, length: int, n_del: int, n_ins: int,
                    coverage: float, read_len: int):
    """Simulate one chromosome as the `sim` subcommand does (SVs, then het
    and hom SNPs at 1/1500 off the SVs, then reads at error 0.001) and
    write ref, reads and the truth VCFs under d."""
    import numpy as np

    from volcanosv_tpu_torch import sim
    from volcanosv_tpu_torch.io.fasta import write_fasta
    from volcanosv_tpu_torch.io.fastq import write_fastq
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    ref = sim.random_genome(rng, length)
    hap1, hap2, truth = sim.implant_svs(rng, ref, n_del=n_del, n_ins=n_ins,
                                        min_len=50, max_len=2000)
    hap1, hap2, _ = sim.implant_snps_ref(rng, ref, hap1, hap2, truth)
    reads = sim.simulate_reads(rng, {1: hap1, 2: hap2}, coverage=coverage,
                               read_len=read_len)
    write_fasta(os.path.join(d, "ref.fa"), ref)
    write_fastq(os.path.join(d, "reads.fastq"),
                ((n, s, None) for n, s, *_ in reads))
    _write_truth(d, ref, truth)
    return len(reads)


def phase4_asm(seed: int, profile: bool):
    """`asm --device cuda` on 2 Mb at 30x, then `vc-large-indel --device
    cuda` on its contigs and `eval`.  Returns the summary and the inputs
    kept of the torch-op device functions."""
    import contextlib

    import torch

    from volcanosv_tpu_torch import cli
    from volcanosv_tpu_torch.eval import EvalParams, evaluate_files
    from volcanosv_tpu_torch.ops import banded_align as ba
    from volcanosv_tpu_torch.utils.logging import STAGE_TIMES, stage_report
    d = os.path.join(WORK, "asm")
    t0 = time.perf_counter()
    n_reads = _write_asm_case(d, seed + 4, 2_000_000, 20, 20, 30.0, 9_000)
    sim_s = time.perf_counter() - t0
    _log(f"phase 4: simulated 2 Mb, {n_reads} reads in {sim_s:.1f} s")
    out = os.path.join(d, "out")
    calls, kept = {}, {}
    undo = _watch(calls, kept)
    STAGE_TIMES.clear()
    ba.reset_launch_counts()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profile \
        else contextlib.nullcontext()
    t0 = time.perf_counter()
    try:
        with prof:
            rc = cli.main(_asm_args(d, out, "cuda"))
            torch.cuda.synchronize()
    finally:
        undo()
    asm_s = time.perf_counter() - t0
    launches = {"banded_dp": ba.banded_dp.launches,
                "tb_walk": ba.tb_walk.launches}
    dp_shapes = _dp_shapes(ba.banded_dp.shapes)
    walk_shapes = _walk_shapes(ba.tb_walk.shapes)
    stages = {k: round(v[0], 3) for k, v in STAGE_TIMES.items()}
    if rc != 0:
        raise AssertionError(f"asm exited {rc}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched during asm")
    _log(f"phase 4: asm {asm_s:.1f} s, launches {launches}, torch-op "
         f"device functions called {json.dumps(calls)}\n"
         f"phase 4: banded_dp launches by shape {json.dumps(dp_shapes)}\n"
         f"phase 4: tb_walk launches by shape {json.dumps(walk_shapes)}\n"
         + stage_report())
    profile_info = _profile_summary(prof, asm_s) if profile else None
    if profile:
        _log(f"phase 4: profile {json.dumps(profile_info)}")
    with open(os.path.join(out, "final_contigs.fa")) as fh:
        n_ctg = sum(line.startswith(">") for line in fh)
    vc_out = os.path.join(d, "vc")
    t0 = time.perf_counter()
    if cli.main(_vc_args(d, vc_out, "cuda",
                         os.path.join("out", "final_contigs.fa"))) != 0:
        raise AssertionError("vc-large-indel on the asm contigs failed")
    vc_s = time.perf_counter() - t0
    res = evaluate_files(os.path.join(d, "truth.vcf"),
                         os.path.join(vc_out, "volcanosv_large_indel.vcf"),
                         EvalParams(), device=torch.device("cuda"))
    summary = res.summary()
    _log(f"phase 4: {n_ctg} contigs; vc-large-indel {vc_s:.1f} s; eval "
         f"{json.dumps(summary)}")
    if res.recall < 0.8 or res.precision < 0.7:
        raise AssertionError(f"phase 4: accuracy gate failed: {summary}")
    info = dict(asm_s=asm_s, sim_s=sim_s, vc_s=vc_s, reads=n_reads,
                contigs=n_ctg, eval=summary, launches=launches,
                stages=stages, device_function_calls=calls,
                banded_dp_shapes=dp_shapes, tb_walk_shapes=walk_shapes,
                profile=profile_info)
    return info, kept


def _time_calls_ms(fn, runs: int = 5) -> float:
    """Milliseconds per call of a function of many small torch ops on the
    card, the host's launch cost included (that is what the path pays):
    events around `runs` calls after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(runs):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / runs


def _on(x, dev):
    return x.to(dev) if hasattr(x, "to") else x


def _card_vs_cpu(name: str, fn, args, equal, bound: dict) -> dict:
    """fn(*args) on the card and on the CPU: outputs checked by `equal`,
    times on both, the bound beside them."""
    import torch
    args_cpu = [_on(a, "cpu") for a in args]
    t0 = time.perf_counter()
    want = fn(*args_cpu)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    got = fn(*args)
    torch.cuda.synchronize()
    if not equal(got, want):
        raise AssertionError(f"phase 4b: {name} on the card != on the CPU")
    ms = _time_calls_ms(lambda: fn(*args))
    row = dict(name=name, ms=ms, cpu_ms=cpu_ms,
               share_of_bound=bound["bound_ms"] / ms, **bound)
    _log(f"phase 4b: {json.dumps(row)}")
    return row


def _viterbi_pairs(rng, B: int, R: int, W: int, err: float):
    """Read segments drawn from their hap windows with substitutions at
    rate `err` and deletions at `err / 2` (some padded, some empty), N codes
    sprinkled in the windows; tests/torch_inputs.py::viterbi_pairs, copied
    since the smoke run imports no tests."""
    import numpy as np
    haps = rng.integers(0, 4, (B, W)).astype(np.int8)
    haps[rng.random((B, W)) < 0.01] = 4
    segs = np.full((B, R), 4, np.int8)
    lens = rng.integers(0, R + 1, B).astype(np.int32)
    for b in range(B):
        sg = haps[b, rng.integers(0, 5):][:lens[b]].copy()
        mut = rng.random(len(sg)) < err
        sg[mut] = rng.integers(0, 4, int(mut.sum()))
        sg = sg[rng.random(len(sg)) > err / 2]
        n = min(len(sg), lens[b])
        segs[b, :n] = sg[:n]
        segs[b, n:lens[b]] = rng.integers(0, 4, lens[b] - n)
    return segs, lens, haps


def _equal_tensors(got, want) -> bool:
    import torch
    if isinstance(want, torch.Tensor):
        got, want = [got], [want]
    return all(g.dtype == w.dtype and torch.equal(g.cpu(), w)
               for g, w in zip(got, want))


def _asm_cuda_vs_cpu(d: str, dtype: str, err: float) -> dict:
    """`asm -d dtype` on cuda and on cpu on the pipeline test's recipe (80
    kb, 24x, 7 kb reads, seed 21) with substitutions at `err` and indels at
    `err / 2`: the four outputs must be byte-identical.  Returns the times,
    the stage times, the output sizes and the torch-op device functions'
    calls on the card."""
    import numpy as np

    from volcanosv_tpu_torch import cli, sim
    from volcanosv_tpu_torch.io.fasta import write_fasta
    from volcanosv_tpu_torch.io.fastq import write_fastq
    from volcanosv_tpu_torch.utils.logging import STAGE_TIMES
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(21)        # tests/test_pipeline_e2e.py
    ref = sim.random_genome(rng, 80_000)
    hap1, hap2, _truth = sim.implant_svs(rng, ref, n_del=3, n_ins=3,
                                         min_len=60, max_len=250,
                                         min_gap=4_000)
    hap1, hap2, _ = sim.implant_snps(rng, hap1, hap2, rate=1 / 1200)
    reads = sim.simulate_reads(rng, {1: hap1, 2: hap2}, coverage=24.0,
                               read_len=7_000, read_len_sd=900,
                               sub_rate=err, indel_rate=err / 2)
    write_fasta(os.path.join(d, "ref.fa"), ref)
    write_fastq(os.path.join(d, "reads.fastq"),
                ((n, s, None) for n, s, *_ in reads))
    outs, secs, calls, stages = {}, {}, {}, {}
    for device in ("cuda", "cpu"):
        out = os.path.join(d, f"out_{device}")
        undo = _watch(calls, {}) if device == "cuda" else (lambda: None)
        STAGE_TIMES.clear()
        t0 = time.perf_counter()
        try:
            rc = cli.main(_asm_args(d, out, device) + ["-d", dtype])
        finally:
            undo()
        if rc != 0:
            raise AssertionError(f"asm -d {dtype} --device {device} failed")
        secs[device] = time.perf_counter() - t0
        stages[device] = {k: round(v[0], 3) for k, v in STAGE_TIMES.items()}
        outs[device] = {}
        for name in ("final_contigs.fa", "phased_snps.vcf",
                     os.path.join("checkpoints", "read_hp_chr1.tsv"),
                     "phased.bam"):
            with open(os.path.join(out, name), "rb") as fh:
                outs[device][name] = fh.read()
    for name, want in outs["cpu"].items():
        if outs["cuda"][name] != want or not want:
            raise AssertionError(f"phase 4b: asm -d {dtype} {name} differs "
                                 "between cuda and cpu")
    info = dict(dtype=dtype, err=err, asm_s=secs, stages=stages,
                bytes={n: len(b) for n, b in outs["cpu"].items()},
                device_function_calls=calls)
    _log(f"phase 4b: asm outputs byte-identical on cuda and cpu "
         f"{json.dumps(info)}")
    return info


def phase4b_asm_cuda_vs_cpu(seed: int, kept: dict) -> dict:
    """`asm` on cuda and cpu (byte-identical outputs), HiFi and CLR, then
    each torch-op device function of the path, card against CPU, timed
    beside its bound."""
    import math

    import numpy as np
    import torch

    from volcanosv_tpu_torch.ops import kmer
    from volcanosv_tpu_torch.phasing import phase, realign
    info = dict(hifi=_asm_cuda_vs_cpu(os.path.join(WORK, "asm_cuda_vs_cpu"),
                                      "Hifi", 0.001))
    # CLR (13.5% total error) realigns every candidate site through the
    # pair-HMM (PhasingConfig.realign_all): the chain pileup -> Viterbi ->
    # allele call -> MEC -> partition -> assembly, card against CPU
    info["clr"] = _asm_cuda_vs_cpu(os.path.join(WORK, "asm_clr_cuda_vs_cpu"),
                                   "CLR", 0.09)
    if info["clr"]["device_function_calls"].get("_viterbi_batch", 0) <= 0:
        raise AssertionError("phase 4b: asm -d CLR never called the "
                             "pair-HMM Viterbi on the card")

    dev = torch.device("cuda")
    rows = []
    B, R, W = 8192, 57, 41
    for err in (0.002, 0.1):
        segs, lens, haps = _viterbi_pairs(np.random.default_rng(seed), B, R,
                                          W, err)
        p = realign.PairHmmParams(err)
        kw = dict(W=W, log_match=p.log_match, log_mis=p.log_mis,
                  log_ins=p.log_ins, a_mm=p.a_mm, a_gap=p.a_gap,
                  a_ext=p.a_ext, a_back=p.a_back)
        cells = int(lens.sum()) * W
        bound = _bound(B * (R + W + 8),
                       cells * VITERBI_OPS_PER_CELL + 2 * B * W,
                       FP32_OPS_PER_S)
        rows.append(dict(_card_vs_cpu(
            f"_viterbi_batch err={err}",
            lambda *a: realign._viterbi_batch(*a, **kw),
            [torch.from_numpy(x).to(dev) for x in (segs, lens, haps)],
            lambda g, w: np.array_equal(g.cpu().numpy().view(np.int32),
                                        w.numpy().view(np.int32)),
            bound), B=B, R=R, W=W, bound_type="fp32"))

    args, kw = kept["_mec_phase"]
    obs_read, obs_snp, obs_allele, h0 = args
    n_obs, (n_restarts, S) = obs_read.numel(), h0.shape
    n_reads, n_iter = kw["n_reads"], kw["n_iter"]
    # per restart: each iteration two votes (a multiply and an add an
    # observation each) and two signs (a compare and a select a read or a
    # SNP); then the last read vote and sign, and the MEC (two multiplies,
    # two compares, an and, an add an observation)
    ops = n_restarts * (n_iter * (4 * n_obs + 2 * (n_reads + S))
                        + 2 * n_obs + 2 * n_reads + 6 * n_obs)
    n_bytes = sum(a.numel() * a.element_size() for a in args) \
        + 4 * (S + n_reads + 1)
    rows.append(dict(_card_vs_cpu(
        "_mec_phase", lambda *a: phase._mec_phase(*a, **kw), list(args),
        _equal_tensors, _bound(n_bytes, ops)),
        obs=n_obs, restarts=n_restarts, snps=S, reads=n_reads,
        n_iter=n_iter))

    (codes, k), _ = kept["kmer_hashes"]
    n = codes.shape[1] - k + 1
    rows.append(dict(_card_vs_cpu(
        "kmer_hashes + count_kmers_dense",
        lambda c: kmer.count_kmers_dense(*kmer.kmer_hashes(c, k), k),
        [codes], _equal_tensors,
        # per window: k steps of a shift, an and, an or, a compare and an
        # or, then the bounds test, the weight and the add (4); codes in,
        # the 4^k table out
        _bound(codes.numel() + 4 * 4**k, n * (5 * k + 4))),
        codes=int(codes.numel()), k=k))
    (tables,), _ = kept["unique_mask"]
    rows.append(dict(_card_vs_cpu(
        "unique_mask", kmer.unique_mask, [tables], _equal_tensors,
        # per entry: the presence compare, its add into the count, the
        # count compare and the and
        _bound(tables.numel() * 5, tables.numel() * 4)),
        tables=list(tables.shape)))
    (h, v), _ = kept["distinct_runs"]
    (_s, _f, _r, t4, u4), _ = kept["overlap_scores"]
    Bk, nk = h.shape
    s_, first, _run = kmer.distinct_runs(h, v)
    n_distinct = int(first.sum())
    H = t4.shape[0]
    # the sort's compares (n log2 n a row), the first-occurrence and run
    # length passes (8 an entry), and per distinct k-mer and table the
    # gathered count and flag (5 bytes) and the select and add (3)
    ops = Bk * nk * math.ceil(math.log2(nk)) + 8 * Bk * nk \
        + 3 * H * n_distinct
    n_bytes = 5 * Bk * nk + 5 * H * n_distinct + 4 * Bk * H
    rows.append(dict(_card_vs_cpu(
        "distinct_runs + overlap_scores",
        lambda hh, vv, tt, uu: kmer.overlap_scores(
            *kmer.distinct_runs(hh, vv), tt, uu),
        [h, v, t4, u4], _equal_tensors, _bound(n_bytes, ops)),
        B=Bk, n=nk, distinct=n_distinct, tables=H))
    info["device_functions"] = rows
    return info


# tests/test_golden_e2e.py's SIM_ARGS (copied: the smoke run imports no
# tests): 4 x 250 kb, every SV type, a translocation, small indels, HiFi
# reads at 30x, 9 kb
GOLDEN_SIM = ["--length", "250000", "--chroms", "4",
              "--n_del", "12", "--n_ins", "12", "--n_inv", "4", "--n_dup", "4",
              "--n_clustered", "5", "--n_nested", "4", "--n_small", "10",
              "--n_tra", "1", "--coverage", "30", "--read_len", "9000",
              "--seed", "42"]
GOLDEN_TRUTH = os.path.join(REPO, "tests", "data", "golden_truth.vcf")
# tests/test_torch_run.py's recipe: 2 x 50 kb with an INV, a DUP, a
# translocation and small indels, so every caller writes records
RUN_SIM = ["--length", "50000", "--chroms", "2", "--n_del", "2",
           "--n_ins", "2", "--n_inv", "1", "--n_dup", "1", "--n_small", "4",
           "--n_tra", "1", "--min_len", "300", "--max_len", "1000",
           "--coverage", "20", "--read_len", "7000", "--seed", "3"]
RUN_OUT = ["volcanosv_variants.vcf", "volcanosv_large_indel.vcf",
           "volcanosv_small_indel.vcf", "volcanosv_complex_sv.vcf",
           "final_contigs.fa", "phased_snps.vcf"]
# the pairing's edit distances: EDIT score-only at W = 128 (clip_to = 10)
PAIRING_MODE, PAIRING_W = "edit+score", 128


def _run_args(d: str, out: str, device: str) -> list[str]:
    return ["run", "--ref", os.path.join(d, "ref.fa"),
            "--fastq", os.path.join(d, "reads.fastq"),
            "-o", out, "--device", device]


def _watch_complex(shapes: list):
    """Wrap call_complex_svs, where `run` calls it: `shapes` receives the
    banded_dp launches made inside it.  Returns the undo."""
    from volcanosv_tpu_torch.ops import banded_align as ba
    from volcanosv_tpu_torch.vc import complex_sv
    fn = complex_sv.call_complex_svs

    def wrapper(*args, **kw):
        n0 = len(ba.banded_dp.shapes)
        try:
            return fn(*args, **kw)
        finally:
            shapes.extend(ba.banded_dp.shapes[n0:])
    complex_sv.call_complex_svs = wrapper
    return lambda: setattr(complex_sv, "call_complex_svs", fn)


def _golden_gates(sim_dir: str, out: str, device: str = "cuda") -> dict:
    """tests/test_golden_e2e.py's gates on `run`'s outputs, through the
    port's eval: SVs (F1, recall >= 0.99, GT >= 0.98), small indels,
    SNPs and switch error, the cross-chromosome BND pair."""
    from volcanosv_tpu_torch.eval import (EvalParams, evaluate_files,
                                          evaluate_snp_files)
    from volcanosv_tpu_torch.io.vcf import read_vcf
    dev = device
    truth = os.path.join(sim_dir, "truth.vcf")
    sv = evaluate_files(truth, os.path.join(out, "volcanosv_variants.vcf"),
                        device=dev)
    small = evaluate_files(truth,
                           os.path.join(out, "volcanosv_small_indel.vcf"),
                           EvalParams(minsize=2, maxsize=29, pctsim=0.0),
                           device=dev)
    snp = evaluate_snp_files(os.path.join(sim_dir, "truth_snps.vcf"),
                             os.path.join(out, "phased_snps.vcf"))
    _h, t_recs = read_vcf(truth)
    _h, calls = read_vcf(os.path.join(out, "volcanosv_variants.vcf"))
    t_bnds = [r for r in t_recs if r.svtype == "BND"]
    c_bnds = [r for r in calls if r.svtype == "BND"]
    by_id = {r.id: r for r in c_bnds}
    matched, bad = 0, []
    for t in t_bnds:
        for c in c_bnds:
            if (c.chrom == t.chrom and abs(c.pos - t.pos) <= 200
                    and str(c.info.get("CHR2")) == str(t.info.get("CHR2"))):
                mate = by_id.get(c.info.get("MATEID"))
                if c.gt != "1|1" or mate is None \
                        or mate.info.get("MATEID") != c.id:
                    bad.append(c.id)        # a 1|1 reciprocal pair, or fail
                matched += 1
                break
    gates = dict(sv=sv.summary(), small_indel=small.summary(), snp=snp,
                 bnd=dict(truth=len(t_bnds), called=len(c_bnds),
                          matched=matched, bad=bad))
    failed = [name for name, ok in (
        ("sv f1", sv.f1 >= 0.99), ("sv recall", sv.recall >= 0.99),
        ("sv gt", sv.gt_concordance >= 0.98),
        ("small recall", small.recall >= 0.93),
        ("small precision", small.precision >= 0.95),
        ("small gt", small.gt_concordance >= 0.90),
        ("snp recall", snp["snp_recall"] >= 0.95),
        ("snp precision", snp["snp_precision"] >= 0.95),
        ("snp zygosity", snp["zygosity_concordance"] >= 0.95),
        ("switch error", snp["switch_error_rate"] <= 0.02),
        ("bnd", bool(t_bnds) and bool(c_bnds) and not bad
         and matched >= len(t_bnds) // 2))
        if not ok]
    if failed:
        raise AssertionError(f"phase 5: golden gates failed {failed}: "
                             f"{json.dumps(gates)}")
    return gates


def phase5_run_golden(profile: bool) -> dict:
    """`sim` with the golden recipe (its truth must be the pinned
    tests/data/golden_truth.vcf), `run --device cuda`, the golden gates;
    stage times, the DP launches by shape and those of the complex-SV
    stage, which must include the pairing's W = 128."""
    import contextlib

    import torch

    from volcanosv_tpu_torch import cli
    from volcanosv_tpu_torch.ops import banded_align as ba
    from volcanosv_tpu_torch.utils.logging import STAGE_TIMES, stage_report
    d = os.path.join(WORK, "golden")
    sim_dir, out = os.path.join(d, "sim"), os.path.join(d, "out")
    t0 = time.perf_counter()
    if cli.main(["sim", "-o", sim_dir] + GOLDEN_SIM) != 0:
        raise AssertionError("phase 5: sim failed")
    sim_s = time.perf_counter() - t0
    with open(os.path.join(sim_dir, "truth.vcf"), "rb") as a, \
            open(GOLDEN_TRUTH, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("phase 5: the sim's truth.vcf differs from "
                                 "tests/data/golden_truth.vcf")
    complex_shapes = []
    undo = _watch_complex(complex_shapes)
    STAGE_TIMES.clear()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profile \
        else contextlib.nullcontext()
    ba.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with prof:
            rc = cli.main(_run_args(sim_dir, out, "cuda"))
            torch.cuda.synchronize()
    finally:
        undo()
    run_s = time.perf_counter() - t0
    launches = {"banded_dp": ba.banded_dp.launches,
                "tb_walk": ba.tb_walk.launches}
    dp_shapes = _dp_shapes(ba.banded_dp.shapes)
    walk_shapes = _walk_shapes(ba.tb_walk.shapes)
    cx_shapes = _dp_shapes(complex_shapes)
    stages = {k: round(v[0], 3) for k, v in STAGE_TIMES.items()}
    if rc != 0:
        raise AssertionError(f"phase 5: run exited {rc}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"phase 5: {name} never launched in run")
    pairing = [r for r in cx_shapes
               if r["mode"] == PAIRING_MODE and r["W"] == PAIRING_W]
    if not pairing:
        raise AssertionError(f"phase 5: no banded_dp launch at W = "
                             f"{PAIRING_W} inside complex-sv: {cx_shapes}")
    _log(f"phase 5: run {run_s:.1f} s, launches {launches}\n"
         f"phase 5: banded_dp launches by shape {json.dumps(dp_shapes)}\n"
         f"phase 5: tb_walk launches by shape {json.dumps(walk_shapes)}\n"
         f"phase 5: banded_dp launches inside complex-sv "
         f"{json.dumps(cx_shapes)}\n" + stage_report())
    profile_info = _profile_summary(prof, run_s) if profile else None
    if profile:
        _log(f"phase 5: profile {json.dumps(profile_info)}")
    gates = _golden_gates(sim_dir, out)
    _log(f"phase 5: golden gates passed {json.dumps(gates)}")
    return dict(run_s=run_s, sim_s=sim_s, stages=stages, launches=launches,
                banded_dp_shapes=dp_shapes, tb_walk_shapes=walk_shapes,
                complex_sv_shapes=cx_shapes,
                pairing_launches=sum(r["count"] for r in pairing),
                gates=gates, profile=profile_info)


def phase5b_run_cuda_vs_cpu() -> dict:
    """`run` with --device cuda and --device cpu on the 2 x 50 kb recipe:
    the six outputs and phased.bam byte-identical.  Nothing is caught."""
    from volcanosv_tpu_torch import cli
    from volcanosv_tpu_torch.utils.logging import STAGE_TIMES
    d = os.path.join(WORK, "run_cuda_vs_cpu")
    if cli.main(["sim", "-o", os.path.join(d, "sim")] + RUN_SIM) != 0:
        raise AssertionError("phase 5b: sim failed")
    outs, secs, stages = {}, {}, {}
    for device in ("cuda", "cpu"):
        out = os.path.join(d, f"out_{device}")
        STAGE_TIMES.clear()
        t0 = time.perf_counter()
        if cli.main(_run_args(os.path.join(d, "sim"), out, device)) != 0:
            raise AssertionError(f"phase 5b: run --device {device} failed")
        secs[device] = time.perf_counter() - t0
        stages[device] = {k: round(v[0], 3) for k, v in STAGE_TIMES.items()}
        outs[device] = {}
        for name in RUN_OUT + ["phased.bam"]:
            with open(os.path.join(out, name), "rb") as fh:
                outs[device][name] = fh.read()
    for name, want in outs["cpu"].items():
        if outs["cuda"][name] != want or not want:
            raise AssertionError(f"phase 5b: {name} differs between cuda "
                                 "and cpu")
    merged = outs["cpu"]["volcanosv_variants.vcf"]
    for tag in (b"<INV>", b"<DUP>", b"SVTYPE=BND", b"-INS-", b"-DEL-"):
        if tag not in merged:
            raise AssertionError(f"phase 5b: no {tag!r} record in run")
    info = dict(run_s=secs, stages=stages,
                bytes={n: len(b) for n, b in outs["cpu"].items()})
    _log(f"phase 5b: run outputs byte-identical on cuda and cpu "
         f"{json.dumps(info)}")
    return info


# the coverage HMM at chromosome scale: the two haplotypes of a 250 Mb
# chromosome at window 1000 (500,000 windows), assembled into contigs of
# 120 kb - 5 Mb; the states drawn as runs (err, dup, hap, collapsed), the
# coverage Poisson around 15x haploid (HiFi at 30x) with gamma-distributed
# overdispersion
HMM_CHROM, HMM_WINDOW, HMM_LAM = 250_000_000, 1_000, 15.0
HMM_CONTIG = (120_000, 5_000_000)
# operations of one window of the coverage HMM (qc/flagger.py), the least
# its recursions need, at S states: the emission (a multiply, a subtract, a
# divide and the valid select: 4S); Viterbi: S^2 transitions of two adds and
# a compare, the backtrack's gather (1); forward and backward each: S^2 adds,
# subtracts of the max and exps, and the sums' S^2 adds, then S maxes, logs
# and adds of the max (4S^2 + 3S, and the emission's add: S); the posterior:
# the add and the softmax's max, subtract, exp and divide (5S)


def _hmm_ops(S: int, kind: str) -> int:
    if kind == "viterbi":
        return 4 * S + 3 * S * S + 1
    return 4 * S + 2 * (4 * S * S + 4 * S) + 5 * S


def _coverage_case(seed: int):
    """(cov (B, T) float64, valid (B, T), contig lengths): the padded
    batch evaluate_assembly builds, at chromosome scale."""
    import numpy as np
    rng = np.random.default_rng(seed + 6)
    lens = []
    for _hap in range(2):
        left = HMM_CHROM
        while left > 0:
            n = min(int(rng.integers(HMM_CONTIG[0], HMM_CONTIG[1] + 1)), left)
            if left - n < HMM_CONTIG[0]:
                n = left
            lens.append(n)
            left -= n
    n_win = [-(-n // HMM_WINDOW) for n in lens]
    T = max(n_win)
    cov = np.zeros((len(lens), T))
    valid = np.arange(T)[None, :] < np.asarray(n_win)[:, None]
    mult = np.array([0.05, 0.5, 1.0, 2.0])
    for b, n in enumerate(n_win):
        # runs of ~500 windows: mostly hap, some collapsed, dup and err
        brk = np.flatnonzero(rng.random(n) < 1 / 500)
        seg = rng.choice(4, len(brk) + 1, p=[0.05, 0.1, 0.7, 0.15])
        seg[0] = 2
        state = seg[np.searchsorted(brk, np.arange(n), side="right")]
        cov[b, :n] = rng.poisson(HMM_LAM * mult[state]
                                 * rng.gamma(20.0, 1 / 20.0, n))
    return cov, valid, lens


def _count_kernels(fn):
    """fn() with the launch counts set to 0 first: (its result, the counts
    after, the launches' shapes: banded_dp's (mode, design, B, M, W) and
    tb_walk's (design, B, M, W))."""
    from volcanosv_tpu_torch.ops import banded_align as ba
    ba.reset_launch_counts()
    out = fn()
    return out, {"banded_dp": ba.banded_dp.launches,
                 "tb_walk": ba.tb_walk.launches}, \
        (list(ba.banded_dp.shapes), list(ba.tb_walk.shapes))


def _sd_case():
    """tests/test_sd_recovery.py's recipe with the port's modules: one
    20 kb sequence as both haplotypes' contig, hp2's coverage doubled over
    6-12 kb, every read in both hap groups."""
    import numpy as np

    from volcanosv_tpu_torch.io.bam import BamRecord
    from volcanosv_tpu_torch.sim import random_genome, simulate_reads
    rng = np.random.default_rng(5)
    seq = random_genome(rng, 20_000)["chr1"]
    reads = simulate_reads(rng, {1: {"chr1": seq}}, coverage=14.0,
                           read_len=4_000, read_len_sd=300, sub_rate=0.001,
                           indel_rate=0.0)
    groups = {h: [s for _n, s, *_ in reads]
              for h in ("PS1_1_20000_hp1", "PS1_1_20000_hp2")}
    contigs = {"PS1_1_20000_hp1_0": seq, "PS1_1_20000_hp2_0": seq}
    spans = [(c, s, 3_000) for s in range(0, 18_000, 400) for c in (0, 1)] \
        + [(1, s, 3_000) for s in range(6_000, 12_000, 200)]
    roc = [BamRecord(name=f"r{i}", flag=0, ref_id=c, pos=p, mapq=60,
                     cigar=np.array([[0, n]], np.int64), seq="A" * 4)
           for i, (c, p, n) in enumerate(spans)]
    return contigs, groups, roc


def _cli_cuda_vs_cpu(args, out_dir: str, names: list[str], tag: str):
    """One CLI command with --device cuda and --device cpu into
    out_dir/{cuda,cpu}: the named outputs byte-identical.  Returns the
    seconds on each, the card's launches and their shapes (`_count_kernels`)
    and the output sizes."""
    from volcanosv_tpu_torch import cli
    secs, outs, launches, shapes = {}, {}, None, None
    for device in ("cuda", "cpu"):
        out = os.path.join(out_dir, device)
        t0 = time.perf_counter()
        rc, counts, launched = _count_kernels(
            lambda: cli.main(args + ["-o", out, "--device", device]))
        secs[device] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"phase 6: {tag} --device {device} failed")
        if device == "cuda":
            launches, shapes = counts, launched
        outs[device] = {}
        for name in names:
            with open(os.path.join(out, name), "rb") as fh:
                outs[device][name] = fh.read()
    for name, want in outs["cpu"].items():
        if outs["cuda"][name] != want or not want:
            raise AssertionError(f"phase 6: {tag} {name} differs between "
                                 "cuda and cpu")
    return dict(s=secs, launches=launches, shapes=shapes,
                banded_dp_shapes=_dp_shapes(shapes[0]),
                tb_walk_shapes=_walk_shapes(shapes[1]),
                bytes={n: len(b) for n, b in outs["cpu"].items()})


def _hmm_at_scale(seed: int) -> dict:
    """The coverage HMM at chromosome scale (`_coverage_case`), card
    against CPU: fit_coverage_hmm (the same iterations; λ, τ and means
    within rtol 1e-4), Viterbi labels equal, the card's posteriors no
    further from a float64 forward-backward than twice the CPU's; each
    timed beside its bound."""
    import numpy as np
    import torch

    from volcanosv_tpu_torch.config import PipelineConfig
    from volcanosv_tpu_torch.qc import flagger
    cov, valid, lens = _coverage_case(seed)
    B, T = cov.shape
    cfg = PipelineConfig.for_dtype("Hifi").qc
    S = cfg.n_states
    n_post = []
    post_fn = flagger.CoverageHMM.posteriors
    flagger.CoverageHMM.posteriors = \
        lambda self, *a, **kw: n_post.append(1) or post_fn(self, *a, **kw)
    try:
        t0 = time.perf_counter()
        hmm = flagger.fit_coverage_hmm(cov, valid, cfg, "cpu")
        fit_cpu = time.perf_counter() - t0
        n_iter = len(n_post)
        t0 = time.perf_counter()
        hmm_cuda = flagger.fit_coverage_hmm(cov, valid, cfg, "cuda")
        torch.cuda.synchronize()
        fit_ms = (time.perf_counter() - t0) * 1e3
        n_iter_cuda = len(n_post) - n_iter
    finally:
        flagger.CoverageHMM.posteriors = post_fn
    fit = dict(n_iter=n_iter, n_iter_cuda=n_iter_cuda,
               means=hmm.means.tolist(), means_cuda=hmm_cuda.means.tolist(),
               tau=hmm.tau, tau_cuda=hmm_cuda.tau,
               max_rel=float(np.max(np.abs(hmm_cuda.means / hmm.means - 1))))
    # the fit's λ, τ and means: rtol 1e-4 (the posteriors' rounding, summed
    # over 500,000 windows), with the same number of iterations
    if n_iter != n_iter_cuda or fit["max_rel"] > 1e-4 \
            or abs(hmm_cuda.tau / hmm.tau - 1) > 1e-4:
        raise AssertionError(f"phase 6: fit_coverage_hmm card != CPU "
                             f"{json.dumps(fit)}")
    rows = []
    n_win = B * T
    for kind in ("viterbi", "posteriors"):
        fn = getattr(hmm, kind)
        t0 = time.perf_counter()
        want = fn(cov, valid, "cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        got = fn(cov, valid, "cuda")                     # also the warm-up
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn(cov, valid, "cuda")
        e.record()
        torch.cuda.synchronize()
        ms = s.elapsed_time(e)
        out_bytes = 1 if kind == "viterbi" else 4 * S
        row = dict(name=f"CoverageHMM.{kind}", B=B, T=T, S=S,
                   windows=int(valid.sum()), ms=ms, cpu_ms=cpu_ms,
                   ms_per_window_step=ms / T,
                   **_bound(n_win * (5 + out_bytes), n_win * _hmm_ops(S, kind),
                            FP32_OPS_PER_S))
        row["share_of_bound"] = row["bound_ms"] / ms
        if kind == "viterbi":
            # emissions and transitions are the same bits on both devices
            # and the recursion is adds and maxes: the labels are equal
            if not np.array_equal(got, want):
                raise AssertionError("phase 6: Viterbi labels card != CPU")
            row["labels_equal"] = True
        else:
            # float32 sums of 5000 windows' log likelihoods round at
            # |alpha| x 6e-8, and the card's exp and log round differently
            # from the CPU's: the card is held to the float64
            # forward-backward, at most twice as far from it as the CPU
            exact = flagger.posteriors_float64(hmm, cov, valid)
            cpu_err = float(np.abs(want - exact).max())
            card_err = float(np.abs(got - exact).max())
            row.update(max_abs_err=float(np.abs(got - want).max()),
                       card_vs_f64=card_err, cpu_vs_f64=cpu_err,
                       tolerance=2 * cpu_err)
            if not card_err <= 2 * cpu_err:
                raise AssertionError(f"phase 6: posteriors on the card "
                                     f"further from float64 than twice "
                                     f"the CPU's {json.dumps(row)}")
        rows.append(row)
        _log(f"phase 6: {json.dumps(row)}")
    fit_row = dict(name="fit_coverage_hmm", ms=fit_ms, cpu_ms=fit_cpu * 1e3,
                   **_bound(n_iter * n_win * (5 + 4 * S),
                            n_iter * n_win * _hmm_ops(S, "posteriors"),
                            FP32_OPS_PER_S), **fit)
    fit_row["share_of_bound"] = fit_row["bound_ms"] / fit_ms
    rows.append(fit_row)
    _log(f"phase 6: {json.dumps(fit_row)}")
    return dict(contigs=len(lens), windows=int(valid.sum()), rows=rows)


def _sd_recover_cuda_vs_cpu() -> dict:
    """sd_recover on `_sd_case`, card against CPU: equal contigs, and at
    least one re-assembled contig swapped in."""
    from volcanosv_tpu_torch.config import PipelineConfig
    from volcanosv_tpu_torch.pipeline.sd import sd_recover
    contigs, groups, roc = _sd_case()
    pcfg = PipelineConfig.for_dtype("Hifi")
    got = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        (out, qc), counts, _shapes = _count_kernels(lambda: sd_recover(
            contigs, groups, roc, pcfg, device=device))
        got[device] = (out, qc.collapsed, time.perf_counter() - t0, counts)
    swapped = [c for c, s in got["cpu"][0].items() if s != contigs.get(c)]
    if got["cuda"][:2] != got["cpu"][:2] or not swapped:
        raise AssertionError(f"phase 6: sd_recover card != CPU or no hap "
                             f"swapped ({swapped})")
    info = dict(collapsed=got["cpu"][1], swapped=swapped,
                s={k: v[2] for k, v in got.items()}, launches=got["cuda"][3])
    _log(f"phase 6: sd_recover equal on cuda and cpu {json.dumps(info)}")
    return info


def phase6_qc_sd(seed: int) -> dict:
    """QC and SD recovery on the card: `qc` on phase 4's contigs and reads,
    the coverage HMM at chromosome scale, `sd_recover` and `asm --sd` on
    phase 4b's HiFi case, each on cuda against cpu."""
    info = {}
    d4 = os.path.join(WORK, "asm")
    info["qc"] = _cli_cuda_vs_cpu(
        ["qc", "--ref", os.path.join(d4, "ref.fa"),
         "--contig", os.path.join(d4, "out", "final_contigs.fa"),
         "--fastq", os.path.join(d4, "reads.fastq")],
        os.path.join(WORK, "qc"), ["flagger_blocks.bed"], "qc")
    if info["qc"]["launches"]["banded_dp"] <= 0:
        raise AssertionError("phase 6: qc launched no banded_dp")
    _log(f"phase 6: qc on phase 4's contigs, flagger_blocks.bed "
         f"byte-identical on cuda and cpu {json.dumps(info['qc'])}")
    info["hmm"] = _hmm_at_scale(seed)
    info["sd_recover"] = _sd_recover_cuda_vs_cpu()
    d4b = os.path.join(WORK, "asm_cuda_vs_cpu")
    info["asm_sd"] = _cli_cuda_vs_cpu(
        ["asm", "--sd", "--ref", os.path.join(d4b, "ref.fa"),
         "--fastq", os.path.join(d4b, "reads.fastq")],
        os.path.join(WORK, "asm_sd"), ["final_contigs.fa", "phased_snps.vcf"],
        "asm --sd")
    _log(f"phase 6: asm --sd byte-identical on cuda and cpu "
         f"{json.dumps(info['asm_sd'])}")
    return info


def _step_bound(n: int) -> dict:
    """Bound of one rank's sharded step (parallel/step.py) on the multihost
    module's inputs: the score-only DP of the rank's windows, the k-mer
    table of its queries (5k + 4 operations a window, the 4^k table written
    and all-reduced: read and written again), the stats."""
    import numpy as np

    from volcanosv_tpu_torch.parallel import multihost
    q, t, ql, tl = multihost.step_inputs(n)
    B = len(q) // n
    k, W, d_lo = (multihost.STEP[x] for x in ("k", "W", "d_lo"))
    dp = _dp_bound(ql[:B], tl[:B], q.shape[1], W, d_lo, "affine", False,
                   False)
    windows = int(np.maximum(ql[:B] - k + 1, 0).sum())
    table = 4 * 4**k
    return dict(B=B, M=q.shape[1], W=W, k=k, ranks=n, **_bound(
        dp["bytes"] + 3 * table + 12 * n,
        dp["ops"] + windows * (5 * k + 4) + table))


def _mesh_split_check(seed: int) -> dict:
    """The aligner's DP batch split over an in-process mesh of two devices
    (here the one card twice: one DP and one walk launch each), against
    the unsplit call on the card and the plain versions on the CPU: the
    same CIGARs."""
    import numpy as np

    from volcanosv_tpu_torch.ops import banded_align as ba
    from volcanosv_tpu_torch.parallel.mesh import make_mesh, set_active_mesh
    q, t, qlen, tlen = _pairs(np.random.default_rng(seed + 7), 256, 512,
                              128, -64)
    args = dict(W=128, d_lo=-64)
    want = ba.banded_align_cigars(q, t, qlen, tlen, device="cpu", **args)
    unsplit = ba.banded_align_cigars(q, t, qlen, tlen, device="cuda", **args)
    set_active_mesh(make_mesh(devices=["cuda:0", "cuda:0"]))
    try:
        split, launches, _shapes = _count_kernels(lambda: ba.banded_align_cigars(
            q, t, qlen, tlen, device="cuda", **args))
    finally:
        set_active_mesh(None)
    if not split == unsplit == want or launches != {"banded_dp": 2,
                                                    "tb_walk": 2}:
        raise AssertionError(f"phase 7: the mesh split's CIGARs differ or "
                             f"it launched {launches}")
    return dict(B=len(q), M=q.shape[1], launches=launches)


def phase7_two_ranks(seed: int) -> dict:
    """Two ranks of one process group on the one card
    (`python -m volcanosv_tpu_torch.parallel.multihost`): `run` on phase 5's
    golden sim against phase 5's one-process outputs, the three vc drivers
    on phase 5b's recipe against one rank, the sharded step against one
    rank; then the in-process mesh's DP split (`_mesh_split_check`)."""
    d = os.path.join(WORK, "multihost")
    out = os.path.join(d, "multihost.json")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "volcanosv_tpu_torch.parallel.multihost",
         "--n", "2", "--device", "cuda", "--work", d,
         "--sim_dir", os.path.join(WORK, "run_cuda_vs_cpu", "sim"),
         "--full", "--run_sim_dir", os.path.join(WORK, "golden", "sim"),
         "--run_reference", os.path.join(WORK, "golden", "out"),
         "--out", out, "--timeout", "600"],
        cwd=REPO, capture_output=True, text=True, timeout=700)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"phase 7: two ranks failed (exit "
                             f"{r.returncode}):\n{r.stderr[-4000:]}")
    with open(out) as fh:
        res = json.load(fh)
    ranks = [dict(rank=row["rank"], device=row["device"],
                  backend=row["backend"],
                  own_chroms={"vc": row["own_sim_chroms"],
                              "run": row["own_run_chroms"]},
                  wall_s=row["wall_s"], seconds=row["seconds"],
                  step_s=row["step_s"], launches=row["launches"],
                  run_collectives=row["run_collectives"],
                  run_banded_dp_shapes=_dp_shapes(
                      row["run_shapes"]["banded_dp"]),
                  run_tb_walk_shapes=_walk_shapes(
                      row["run_shapes"]["tb_walk"]))
             for row in res["rows"]]
    for row in ranks:
        for path, counts in row["launches"].items():
            if min(counts.values()) <= 0:
                raise AssertionError(f"phase 7: rank {row['rank']} launched "
                                     f"no kernel in {path}: {counts}")
    info = dict(wall_s=wall, ranks=ranks, single_s=res["single_s"],
                run_shapes=[sum((row["run_shapes"][k] for row in res["rows"]),
                                []) for k in ("banded_dp", "tb_walk")],
                step=_step_bound(res["n_processes"]),
                mesh_split=_mesh_split_check(seed),
                ranks_s=res["ranks_s"], run_identical=res["run_identical"],
                vc_identical={k: res[k] for k in (
                    "large_vcf_identical", "small_vcf_identical",
                    "complex_vcf_identical")},
                step_identical=res["step_identical"])
    _log(f"phase 7: two ranks on one card, outputs = one process's "
         f"{json.dumps(info)}")
    return info


def _check_top_shape(rng, smem: dict, top: dict):
    """Phase 1's check (`_check_case`) at a launch shape it does not hold:
    banded_dp's (mode, design, B, M, W), or tb_walk's (design, B, M, W)
    checked on an affine traceback DP.  The mode names the scores' kind
    (edit, affine: asm5, dual-affine: asm20) and the DP flags; the band
    sits at d_lo = -W/2.  Returns (DP row, walk row or None)."""
    from volcanosv_tpu_torch.ops import banded_align as ba
    mode = top.get("mode", "affine+traceback")
    kind, *flags = mode.split("+")
    sc = {"edit": ba.Scores.edit(), "affine": _scores_of("asm5"),
          "dual-affine": _scores_of("asm20")}[kind]
    kw = dict(with_traceback="traceback" in flags,
              row0_scores="row0" in flags, free_t_end="free_t_end" in flags,
              free_t_start="free_t_start" in flags)
    B, M, W = top["B"], top["M"], top["W"]
    if ba.dp_mode(sc, **kw) != mode or (
            "mode" in top and ba.banded_dp_branch(W) != top["branch"]):
        raise AssertionError(f"no phase-1 case reproduces {top}")
    return _check_case(rng, smem, f"top shape {mode}", B, M, W, -(W // 2),
                       sc, kw, False)


def _row_at_top_shape(rows: list[dict], shapes: list[dict],
                      check=None) -> dict:
    """The phase-1 row at the launch a path made most often: the same
    (mode, design, B, M, W) for banded_dp, (design, B, M, W) for tb_walk.
    Where phase 1 holds no such row, check(top) checks that shape and
    returns its row (without `check`: raises)."""
    top = max(shapes, key=lambda r: r["count"])
    keys = [k for k in ("mode", "branch", "B", "M", "W") if k in top]
    for r in rows:
        if all(r[k] == top[k] for k in keys):
            return r
    if check is None:
        raise AssertionError(f"phase 1 checks no shape the path launched "
                             f"most: {top}")
    return check(top)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace phases 2, 4 and 5 with torch.profiler and "
                         "print the device time by kernel")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        _log("chip_smoke: no CUDA device")
        return 2
    sys.path.insert(0, REPO)
    from volcanosv_tpu_torch import native
    from volcanosv_tpu_torch.ops import cuda_build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    shutil.rmtree(WORK, ignore_errors=True)
    t_start = time.perf_counter()
    # the C++ host helpers (g++) build beside the kernels (nvcc), so that
    # phase 2's stage times hold the path and not the compiler
    with ThreadPoolExecutor(1) as pool:
        host_lib = pool.submit(native.get_lib)
        cuda_build.load_all()
        host_lib.result()             # raises when g++ fails
    _log(f"kernels and host helpers built in "
         f"{time.perf_counter() - t_start:.1f} s "
         f"({cuda_build.build_dir()}) on {smi}")

    info = {}
    dp_rows, walk_rows, smem = phase1_kernels(args.seed)
    launches, info["slice"] = phase2_slice(args.seed, args.profile)
    info["slice"]["eval_alt"] = phase2b_eval_alt()
    phase3_cuda_vs_cpu(args.seed)
    info["asm"], kept = phase4_asm(args.seed, args.profile)
    info["asm_cuda_vs_cpu"] = phase4b_asm_cuda_vs_cpu(args.seed, kept)
    info["run"] = phase5_run_golden(args.profile)
    info["run_cuda_vs_cpu"] = phase5b_run_cuda_vs_cpu()
    info["qc_sd"] = phase6_qc_sd(args.seed)
    info["two_ranks"] = phase7_two_ranks(args.seed)
    _log(f"total {time.perf_counter() - t_start:.1f} s")

    # each path's most-launched shapes, checked here where phase 1 holds
    # no row at them (these launches are not the paths' counts)
    rng = np.random.default_rng(args.seed + 9)

    def check(top):
        row, wrow = _check_top_shape(rng, smem, top)
        dp_rows.append(row)
        if wrow is not None:
            walk_rows.append(wrow)
        return row if "mode" in top else wrow

    asm_dp = _row_at_top_shape(dp_rows, info["asm"]["banded_dp_shapes"],
                               check)
    asm_walk = _row_at_top_shape(walk_rows, info["asm"]["tb_walk_shapes"],
                                 check)
    asm_launches = info["asm"]["launches"]
    pair_dp = _row_at_top_shape(
        dp_rows, [r for r in info["run"]["complex_sv_shapes"]
                  if r["mode"] == PAIRING_MODE and r["W"] == PAIRING_W],
        check)
    # this slice's paths: qc and asm --sd on the card (phase 6), `run`
    # over two ranks (phase 7, summed over the ranks)
    qc_sd = info["qc_sd"]
    paths = {
        "qc": ("qc and asm --sd",
               {k: qc_sd["qc"]["launches"][k] + qc_sd["asm_sd"]["launches"][k]
                for k in ("banded_dp", "tb_walk")},
               [qc_sd["qc"]["shapes"][i] + qc_sd["asm_sd"]["shapes"][i]
                for i in range(2)]),
        "ranks": ("run over two ranks",
                  {k: sum(r["launches"]["run"][k]
                          for r in info["two_ranks"]["ranks"])
                   for k in ("banded_dp", "tb_walk")},
                  info["two_ranks"]["run_shapes"]),
    }
    path_rows = {tag: (_row_at_top_shape(dp_rows, _dp_shapes(dp), check),
                       _row_at_top_shape(walk_rows, _walk_shapes(walk),
                                         check))
                 for tag, (_p, _n, (dp, walk)) in paths.items()}
    _log(f"top shapes of qc/asm --sd and of the two ranks' run: "
         f"{json.dumps(path_rows)}")

    warp_rows = [r for r in dp_rows if r["branch"] == "warp"]
    group_rows = [r for r in dp_rows if r["branch"] == "group"]
    # heads: traceback B=4096 M=256 W=256; edit B=1024 M=4096 W=4096; the
    # asm path's: the consensus vote's band
    head_dp, head_walk = warp_rows[0], walk_rows[0]
    head_group = group_rows[0]
    dp_src = dict(route="cuda", source="volcanosv_tpu_torch/csrc/banded_dp.cu",
                  replaces="volcanosv_tpu/ops/pallas/banded_dp.py:46")
    walk_src = dict(route="cuda", source="volcanosv_tpu_torch/csrc/tb_walk.cu",
                    replaces="volcanosv_tpu/ops/banded_align.py:291")
    # no single PyTorch call computes either function: library_ms is null
    kernels = [
        dict(name="banded_dp", **dp_src,
             design="warp (W <= 512)", launches=launches["banded_dp"],
             max_abs_err=max(r["max_abs_err"] for r in warp_rows),
             ms=head_dp["ms"], plain_ms=head_dp["plain_ms"],
             bound_ms=head_dp["bound_ms"], bound_by=head_dp["bound_by"],
             library_ms=None, shapes=warp_rows),
        dict(name="banded_dp_group", **dp_src,
             design="group (W > 512)", path="eval with ALT sequences",
             launches=info["slice"]["eval_alt"]["launches"]["group"],
             max_abs_err=max(r["max_abs_err"] for r in group_rows),
             ms=head_group["ms"], plain_ms=head_group["plain_ms"],
             bound_ms=head_group["bound_ms"],
             bound_by=head_group["bound_by"], library_ms=None,
             shapes=group_rows),
        dict(name="tb_walk", **walk_src,
             launches=launches["tb_walk"],
             max_abs_err=max(r["max_abs_err"] for r in walk_rows),
             ms=head_walk["ms"], plain_ms=head_walk["plain_ms"],
             bound_ms=head_walk["bound_ms"], bound_by=head_walk["bound_by"],
             library_ms=None, chain_ms=head_walk["chain_ms"],
             smem_latency_cycles=smem["cycles"], smem_latency_ns=smem["ns"],
             shapes=walk_rows),
        dict(name="banded_dp_asm", **dp_src,
             design=asm_dp["branch"], path="asm",
             launches=asm_launches["banded_dp"],
             max_abs_err=asm_dp["max_abs_err"], ms=asm_dp["ms"],
             plain_ms=asm_dp["plain_ms"], bound_ms=asm_dp["bound_ms"],
             bound_by=asm_dp["bound_by"], library_ms=None,
             shapes=[asm_dp]),
        dict(name="tb_walk_asm", **walk_src, path="asm",
             launches=asm_launches["tb_walk"],
             max_abs_err=asm_walk["max_abs_err"], ms=asm_walk["ms"],
             plain_ms=asm_walk["plain_ms"], bound_ms=asm_walk["bound_ms"],
             bound_by=asm_walk["bound_by"], library_ms=None,
             shapes=[asm_walk]),
        dict(name="banded_dp_pairing", **dp_src,
             design=pair_dp["branch"], path="run: complex-SV pairing",
             launches=info["run"]["pairing_launches"],
             max_abs_err=pair_dp["max_abs_err"], ms=pair_dp["ms"],
             plain_ms=pair_dp["plain_ms"], bound_ms=pair_dp["bound_ms"],
             bound_by=pair_dp["bound_by"], library_ms=None,
             shapes=[pair_dp]),
    ]
    for tag, (path, counts, _shapes) in paths.items():
        dp, walk = path_rows[tag]
        kernels.append(dict(
            name=f"banded_dp_{tag}", **dp_src, design=dp["branch"],
            path=path, launches=counts["banded_dp"],
            max_abs_err=dp["max_abs_err"], ms=dp["ms"],
            plain_ms=dp["plain_ms"], bound_ms=dp["bound_ms"],
            bound_by=dp["bound_by"], library_ms=None, shapes=[dp]))
        kernels.append(dict(
            name=f"tb_walk_{tag}", **walk_src, path=path,
            launches=counts["tb_walk"], max_abs_err=walk["max_abs_err"],
            ms=walk["ms"], plain_ms=walk["plain_ms"],
            bound_ms=walk["bound_ms"], bound_by=walk["bound_by"],
            library_ms=None, shapes=[walk]))
    print(json.dumps(info))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
