#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (volcanosv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--profile] [--scale MB | --repeat]

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
         recall >= 0.8 and precision >= 0.7; the DP, the walk and the
         three k-mer kernels (csrc/kmer.cu: count, unique mask, vote)
         launched during `asm`, and the MEC kernel (csrc/mec.cu).  The
         stage times, the DP launches by (mode,
         design, B, M, W) and the calls of the watched functions are
         listed.  A user's chromosome is 50-250 Mb; the k-mer tables
         (4^12 int32 each, up to 8 resident) are at full size at any
         length.  With --profile the `asm` run is traced too.
Phase 4b `asm` with `--device cuda` and with `--device cpu` on the
         pipeline test's recipe (80 kb, 24x, 7 kb reads, seed 21), once
         with HiFi reads (`-d Hifi`, error 0.001), and at 40 kb once with
         CLR reads (`-d CLR`, substitutions 0.09 and indels 0.045) and once
         with ONT reads (`-d ONT`, 0.06 and 0.03; at both, every candidate
         site is realigned through the pair-HMM Viterbi, whose kernel must
         have launched on the card): final_contigs.fa, phased_snps.vcf,
         read_hp_chr1.tsv and phased.bam byte-identical in each.  Then the
         pair-HMM kernel (csrc/pairhmm.cu) against its plain version on
         the card and on the CPU, fp32 scores bit-equal:
         at the path's shape (8192 pairs, R = 57, W = 41, error 0.002 and
         0.1; the group design, timed beside its bound), at edge batches
         (1 and 37 pairs, empty and full segments, all-N windows, W 9 and
         200) and at the block design's windows (W 1025, 2048 timed, and
         4096, whose rows exceed shared memory, at 300 pairs of 64 rows
         and 4 of 4112).
         Then the MEC kernel (csrc/mec.cu) against its plain version,
         (h, a, mec) equal: at phase 4's largest observation set (8
         restarts x 30 iterations; on the card and on the CPU; timed beside
         its bound and its chain floor, `chain_ms`: the 61 half-steps times
         the half-step barrier of the design's cluster size, measured by
         `mec_sync_chase`; every cluster size of the smem design, 1 to 16
         CTAs a restart, and the grid design timed in turns), one CTA a
         restart against 8 in turns on six sets of about 4,900 to 19,100
         observations (across the plan's one-CTA limit), at edge cases
         at 1, 2 and 16 CTAs a restart and in the grid design (n_iter 0, 1
         and 30, reads and SNPs without observations, every allele 0, one
         and no observation, duplicates, restarts tied on the lowest MEC, a
         shuffled order with an SV-marker column appended), at R just
         inside and just past the smem design's reach, and at a
         chromosome's scale (250 Mb, het SNPs 1 every 1.5 kb, 9 kb reads at
         30x: 166,667 SNPs, 833,333 reads, about 5M observations; the grid
         design, on the card only; timed beside its bound).  At phase 4's
         set and at the chromosome, the phase stage's `_mec_solve` end to
         end (host preparation, upload, kernels, results back) against the
         same steps with the plain version, equal.  Then
         canonical_hashes' kernel (csrc/kmer.cu) against its plain version
         on 2^21 random int32 hashes at k 6, 12, 15 and 16, timed beside its
         bound.  Then the three k-mer kernels against their
         plain versions on the card and on the CPU, exactly equal, at
         phase 4's own inputs (the largest table-build chunk, the unique
         mask of four tables, the largest vote chunk of 64 reads), each
         timed beside its bound (the count also beside one `index_add_` of
         its prepared index and weights, and three instances of its kernel
         template in turns: as it is, with its hashes masked into 1 MB so
         that every atomic hits the L2, and the hashing alone; the vote, a
         grid of read tiles,
         timed with a warm L2 and with the L2 flushed before each launch),
         then at edge cases for k 6 and 12: a stream counted in chunks
         across seams, rows with lengths, and vote chunks with empty,
         all-N, homopolymer and N-run rows, the partition's two-zero-table
         layout and a 120 kb read in a 2^17-column chunk, whose unique
         windows overflow the vote's shared memory; the count on poly-A,
         poly-T and all-N chunks into a table that holds counts.
Phase 4c the all-vs-all overlap pass (csrc/ava.cu, ops/overlap.py)
         against native/ava.cpp on the host: its eight columns equal on
         the run cell's read group (a 250 kb haplotype at 14x, 13.5 kb
         reads at 0.2% error), at CLR and ONT error, on a repeat-rich
         group and on a tandem array; at the run cell's group the kernels'
         device time beside the bound, the whole call (host sketch and
         index included) and ava.cpp on the host's threads in turns, and
         the plain version on the card, whose columns must equal them
         too.  Every later `run` and `asm` must
         launch the pass (`ava_overlaps` in the launch counts).
Phase 5  `run --device cuda` (reads -> asm -> the large-indel, small-indel
         and complex-SV callers -> merged VCF) on the golden recipe of
         tests/test_golden_e2e.py (4 x 250 kb, every SV type, a
         translocation, small indels, HiFi reads at 30x, 9 kb), simulated
         by the port's `sim`, whose truth.vcf must be the pinned
         tests/data/golden_truth.vcf; then the golden test's gates through
         the port's eval: SV F1 and recall >= 0.99, GT >= 0.98, small-indel
         recall >= 0.93, precision >= 0.95 and GT >= 0.90, SNP recall,
         precision and zygosity >= 0.95, switch error <= 0.02, the
         translocation as a 1|1 reciprocal BND pair.  The sim's ref.fa,
         reads.fastq and truth.vcf and the run's six outputs must have the
         sha256 and sizes pinned in tests/data/golden_run_sha256.json,
         made from the JAX package on the CPU (tools/pin_golden_run.py):
         the card's bytes are the JAX package's (a mismatch prints the
         merged VCF's diff against tests/data/golden_variants.vcf and
         raises).  Stage times, the DP
         launches by shape, and those made inside the complex-SV stage
         (counted around call_complex_svs), which must include the
         haplotype pairing's edit distances at W = 128, the pair-HMM
         kernel's launches (76 at the golden recipe), the k-mer
         kernels' and the MEC kernel's; for each pair-HMM launch its real
         pairs (0 < len <= R) of 8192 and how the group design's warps mix
         lengths, for each vote launch its real reads of 64.  The run is
         traced on the card (torch.profiler) for the device's busy time
         and the pair-HMM's, the k-mer kernels' and the MEC kernels'
         device time a launch; the MEC launches' (O, NR, S, R) and, after
         the run, the MEC designs in turns at its largest set; with
         --profile the host's ops too.  After the run the pair-HMM kernel
         is held to the plain version and timed at the run's fullest
         bucket.
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
         iterations, means and tau within rtol 1e-4), the Viterbi and
         posteriors kernels (csrc/coverage_hmm.cu) against their plain
         versions on the card and on the CPU: labels equal, the kernel's
         posteriors no further from a float64 forward-backward than twice
         the CPU's, each timed beside its bound; both kernels again on
         tie-rich ragged batches (S 3-5, T 1, 2, 241 and 300, and T 4915
         and 4928 at S 4: the plans' segment edges; an all-padded row, two
         states of one mean) and at qc's launch shape (labels equal,
         posteriors within 1e-5 or twice the CPU's distance), each timed
         with its cycles a step on the design's longest chain, and the
         Viterbi's step alone (`viterbi_step_chase`: one warp, and one and
         two a scheduler) for its forward walk's `chain_ms`, and at the
         chromosome batch and qc's shape its split backtrace against
         one serial walk (the same kernel at one segment, in turns, equal
         labels); both must have launched during `qc`;
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
Phase 8  `run --device cuda -d CLR` and `-d ONT` on the recipe of
         tests/test_golden_dtype.py (1 x 200 kb, the full SV mix, 25x, 8 kb
         reads; --err 0.09 and 0.06), simulated by the port's `sim`: the
         sim's ref.fa, reads.fastq, truth.vcf and truth_snps.vcf and the
         run's six outputs must have the sha256 and sizes pinned in
         tests/data/golden_dtype_sha256.json, made from the JAX package on
         the CPU (tools/pin_golden_dtype.py; a mismatch prints the merged
         VCF's diff against tests/data/golden_dtype_<type>_variants.vcf
         and raises), and the port's eval must meet that test's floors (SV
         recall, precision and GT, SNP precision and recall, switch error
         <= 0.05).  Each run is traced on the card for its busy time; its
         stage times and every kernel's launches by shape are listed (the
         DP's (mode, design, B, M, W), the walk's, the pair-HMM's (B, R, W)
         and each launch's real pairs, the k-mer kernels', the MEC's (O,
         restarts, S, R) and the design `mec_plan` takes); the pair-HMM and
         the MEC kernels must have launched.  After each run, untraced:
         the pair-HMM kernel at the run's fullest bucket, the MEC kernel at
         its largest observation set (every design in turns) and the three
         k-mer kernels at its inputs, each against its plain version and
         timed beside its bound; after all phases, the DP and the walk at
         each path's most launched shape and at the largest launch of each
         (mode, design, W) that no earlier row holds.
Phase 9  `run` at chromosome scale through tools/scale_run_torch.py (the
         port's twin of tools/scale_run.py) with `--device cuda`, at the
         arguments of tests/data/scale_run_sha256.json: one 5 Mb
         chromosome, 30 SVs, HiFi reads at 24x, 9 kb.  The sim's ref.fa,
         reads.fastq and truth.vcf and the run's six outputs must have the
         pinned sha256 and sizes, made from the JAX package's
         tools/scale_run.py on the CPU (tools/pin_scale_run.py; a mismatch
         prints the merged VCF's diff against
         tests/data/scale_run_variants.vcf), and SV recall, precision and
         GT through the port's eval on the card must reach 0.95.  The
         stage table, peak RSS, peak device memory, the k-mer tables the
         partition built against its cap and every kernel's launches by
         shape are printed (the MEC's with `mec_plan`'s design, and
         whether any launch went past one CTA a restart); every kernel of
         `run` must have launched.  Then, untraced, the pair-HMM kernel at
         the run's fullest bucket, the MEC kernel at its largest
         observation set (every design in turns) and the three k-mer
         kernels at its largest chunk, each against its plain version and
         timed beside its bound; after all phases the DP and the walk at
         the run's most launched shapes and at each (mode, design, W) no
         earlier row holds.  `--scale MB` runs this phase alone at MB Mb
         (the pin's recipe at another length, held to the pin at the
         lengths it has a row for: 5, and 10 Mb under "rows"), then the
         DP and the walk at the largest launch of every (mode, design, W)
         the run made.
Phase 10 `run` on a repeat-rich reference: the port's `sim` at
         tests/test_repeat_rich.py's recipe (300 kb with 5 tandem arrays,
         2 segdup pairs at ~97% identity and 6 homopolymer runs in the
         reference, every SV type, 30x HiFi at 9 kb), its reads written as
         an unaligned BAM (flag 4, the FASTQ's order;
         tools/pin_repeat_run.py's `write_reads_bam` with the port's
         BamWriter), then `run --device cuda --fastq`, traced for its busy
         time: the sim's files, reads.bam, the six outputs and phased.bam
         must have the sha256 and sizes of
         tests/data/repeat_run_sha256.json, made from the JAX package on
         the CPU (tools/pin_repeat_run.py; a mismatch prints the merged
         VCF's diff against tests/data/repeat_run_variants.vcf), SV recall
         >= 0.85 and precision >= 0.90 through the port's eval on the card
         and a <DUP> among the complex-SV calls (that test's floors), and
         every kernel of `run` must have launched.  The stage table and
         the launches by shape are printed.  Then, untraced, each kernel
         against its plain version at the run's fullest shapes: the
         pair-HMM at its fullest bucket, the MEC at its largest
         observation set (every design in turns), the k-mer kernels at the
         largest chunk, the DP and the walk at the largest launch of each
         (mode, design, W).  Then `run --device cuda --bam reads.bam` and
         `run --device cuda --bam <the FASTQ run's phased.bam>` (aligned,
         coordinate-sorted, HP/PS tagged): each run's six outputs pinned
         (tests/data/repeat_run_bam_variants.vcf for the second's diff).
         Last, the restricted runs on phase 5b's sim and the contigs of
         its card run: vc-large-indel, vc-small-indel and vc-complex-sv,
         each with `--chrom chr2` and with a `--bed` of sub-intervals on
         both chromosomes, and vc-large-indel unrestricted, on the card and
         on the CPU (one process of its own beside the card): each VCF
         byte-identical, each command with records in a restricted run, and
         the `--chrom chr2` large-indel records the unrestricted run's chr2
         records (tests/test_cli_multichrom.py's subset).  `--repeat` runs
         phase 5b's card run and this phase alone.

The CPU sides of phase 4b's three `asm` checks, of phase 5b's `run`, of
phase 6's `qc` and of phase 10's restricted runs run in processes of
their own (two torch threads each) while the card works, each started as
soon as its inputs exist: 4b's after phase 1, 6's after phase 4, 5b's
before phase 5, 10's after phase 6; each phase joins its own, and any
left running when a phase raises is killed at exit.  Each phase's
seconds are printed.

Any failure raises.  On success the last four lines of standard
output are the phases' summary (launches by shape, stage times, eval), the
card's `nvidia-smi` name and power limit, one JSON object with the kernels'
launches, errors, times and bounds (each path's entry is checked and
timed at the shape that path launched most: phase 1's row there, or a
check made at that shape after the paths ran; `pairhmm_viterbi`'s
launches are the golden `run`'s, `coverage_viterbi`'s and
`coverage_posteriors`' those of `qc` and `asm --sd`, the k-mer and MEC
kernels' the golden `run`'s, timed at phase 4's inputs, and
canonical_hashes', on no path, at 2^21 hashes and k 12; each wrapper's
entry adds its launches on the CLR, ONT, scale and repeat-rich runs as
`launches_run_clr`, `launches_run_ont`, `launches_scale` and
`launches_repeat`), and the
`{"ok": true, ...}` line.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import os
import re
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


def _scale_tool():
    """tools/scale_run_torch.py, the port's twin of tools/scale_run.py:
    phase 9 runs it, and its registry of the kernel wrappers is this
    script's."""
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import scale_run_torch
    return scale_run_torch


def _wrappers() -> dict:
    """Every kernel wrapper of the port by its kernels-line name."""
    return _scale_tool().wrappers()


def _reset_counts() -> None:
    """Every wrapper's launch count to 0 and its shapes emptied."""
    _scale_tool().reset_counts()


def _counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


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
        "smem_chase", "tb_walk")
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
    summed device time and its share of the wall time, the time of
    PyTorch's indexing kernels (names holding "index": `index_add_`, the
    gathers) with their names, and the pair-HMM's, the k-mer kernels' and
    the MEC kernels' and the overlap pass's time, launches and time a
    launch (`focus`)."""
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    index = {k[:120]: v[0] for k, v in by_name.items()
             if "index" in k.lower()}
    focus = {k[:120]: dict(ms=v[0], count=v[1], ms_per_launch=v[0] / v[1])
             for k, v in by_name.items()
             if "pairhmm" in k or "kmer_" in k or "unique_mask" in k
             or "mec_" in k or "ava_" in k}
    return dict(busy_ms=busy, wall_s=wall_s,
                busy_share=busy / (wall_s * 1e3),
                index_ms=sum(index.values()), index_kernels=index,
                focus=focus,
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


def _shape_counts(shapes, keys) -> list[dict]:
    """Launch shapes (tuples named by `keys`), with their count, the most
    launched first."""
    from collections import Counter
    return [dict(zip(keys, sh), count=n)
            for sh, n in Counter(map(tuple, shapes)).most_common()]


def _dp_shapes(shapes) -> list[dict]:
    """banded_dp launches by (mode, design, B, M, W), with their count."""
    return _shape_counts(shapes, ("mode", "branch", "B", "M", "W"))


def _walk_shapes(shapes) -> list[dict]:
    """tb_walk launches by (design, B, M, W), with their count."""
    return _shape_counts(shapes, ("branch", "B", "M", "W"))


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


# The asm path's calls whose inputs phase 4b keeps: the MEC solve (whose
# `_mec_inputs` are the MEC kernel's arguments) and the k-mer kernels'
# wrappers where the partition calls them; module of the call site,
# attribute, and which call's inputs are kept (None: the first).  The
# wrappers count their own launches; the wrapping only keeps inputs, and
# never wraps a kernel wrapper in its own module, whose launch counter is
# read through the name the wrapping would rebind (`_mec_phase` counts
# itself as `_mec_phase.launches`).
WATCHED = (("phasing.phase", "_mec_solve",
            lambda args: len(args[0])),          # the most observations
           ("partition.partition", "kmer_count_into",
            lambda args: args[1].numel()),       # the largest chunk
           ("partition.partition", "unique_mask", None),
           ("partition.partition", "kmer_vote",
            lambda args: args[0].numel()))       # the widest read chunk
# operations of one pair-HMM cell (phasing/realign.py::_viterbi_batch), the
# least the recurrence needs: the match compare and the emission's select
# (2); M: two transition adds (max(i, d) + a_back rounds as max(i + a_back,
# d + a_back) does), their two maxes and the emission's add (5); I: two
# transitions, their max and the insert emission (4); D: the column offset,
# the running max and two adds (4).
VITERBI_OPS_PER_CELL = 15


def _watch(calls: dict, kept: dict, watched=WATCHED):
    """Wrap each `watched` function where the path calls it: count its
    calls and keep the inputs of one call.  Returns the undo."""
    import importlib
    undo = []
    for mod_name, attr, key in watched:
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
    kept of the WATCHED calls."""
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
    _reset_counts()
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
    kernel_launches = _counts()
    launches = {"banded_dp": ba.banded_dp.launches,
                "tb_walk": ba.tb_walk.launches}
    dp_shapes = _dp_shapes(ba.banded_dp.shapes)
    walk_shapes = _walk_shapes(ba.tb_walk.shapes)
    kmer_shapes = _kmer_shapes()
    stages = {k: round(v[0], 3) for k, v in STAGE_TIMES.items()}
    if rc != 0:
        raise AssertionError(f"asm exited {rc}")
    for name in ("banded_dp", "tb_walk", "mec_phase",
                 "ava_overlaps") + KMER_KERNELS:
        if kernel_launches[name] <= 0:
            raise AssertionError(f"{name} never launched during asm")
    _log(f"phase 4: asm {asm_s:.1f} s, launches {kernel_launches}, "
         f"watched calls {json.dumps(calls)}\n"
         f"phase 4: k-mer kernel launches by shape "
         f"{json.dumps(kmer_shapes)}\n"
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
                kernel_launches=kernel_launches,
                stages=stages, device_function_calls=calls,
                banded_dp_shapes=dp_shapes, tb_walk_shapes=walk_shapes,
                kmer_shapes=kmer_shapes, profile=profile_info)
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


def _time_cold_ms(fn, runs: int = 10) -> float:
    """Device milliseconds a call of `fn` with the L2 cold: before each
    call a write of 128 MB (more than the 50 MB L2) evicts it, outside the
    timed events; each call between its own events, queued behind a sleep
    so that the host's launch cost is not timed; the mean of `runs`."""
    import torch
    flush = torch.empty(32 << 20, dtype=torch.int32, device="cuda")
    fn()
    total = 0.0
    for _ in range(runs):
        flush.fill_(1)
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / runs


def _on(x, dev):
    return x.to(dev) if hasattr(x, "to") else x


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


# the edge batches of the pair-HMM kernel check, (B, W, err, what) with
# R = W + 16; tests/torch_inputs.py::VITERBI_EDGES, copied since the smoke
# run imports no tests
VITERBI_EDGES = {
    "B1": (1, 41, 0.1, None),
    "B37": (37, 41, 0.1, None),
    "lens_0_and_R": (64, 41, 0.1, "lens_0_and_R"),
    "all_N_haps": (64, 41, 0.1, "all_N_haps"),
    "W9": (64, 9, 0.1, None),
    "W200": (64, 200, 0.1, None),
}


def _viterbi_edge(name: str):
    """One VITERBI_EDGES batch (tests/torch_inputs.py::viterbi_edge_case):
    (segs, lens, haps, err, W)."""
    import numpy as np
    B, W, err, what = VITERBI_EDGES[name]
    R = W + 16
    rng = np.random.default_rng(B * 1000 + W)
    segs, lens, haps = _viterbi_pairs(rng, B, R, W, err)
    if what == "lens_0_and_R":
        lens[::2] = 0
        lens[1::2] = R
        segs[::2] = 4
        segs[1::2] = rng.integers(0, 4, (len(segs[1::2]), R))
    elif what == "all_N_haps":
        haps[:] = 4
    return segs, lens, haps, err, W


def _viterbi_row(name: str, segs, lens, haps, err: float, W: int,
                 timed: bool) -> dict:
    """The pair-HMM kernel (through `_viterbi_batch` on the card) against
    its plain version on the card and on the CPU: fp32 scores bit-equal
    (int32 view).  `timed`: the kernel's device time a launch (queued), the
    plain version's on the card (host launches included, what the path
    paid before the kernel), the CPU's (one call), the bound (fp32
    operations of the cells the segments need) and the share."""
    import numpy as np
    import torch

    from volcanosv_tpu_torch.phasing import realign
    p = realign.PairHmmParams(err)
    kw = dict(W=W, log_match=p.log_match, log_mis=p.log_mis,
              log_ins=p.log_ins, a_mm=p.a_mm, a_gap=p.a_gap,
              a_ext=p.a_ext, a_back=p.a_back)
    cpu = [torch.from_numpy(x) for x in (segs, lens, haps)]
    card = [x.to("cuda") for x in cpu]
    t0 = time.perf_counter()
    want = realign._viterbi_batch_plain(*cpu, **kw).numpy()
    cpu_ms = (time.perf_counter() - t0) * 1e3
    plain = realign._viterbi_batch_plain(*card, **kw).cpu().numpy()
    got = realign._viterbi_batch(*card, **kw).cpu().numpy()
    bits = [x.view(np.int32) for x in (got, plain, want)]
    if not (np.array_equal(bits[0], bits[1])
            and np.array_equal(bits[0], bits[2])):
        raise AssertionError(f"phase 4b: pair-HMM kernel != plain at {name}: "
                             f"{int((bits[0] != bits[1]).sum())} of "
                             f"{len(got)} scores differ")
    B, R = segs.shape
    row = dict(name=name, B=B, R=R, W=W, err=err, bit_equal=True,
               max_abs_err=float(np.abs(got - plain).max()), cpu_ms=cpu_ms)
    if W <= 1024:
        G, C = realign.viterbi_group_shape(W)
        row.update(design=f"group (G {G}, C {C})")
    else:
        row.update(design="block")
    if timed:
        ms = _time_queued_ms(lambda: realign._viterbi_batch(*card, **kw))
        plain_ms = _time_calls_ms(
            lambda: realign._viterbi_batch_plain(*card, **kw))
        cells = int(np.where(lens <= R, lens, 0).sum()) * W
        bound = _bound(B * (R + W + 8),
                       cells * VITERBI_OPS_PER_CELL + 2 * B * W,
                       FP32_OPS_PER_S)
        row.update(ms=ms, plain_ms=plain_ms, **bound,
                   share_of_bound=bound["bound_ms"] / ms, bound_type="fp32")
    _log(f"phase 4b: pair-HMM {json.dumps(row)}")
    return row


def _viterbi_rows(seed: int) -> list[dict]:
    """The pair-HMM kernel at the path's shape (8192 pairs, R = 57, W = 41,
    error 0.002 and 0.1; timed), then at the edge batches."""
    import numpy as np
    rows = []
    B, R, W = 8192, 57, 41
    for err in (0.002, 0.1):
        segs, lens, haps = _viterbi_pairs(np.random.default_rng(seed), B, R,
                                          W, err)
        rows.append(_viterbi_row(f"err={err}", segs, lens, haps, err, W,
                                 True))
    for name in VITERBI_EDGES:
        rows.append(_viterbi_row(name, *_viterbi_edge(name), False))
    return rows


# the pair-HMM's block design (W > 1024): (B, R, W, timed); at W = 4096
# the M, I and D rows (12 * W bytes) exceed the block's shared memory and
# go to a device scratch; 300 pairs stride over its 264 blocks
VITERBI_WIDE = ((37, 1041, 1025, False), (16, 2064, 2048, True),
                (300, 64, 4096, False), (4, 4112, 4096, False))


def _viterbi_wide_rows(seed: int) -> list[dict]:
    import numpy as np
    rows = []
    for B, R, W, timed in VITERBI_WIDE:
        segs, lens, haps = _viterbi_pairs(np.random.default_rng(seed + W),
                                          B, R, W, 0.1)
        rows.append(_viterbi_row(f"W={W} B={B} R={R}", segs, lens, haps,
                                 0.1, W, timed))
    return rows


# the k-mer kernels' kernels-line names (their wrappers in _wrappers())
KMER_KERNELS = ("kmer_count", "unique_mask", "kmer_vote")
# int32 operations of one window of the k-mer kernels (csrc/kmer.cu), the
# least the function needs: the rolled hash (a shift, an or, an and), the
# N test and its position, the validity compare (6); the count adds one
# atomic a valid window, the vote H mask tests a valid window, then two (a
# count and an append) a window unique to a table and two (a table read's
# add and the run's first test) a distinct one
KMER_OPS_PER_WINDOW = 6


def _kmer_shapes() -> dict:
    w = _wrappers()
    return {"kmer_count": _shape_counts(w["kmer_count"].shapes,
                                        ("B", "L", "k")),
            "unique_mask": _shape_counts(w["unique_mask"].shapes,
                                         ("H", "N")),
            "kmer_vote": _shape_counts(w["kmer_vote"].shapes,
                                       ("B", "L", "k", "H"))}


def _kmer_vote_case(seed, k, long_row=False, zero_tables=False):
    """tests/torch_inputs.py::kmer_vote_case, copied since the smoke run
    imports no tests: (codes (16, L) int8, lens (16,) int32, tables (4, 4^k)
    int32) — reads of four haplotypes of two genomes (SNPs at 1/150, hap 3
    at 1/20) with 1% errors, then two empty rows, an all-N row, 1500 A
    (table 0's homopolymer k-mer), an N run, a read that fills the row;
    `long_row`: row 0 a 120 kb read of hap 2 (L = 2^17); `zero_tables`:
    tables 2 and 3 zero."""
    import numpy as np

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


def _kmer_count_case(seed, k, chunk=4096):
    """tests/torch_inputs.py::kmer_count_case, copied: a stream of reads
    joined by N separators cut into chunks overlapping by k - 1."""
    import numpy as np
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


def _kmer_count_bound(codes, k: int, lens=None) -> dict:
    """Bound of one kmer_count_into call on these inputs: the codes (and
    lengths) read once; each 32-byte sector of the table that a valid
    window hits read and written once (the atomics' least traffic); six
    ops a window and one add a valid window."""
    import torch

    from volcanosv_tpu_torch.ops import kmer
    h, v = kmer._valid_windows(codes, k, lens)
    hv = h[v]
    sectors = int(torch.unique(hv >> 3).numel())
    n_bytes = codes.numel() + (4 * lens.numel() if lens is not None else 0) \
        + 2 * 32 * sectors
    return dict(_bound(n_bytes, h.numel() * KMER_OPS_PER_WINDOW + hv.numel()),
                windows=int(h.numel()), valid=int(hv.numel()),
                sectors=sectors)


def _kmer_vote_bound(codes, lens, k: int, tables, unique) -> dict:
    """Bound of one kmer_vote call on these inputs: the codes and lengths
    read once, the H mask bytes of each valid window, a table count of
    each distinct unique k-mer, the (B, H) votes written; the ops of
    KMER_OPS_PER_WINDOW's note."""
    import torch

    from volcanosv_tpu_torch.ops import kmer
    h, v = kmer._valid_windows(codes, k, lens)
    x = h[v].to(torch.int64)
    H = tables.shape[0]
    hit = unique[:, x].any(dim=0)
    n_unique = int(hit.sum())
    distinct = int(torch.unique(x[hit]).numel())
    B = codes.shape[0]
    n_bytes = codes.numel() + 4 * B + H * x.numel() + 4 * distinct + 4 * B * H
    ops = h.numel() * KMER_OPS_PER_WINDOW + H * x.numel() + 2 * n_unique \
        + 2 * distinct
    return dict(_bound(n_bytes, ops), windows=int(h.numel()),
                valid=int(x.numel()), unique_windows=n_unique,
                distinct=distinct)


def _kmer_check(name: str, fn, args_card, fresh=None) -> dict:
    """`fn` (a k-mer wrapper) on the card's tensors (the kernel), the plain
    version on the card and the wrapper on their CPU copies (the plain
    version): all exactly equal.  `fresh(args)`: new arguments for each
    call of a wrapper that updates one in place.  Returns the CPU time and
    the outputs' size."""
    import torch

    from volcanosv_tpu_torch.ops import kmer
    plain = {"kmer_count": kmer._kmer_count_plain,
             "unique_mask": kmer._unique_mask_plain,
             "kmer_vote": kmer._kmer_vote_plain}[name]
    fresh = fresh or (lambda a: a)
    args_cpu = [_on(a, "cpu") for a in args_card]
    n0 = fn.launches
    got = fn(*fresh(args_card))
    torch.cuda.synchronize()
    if fn.launches != n0 + 1:
        raise AssertionError(f"phase 4b: {name} launched no kernel")
    want_card = plain(*fresh(args_card)).cpu()
    a = fresh(args_cpu)
    t0 = time.perf_counter()
    want = fn(*a)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    if not (_equal_tensors(got, want_card) and _equal_tensors(got, want)):
        raise AssertionError(f"phase 4b: {name} kernel != plain")
    return dict(equal=True, max_abs_err=0, cpu_ms=cpu_ms,
                out=list(got.shape))


def _kmer_count_probes(table, codes, k: int, lens) -> dict:
    """What sets the atomic count's time, at these inputs (device ms a
    launch, queued, in turns): (a) the kernel as it is, (b) each hash masked
    into the table's first 1 MB (every atomic an L2 hit), (c) the hashing
    alone (the atomic predicated on an impossible hash); the share of (c)
    in (a) and the gap (a) - (b).  Launches of the one kernel with a flag
    (csrc/kmer.cu::kmer_count_probe_launch), on no path; `table` is
    scratch."""
    import torch

    from volcanosv_tpu_torch.ops import cuda_build
    lib = cuda_build.lib("kmer")
    B, L = codes.shape
    st = torch.cuda.current_stream().cuda_stream

    def probe(p):
        def run():
            cuda_build.check(lib.kmer_count_probe_launch(
                codes.data_ptr(), lens.data_ptr() if lens is not None
                else None, B, L, k, table.data_ptr(), p, st),
                "kmer_count probe", "kmer")
        return run
    ms = _time_turns({"a_count": probe(0), "b_l2_slice": probe(1),
                      "c_hash_only": probe(2)})
    ms.update(hash_share=ms["c_hash_only"] / ms["a_count"],
              gap_a_minus_b=ms["a_count"] - ms["b_l2_slice"])
    _log(f"phase 4b: kmer_count probes (ms) {json.dumps(ms)}")
    return ms


def _kmer_rows(kept: dict) -> list[dict]:
    """The three k-mer kernels at phase 4's kept inputs: exactly equal to
    their plain versions (card and CPU), the kernel's device time a launch
    (queued), the plain version's on the card (host launches included), the
    CPU's, the bound and, for the count, one `index_add_` of the prepared
    index and weights (the library call of the function)."""
    import torch

    from volcanosv_tpu_torch.ops import kmer
    rows = []
    (table, codes, k, *rest), _ = kept["kmer_count_into"]
    lens = rest[0] if rest else None
    zero = lambda a: [torch.zeros_like(a[0])] + list(a[1:])   # noqa: E731
    args = [table, codes, k] + ([lens] if lens is not None else [])
    row = _kmer_check("kmer_count", kmer.kmer_count_into, args, zero)
    t = torch.zeros_like(table)
    h, v = kmer._valid_windows(codes, k, lens)
    idx, w = h.reshape(-1).to(torch.int64), v.reshape(-1).to(torch.int32)
    row.update(
        name="kmer_count", shape=list(codes.shape), k=k,
        ms=_time_queued_ms(lambda: kmer.kmer_count_into(t, codes, k, lens)),
        plain_ms=_time_calls_ms(
            lambda: kmer._kmer_count_plain(t, codes, k, lens)),
        library_ms=_time_queued_ms(lambda: t.index_add_(0, idx, w)),
        probes=_kmer_count_probes(t, codes, k, lens),
        **_kmer_count_bound(codes, k, lens))
    rows.append(row)
    (tables,), _ = kept["unique_mask"]
    row = _kmer_check("unique_mask", kmer.unique_mask, [tables])
    row.update(
        name="unique_mask", shape=list(tables.shape),
        ms=_time_queued_ms(lambda: kmer.unique_mask(tables)),
        plain_ms=_time_calls_ms(lambda: kmer._unique_mask_plain(tables)),
        library_ms=None,
        **_bound(tables.numel() * 5, tables.numel() * 4))
    rows.append(row)
    (codes, lens, k, t4, u4), _ = kept["kmer_vote"]
    row = _kmer_check("kmer_vote", kmer.kmer_vote, [codes, lens, k, t4, u4])
    vote = lambda: kmer.kmer_vote(codes, lens, k, t4, u4)     # noqa: E731
    row.update(
        name="kmer_vote", design="tile", shape=list(codes.shape), k=k,
        ms=_time_queued_ms(vote), cold_ms=_time_cold_ms(vote),
        plain_ms=_time_calls_ms(
            lambda: kmer._kmer_vote_plain(codes, lens, k, t4, u4)),
        library_ms=None, **_kmer_vote_bound(codes, lens, k, t4, u4))
    rows.append(row)
    # the mask lookups' traffic if each moved a 32-byte sector: a computed
    # bound, not a measurement, logged beside the bound's one byte a lookup
    _log(f"phase 4b: kmer_vote bound with a 32-byte sector a mask lookup "
         f"(computed, not measured): "
         f"{32 * t4.shape[0] * row['valid'] / HBM_BYTES_PER_S * 1e3:.6f} ms")
    for r in rows:
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        _log(f"phase 4b: k-mer kernel {json.dumps(r)}")
    return rows


def _kmer_edges() -> list[dict]:
    """The k-mer kernels against their plain versions (card and CPU,
    exactly equal) at k 6 and 12: a stream counted chunk by chunk across
    the seams into one table (= the stream's count in one chunk), poly-A,
    poly-T and all-N chunks counted into a table that holds counts, the vote
    case's rows counted with their lengths, the unique mask and the vote
    of the vote case, of its two-zero-table layout and of its 2^17-column
    chunk with a 120 kb read (the vote's list in scratch)."""
    import numpy as np
    import torch

    from volcanosv_tpu_torch.ops import kmer
    rows = []
    for k in (6, 12):
        stream, chunks = _kmer_count_case(k, k)
        whole = kmer._kmer_count_plain(
            torch.zeros(4**k, dtype=torch.int32),
            torch.from_numpy(stream)[None], k)
        # poly-A (hash 0: every atomic on one word), poly-T (hash 4^k -
        # 1), an all-N row, into a table that holds counts
        poly = np.zeros((3, 1 << 17), np.int8)
        poly[1], poly[2] = 3, 4
        poly = torch.from_numpy(poly).cuda()
        base = torch.arange(4**k, dtype=torch.int32, device="cuda") % 5
        table = torch.zeros(4**k, dtype=torch.int32, device="cuda")
        for c in chunks:
            kmer.kmer_count_into(table, torch.from_numpy(c).cuda()[None], k)
        if not torch.equal(table.cpu(), whole):
            raise AssertionError(f"phase 4b: kmer_count across chunk seams "
                                 f"!= the whole stream's count at k={k}")
        got = kmer.kmer_count_into(base.clone(), poly, k)
        if not torch.equal(got.cpu(), kmer._kmer_count_plain(
                base.cpu(), poly.cpu(), k)):
            raise AssertionError("phase 4b: kmer_count != plain on poly-A / "
                                 "poly-T / all-N")
        rows.append(dict(name="kmer_count",
                         case="chunk seams; poly-A, poly-T, all-N into "
                              "counts", k=k, chunks=len(chunks), equal=True,
                         max_abs_err=0))
        for case, kw in (("edge rows", {}),
                         ("two zero tables", dict(zero_tables=True)),
                         ("2^17 columns", dict(long_row=True))):
            codes, lens, tables = (torch.from_numpy(x).cuda()
                                   for x in _kmer_vote_case(k, k, **kw))
            if not kw:
                rows.append(dict(_kmer_check(
                    "kmer_count", kmer.kmer_count_into,
                    [torch.zeros(4**k, dtype=torch.int32, device="cuda"),
                     codes, k, lens],
                    lambda a: [torch.zeros_like(a[0])] + list(a[1:])),
                    name="kmer_count", case="rows with lengths", k=k))
            row = _kmer_check("unique_mask", kmer.unique_mask, [tables])
            rows.append(dict(row, name="unique_mask", case=case, k=k))
            u = kmer.unique_mask(tables)
            row = _kmer_check("kmer_vote", kmer.kmer_vote,
                              [codes, lens, k, tables, u])
            # the 120 kb read's list: past the kernel's 8192 entries of
            # shared memory (csrc/kmer.cu SMEM_KEYS) at k 12
            first = _kmer_vote_bound(codes[:1], lens[:1], k, tables,
                                     u)["unique_windows"]
            if kw.get("long_row") and k == 12 and first <= 8192:
                raise AssertionError("phase 4b: the 2^17-column vote case "
                                     "does not overflow shared memory")
            rows.append(dict(row, name="kmer_vote", case=case, k=k,
                             L=codes.shape[1], first_row_unique=first))
    for r in rows:
        _log(f"phase 4b: k-mer edge {json.dumps(r)}")
    return rows


def _equal_tensors(got, want) -> bool:
    import torch
    if isinstance(want, torch.Tensor):
        got, want = [got], [want]
    return all(g.dtype == w.dtype and torch.equal(g.cpu(), w)
               for g, w in zip(got, want))


# the outputs of `asm` that its cuda and cpu runs must write alike
ASM_OUT = ("final_contigs.fa", "phased_snps.vcf",
           os.path.join("checkpoints", "read_hp_chr1.tsv"), "phased.bam")
# runs the port's CLI in a process of its own and prints its wall seconds
CLI_TIMED = ("import sys, time\n"
             "t0 = time.perf_counter()\n"
             "from volcanosv_tpu_torch.cli import main\n"
             "rc = main(sys.argv[1:])\n"
             "print(time.perf_counter() - t0)\n"
             "sys.exit(rc)\n")
# runs the port's CLI on each argument list of a JSON list in turn, in
# one process, and prints each command's wall seconds
CLI_SEQ_TIMED = ("import json, sys, time\n"
                 "from volcanosv_tpu_torch.cli import main\n"
                 "secs = []\n"
                 "for args in json.loads(sys.argv[1]):\n"
                 "    t0 = time.perf_counter()\n"
                 "    if main(args) != 0:\n"
                 "        sys.exit(1)\n"
                 "    secs.append(time.perf_counter() - t0)\n"
                 "print(json.dumps(secs))\n")


def _write_pipeline_case(d: str, err: float, length: int) -> None:
    """The pipeline test's recipe (tests/test_pipeline_e2e.py: 24x, 7 kb
    reads, seed 21; `length` cuts the chromosome) with substitutions at
    `err` and indels at `err / 2`, written under d."""
    import numpy as np

    from volcanosv_tpu_torch import sim
    from volcanosv_tpu_torch.io.fasta import write_fasta
    from volcanosv_tpu_torch.io.fastq import write_fastq
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(21)        # tests/test_pipeline_e2e.py
    ref = sim.random_genome(rng, length)
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


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


# the processes this run started for the CPU sides of its cuda = cpu
# checks; killed at exit where a phase raised before joining them
_CPU_SIDES: list = []


@atexit.register
def _kill_cpu_sides() -> None:
    for proc in _CPU_SIDES:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _start_cpu_cli(args: list[str], log: str, script: str = CLI_TIMED):
    """The port's CLI with `args` (a `--device cpu` command; with
    `script` CLI_SEQ_TIMED, one argument: a JSON list of such commands) in
    a process of its own on two torch threads, its log in `log`: the CPU
    side of a cuda = cpu check, run while the card works; `_join_cpu_cli`
    joins it."""
    os.makedirs(os.path.dirname(log), exist_ok=True)
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c", script] + args, cwd=REPO,
            stdout=subprocess.PIPE, stderr=fh, text=True,
            env=dict(os.environ, OMP_NUM_THREADS="2"))
    proc.log = log
    _CPU_SIDES.append(proc)
    return proc


def _join_cpu_cli(proc, what: str):
    """Waits for a `_start_cpu_cli` process; raises where it failed, else
    returns its command's wall seconds (CLI_SEQ_TIMED: each command's)."""
    stdout, _ = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"{what} --device cpu failed (log {proc.log})")
    return json.loads(stdout.strip().splitlines()[-1])


def _asm_on_card(d: str, dtype: str, err: float, length: int) -> dict:
    """`asm -d dtype --device cuda` on d's case in this process: the
    times, the stage times, the WATCHED calls and the kernels' launches."""
    from volcanosv_tpu_torch import cli
    from volcanosv_tpu_torch.utils.logging import STAGE_TIMES
    calls = {}
    undo = _watch(calls, {})
    STAGE_TIMES.clear()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        rc = cli.main(_asm_args(d, os.path.join(d, "out_cuda"), "cuda")
                      + ["-d", dtype])
    finally:
        undo()
    if rc != 0:
        raise AssertionError(f"asm -d {dtype} --device cuda failed")
    return dict(dtype=dtype, err=err, length=length,
                asm_s={"cuda": time.perf_counter() - t0},
                stages={"cuda": {k: round(v[0], 3)
                                 for k, v in STAGE_TIMES.items()}},
                device_function_calls=calls, kernel_launches=_counts())


def _join_cpu_asm(d: str, info: dict, cpu_proc) -> None:
    """The CPU side's process (`_start_cpu_cli`) joined: its four outputs
    must be the card's (`_asm_on_card`) bytes; its time, stage times and
    the output sizes go into `info`."""
    dtype = info["dtype"]
    info["asm_s"]["cpu"] = _join_cpu_cli(cpu_proc, f"asm -d {dtype}")
    with open(os.path.join(d, "out_cpu", "stage_times.json")) as fh:
        info["stages"]["cpu"] = {k: v["total_s"]
                                 for k, v in json.load(fh).items()}
    info["bytes"] = {}
    for name in ASM_OUT:
        got, want = (_read(os.path.join(d, f"out_{dev}", name))
                     for dev in ("cuda", "cpu"))
        if got != want or not want:
            raise AssertionError(f"phase 4b: asm -d {dtype} {name} differs "
                                 "between cuda and cpu")
        info["bytes"][name] = len(want)
    _log(f"phase 4b: asm outputs byte-identical on cuda and cpu "
         f"{json.dumps(info)}")


def _time_turns(fns: dict, runs: int = 10) -> dict:
    """Device ms a call of each of `fns` (name -> fn), queued
    (`_time_queued_ms`), in turns: in order, then in reverse order (old,
    new, new, old for two); each name's mean of its two times."""
    names = list(fns)
    times = {n: [] for n in names}
    for order in (names, names[::-1]):
        for n in order:
            times[n].append(_time_queued_ms(fns[n], runs))
    return {n: sum(v) / len(v) for n, v in times.items()}


def _mec_case(rng, n_reads, S, per_read, flip=0.15, zero=0.05):
    """tests/torch_inputs.py::mec_case, copied since the smoke run imports
    no tests: read r observes 1 .. 2 * per_read - 1 consecutive SNPs from a
    start that grows with r, alleles of a random truth, `flip` flipped,
    `zero` 0: (obs_read int32, obs_snp int32, obs_allele int8)."""
    import numpy as np
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


MEC_EDGES = ("n_iter_0", "n_iter_1", "n_iter_30", "uncovered", "all_zero",
             "one_obs", "no_obs", "duplicates", "tie", "unsorted")


def _mec_edge_case(name):
    """tests/torch_inputs.py::mec_edge_case, copied: (obs_read, obs_snp,
    obs_allele, S, n_reads, n_iter, h_init or None for chain_init's,
    seed)."""
    import numpy as np
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
                np.array([1, -1], np.int32), 3)
    r, s, o = _mec_case(rng, 80, 40, 5)
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


def _mec_chromosome(seed: int):
    """One chromosome's MEC input at 30x HiFi, made with numpy: 250 Mb, het
    SNPs 1 every 1.5 kb at uniform positions (S = 166,667), 9 kb reads at
    30x (R = 833,333) starting uniformly, ordered by start as the pileup
    orders reads, each observing every SNP it covers (about 5M), alleles of
    a random truth with 0.2% flipped and 1% 0: (obs_read int32, obs_snp
    int32, obs_allele int8, S, R)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    L, S, R, read_len = 250_000_000, 166_667, 833_333, 9_000
    pos = np.sort(rng.integers(0, L, S))
    start = np.sort(rng.integers(0, L - read_len, R))
    lo = np.searchsorted(pos, start)
    n = np.searchsorted(pos, start + read_len) - lo
    obs_read = np.repeat(np.arange(R, dtype=np.int32), n)
    first = np.repeat(np.cumsum(n) - n, n)
    obs_snp = (np.repeat(lo, n) + np.arange(n.sum()) - first).astype(np.int32)
    o = rng.choice(np.array([-1, 1], np.int8), R)[obs_read] * \
        rng.choice(np.array([-1, 1], np.int8), S)[obs_snp]
    o[rng.random(len(o)) < 0.002] *= -1
    o[rng.random(len(o)) < 0.01] = 0
    return obs_read, obs_snp, o.astype(np.int8), S, R


def _mec_bound(args, n_reads: int, n_iter: int) -> dict:
    """Bound of one MEC call on these inputs: the observations and h0 read
    once, h, a and the MEC written; per restart, the 2 * n_iter + 1 votes
    add one signed term an observation with o != 0 (one IMAD or select),
    each read or SNP vote takes one select for its sign, and the MEC takes
    two operations an observation with o != 0 (the product's sign and the
    count)."""
    obs_read, obs_snp, obs_allele, h0 = args
    n_restarts, S = h0.shape
    n_inf = int((obs_allele != 0).sum())
    ops = n_restarts * ((2 * n_iter + 1) * n_inf
                        + n_iter * (n_reads + S) + n_reads + 2 * n_inf)
    n_bytes = sum(a.numel() * a.element_size() for a in args) \
        + 4 * (S + n_reads) + 8
    return dict(_bound(n_bytes, ops), informative=n_inf)


def _mec_design_name(branch: str, ctas) -> str:
    return f"smem/{ctas}" if branch == "smem" else branch


def _mec_row(name: str, args, n_reads: int, n_iter: int,
             branch: str = "auto", ctas=None, cpu: bool = False,
             timed: bool = False) -> dict:
    """The MEC kernels (one launch of `_mec_phase` on the card's tensors:
    the CSR sort and the votes) against `_mec_phase_plain` on the same
    tensors and, with `cpu`, the wrapper on their CPU copies: (h, a, mec)
    equal, or raise.  `timed`: the kernels' device time a call (queued),
    the plain version's on the card (host launches included), and the
    bound."""
    import torch

    from volcanosv_tpu_torch.phasing import phase
    kw = dict(n_reads=n_reads, n_iter=n_iter)
    n0 = phase._mec_phase.launches
    got = phase._mec_phase(*args, **kw, branch=branch, ctas=ctas)
    torch.cuda.synchronize()
    if phase._mec_phase.launches != n0 + 1:
        raise AssertionError(f"phase 4b: MEC {name} launched no kernel")
    if not _equal_tensors(got, [w.cpu() for w in
                                phase._mec_phase_plain(*args, **kw)]):
        raise AssertionError(f"phase 4b: MEC kernel != plain at {name} "
                             f"({branch}, {ctas})")
    n_restarts, S = args[3].shape
    if branch == "auto":
        branch, ctas = phase.mec_design(S, n_reads, args[0].numel())
        ctas = ctas or None
    row = dict(name=name, design=_mec_design_name(branch, ctas),
               obs=int(args[0].numel()), restarts=n_restarts, snps=S,
               reads=n_reads, n_iter=n_iter, mec=int(got[2]), equal=True,
               max_abs_err=0)
    if cpu:
        args_cpu = [a.cpu() for a in args]
        t0 = time.perf_counter()
        want = phase._mec_phase(*args_cpu, **kw)
        row["cpu_ms"] = (time.perf_counter() - t0) * 1e3
        if not _equal_tensors(got, want):
            raise AssertionError(f"phase 4b: MEC kernel != CPU at {name}")
    if timed:
        row.update(
            ms=_time_queued_ms(lambda: phase._mec_phase(
                *args, **kw, branch=branch, ctas=ctas)),
            plain_ms=_time_calls_ms(
                lambda: phase._mec_phase_plain(*args, **kw)),
            **_mec_bound(args, n_reads, n_iter))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    _log(f"phase 4b: MEC {json.dumps(row)}")
    return row


# the smem design's cluster sizes timed in turns (phase.mec_plan takes 1
# and 8)
MEC_CTAS_TIMED = (1, 2, 4, 8, 16)


def _mec_barriers() -> dict:
    """The smem design's half-step barrier (__syncthreads, and a cluster
    barrier past one CTA) on one cluster of each size, 20,000 rounds:
    nanoseconds and SM cycles a round (csrc/mec.cu::mec_sync_chase)."""
    import torch

    from volcanosv_tpu_torch.ops import cuda_build
    lib = cuda_build.lib("mec")
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    rounds, lat = 20_000, {}
    for ctas in MEC_CTAS_TIMED:
        for _ in range(2):            # the second: warm
            cuda_build.check(lib.mec_sync_chase(
                ctas, rounds, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream), "chase", "mec")
            torch.cuda.synchronize()
        ns, cycles = out.tolist()
        lat[ctas] = dict(ns=ns / rounds, cycles=cycles / rounds)
    return lat


def _mec_designs_in_turns(args, n_reads: int, n_iter: int, S: int) -> dict:
    """Every design that takes these inputs, each checked once against the
    plain version, then timed in turns (`_time_turns`): the smem design at
    each cluster size whose h, a and offsets fit, and the grid design."""
    from volcanosv_tpu_torch.phasing import phase
    from volcanosv_tpu_torch.ops import cuda_build
    smem = phase.mec_smem_bytes(cuda_build.lib("mec"))
    kw = dict(n_reads=n_reads, n_iter=n_iter)
    designs = [("smem", c) for c in MEC_CTAS_TIMED
                if phase.mec_smem_need(S, n_reads, args[0].numel(), c)[0]
                <= smem]
    designs.append(("grid", None))
    fns = {}
    for branch, ctas in designs:
        _mec_row("designs in turns", args, n_reads, n_iter, branch, ctas)
        fns[_mec_design_name(branch, ctas)] = (
            lambda b=branch, c=ctas: phase._mec_phase(
                *args, **kw, branch=b, ctas=c))
    return _time_turns(fns)


def _mec_solve_times(solve_args, reps: int) -> dict:
    """The phase stage's MEC call end to end, host clock: `_mec_solve` on
    the card (chain init and restarts on the host, the upload, the kernels,
    h and a back) against the same steps with `_mec_phase_plain` in the
    kernels' place (the torch ops that ran there before the kernels),
    `reps` calls each in turns: equal results, the median ms of each."""
    import numpy as np
    import torch

    from volcanosv_tpu_torch.phasing import phase
    args = (*solve_args[:-1], "cuda")

    def plain():
        margs, kw = phase._mec_inputs(*args)
        h, a, mec = phase._mec_phase_plain(*margs, **kw)
        return h.cpu().numpy(), a.cpu().numpy(), int(mec)
    times = dict(solve=[], solve_plain=[])
    for _ in range(reps):
        for key, fn in (("solve", lambda: phase._mec_solve(*args)),
                        ("solve_plain", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            times[key].append((time.perf_counter() - t0) * 1e3)
            if key == "solve":
                got = out
            elif not all(np.array_equal(x, y) for x, y in zip(got, out)):
                raise AssertionError("phase 4b: _mec_solve != its plain "
                                     "version")
    return {f"{k}_ms": float(np.median(v)) for k, v in times.items()}


def _mec_one_cta_limit(seed: int) -> dict:
    """One CTA a restart against 8 (`mec_plan`'s two cluster sizes), each
    checked once against the plain version and then timed in turns, on
    `_mec_case` sets of 4 to 5 observations a read and about 32 a SNP (the
    golden run's shape) from about 5,000 observations to 20,000, across
    phase.MEC_ONE_CTA_MAX_OBS: device ms by O."""
    import numpy as np
    import torch

    from volcanosv_tpu_torch.phasing import phase
    out = {}
    for n_reads in (1200, 1800, 2400, 3000, 3600, 4800):
        S = n_reads // 8
        r, s, o = _mec_case(np.random.default_rng(seed + n_reads), n_reads,
                            S, 4)
        h0 = phase.restart_inits(phase.chain_init(r, s, o, S), seed, 8)
        args = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
                for x in (r, s, o, h0)]
        fns = {}
        for ctas in (1, 8):
            _mec_row("one CTA against 8", args, n_reads, 30, "smem", ctas)
            fns[f"smem/{ctas}"] = (lambda c=ctas: phase._mec_phase(
                *args, n_reads=n_reads, n_iter=30, branch="smem", ctas=c))
        out[len(r)] = dict(_time_turns(fns), snps=S, reads=n_reads,
                           plan=_mec_design_name(
                               *phase.mec_design(S, n_reads, len(r))))
    _log(f"phase 4b: MEC one CTA against 8 by O (ms) {json.dumps(out)}")
    return out


def _mec_threshold(S: int, O: int) -> int:
    """The most reads R for which `mec_design` still takes the smem design
    at S SNPs and O observations."""
    from volcanosv_tpu_torch.phasing import phase
    lo, hi = 1, 1 << 22
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if phase.mec_design(S, mid, O)[0] == "smem":
            lo = mid
        else:
            hi = mid
    return lo


def _mec_rows(seed: int, kept: dict) -> dict:
    """The MEC kernel against its plain version: at phase 4's largest
    observation set (card and CPU, timed; every design timed in turns; the
    chain floor), at every edge case in each design (card and CPU), at R
    just inside and just past the smem design's reach (auto and grid), and
    at a chromosome's scale (the grid design, card only, timed)."""
    import numpy as np
    import torch

    from volcanosv_tpu_torch.config import PhasingConfig
    from volcanosv_tpu_torch.phasing import phase

    def on_card(*xs):
        return [torch.from_numpy(np.ascontiguousarray(x)).cuda()
                for x in xs]

    args, _kw = kept["_mec_solve"]
    margs, kw = phase._mec_inputs(*args[:-1], "cuda")
    out = dict(asm=_mec_row("asm's largest observation set", margs, **kw,
                            cpu=True, timed=True))
    asm = out["asm"]
    asm.update(_mec_solve_times(args, 5))
    out["barriers"] = _mec_barriers()
    from volcanosv_tpu_torch.ops import cuda_build
    out["smem_bytes"] = phase.mec_smem_bytes(cuda_build.lib("mec"))
    ctas = int(asm["design"].split("/")[1]) if "/" in asm["design"] else 1
    # the half-steps one after another, each at least one barrier
    asm["chain_ms"] = (2 * kw["n_iter"] + 1) * \
        out["barriers"][ctas]["ns"] * 1e-6
    asm["designs_ms"] = _mec_designs_in_turns(margs, kw["n_reads"],
                                              kw["n_iter"], asm["snps"])
    _log(f"phase 4b: MEC at asm's set, designs in turns (ms) "
         f"{json.dumps(asm['designs_ms'])}; a CTA's shared memory "
         f"{out['smem_bytes']} B; barriers (ns a half-step) "
         f"{json.dumps(out['barriers'])}; chain_ms {asm['chain_ms']:.6f}")
    out["one_cta_limit"] = _mec_one_cta_limit(seed)
    out["edges"] = []
    for name in MEC_EDGES:
        r, s, o, S, n_reads, n_iter, h_init, sd = _mec_edge_case(name)
        if h_init is None:
            h_init = phase.chain_init(r, s, o, S)
        h0 = phase.restart_inits(h_init, sd, 8)
        for branch, c in (("smem", 1), ("smem", 2), ("smem", 16),
                          ("grid", None)):
            out["edges"].append(_mec_row(name, on_card(r, s, o, h0),
                                         n_reads, n_iter, branch, c,
                                         cpu=True))
    S = 9000
    r, s, o = _mec_case(np.random.default_rng(seed), 20000, S, 6)
    top = _mec_threshold(S, len(r))
    h0 = phase.restart_inits(phase.chain_init(r, s, o, S), seed, 8)
    a = on_card(r, s, o, h0)
    out["threshold"] = []
    for past in (0, 1):
        for branch in ("auto", "grid"):
            row = _mec_row(f"R = {top + past} at S {S}, O {len(r)}", a,
                           top + past, 5, branch=branch)
            if branch == "auto" and row["design"].startswith("smem") == past:
                raise AssertionError(f"phase 4b: MEC auto took {row}")
            out["threshold"].append(row)
    t0 = time.perf_counter()
    r, s, o, S, R = _mec_chromosome(seed + 11)
    h0 = phase.restart_inits(phase.chain_init(r, s, o, S), seed, 8)
    gen_s = time.perf_counter() - t0
    row = _mec_row("a chromosome at 30x", on_card(r, s, o, h0), R, 30,
                   timed=True)
    if row["design"] != "grid":
        raise AssertionError(f"phase 4b: MEC chromosome took {row}")
    row.update(inputs_s=gen_s, **_mec_solve_times(
        (r, s, o, S, R, PhasingConfig(), seed, 8, "cuda"), 3))
    out["chromosome"] = row
    return out


# int32 operations of one canonical_hashes element at any k, as the
# kernel's formula needs them (csrc/kmer.cu): the complement's xor, a bit
# reverse, two shift-and pairs and an or to put each 2-bit field back in
# order, the shift down by 32 - 2k, and the minimum
CANONICAL_OPS = 9


def _canonical_rows(seed: int) -> list[dict]:
    """canonical_hashes' kernel against its plain version on the card and
    on the CPU, on 2^21 random int32 hashes (negative values, bits above
    2k), at k 6, 12, 15 and 16: equal exactly, each timed beside its bound
    (8 bytes an element, CANONICAL_OPS int32 operations)."""
    import numpy as np
    import torch

    from volcanosv_tpu_torch.ops import kmer
    rng = np.random.default_rng(seed + 12)
    x_cpu = torch.from_numpy(rng.integers(-2**31, 2**31, 1 << 21).astype(
        np.int32))
    x = x_cpu.cuda()
    rows = []
    for k in (6, 12, 15, 16):
        n0 = kmer.canonical_hashes.launches
        got = kmer.canonical_hashes(x, k)
        torch.cuda.synchronize()
        launched = kmer.canonical_hashes.launches == n0 + 1
        t0 = time.perf_counter()
        want = kmer.canonical_hashes(x_cpu, k)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        if not launched or not torch.equal(
                got, kmer._canonical_hashes_plain(x, k)) or \
                not torch.equal(got.cpu(), want):
            raise AssertionError(f"phase 4b: canonical_hashes kernel != "
                                 f"plain at k {k}")
        row = dict(name="canonical_hashes", n=x.numel(), k=k, equal=True,
                   max_abs_err=0, cpu_ms=cpu_ms,
                   ms=_time_queued_ms(lambda: kmer.canonical_hashes(x, k)),
                   plain_ms=_time_calls_ms(
                       lambda: kmer._canonical_hashes_plain(x, k)),
                   library_ms=None,
                   **_bound(8 * x.numel(), CANONICAL_OPS * x.numel()))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        _log(f"phase 4b: {json.dumps(row)}")
        rows.append(row)
    return rows


# the noisy `asm` cases' chromosome (the HiFi case keeps the recipe's 80 kb)
NOISY_ASM_LENGTH = 40_000


# phase 4b's `asm` cases: key, read type, error, length, directory.  CLR
# (13.5% total error) realigns every candidate site through the pair-HMM
# (PhasingConfig.realign_all): the chain pileup -> Viterbi -> allele call
# -> MEC -> partition -> assembly, card against CPU; ONT (9% total error)
# likewise, with its own aligner preset (map-ont) and signature rules.
# Both at 40 kb: the CPU side's polish takes minutes (212 s for ONT at
# 80 kb), and phase 8 runs both types at 200 kb on the card
ASM_CASES = (("hifi", "Hifi", 0.001, 80_000, "asm_cuda_vs_cpu"),
             ("clr", "CLR", 0.09, NOISY_ASM_LENGTH, "asm_clr_cuda_vs_cpu"),
             ("ont", "ONT", 0.06, NOISY_ASM_LENGTH, "asm_ont_cuda_vs_cpu"))


def _ava_group(seed, hap_len=250_000, coverage=14.0, read_len=13_500,
               read_sd=3_000, err=0.002, repeats=0, tandem=0, min_len=200):
    """tests/torch_inputs.py::ava_group, copied since the smoke run imports
    no tests: one haplotype's reads as 2-bit code arrays (a random
    haplotype, optionally with spread and tandem repeats; reads at random
    starts, half reverse-complemented, substitutions at err / 2 and 1-3 bp
    insertions and deletions at err / 4 each a base)."""
    import numpy as np
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


# the overlap pass's cases, (name, _ava_group arguments): the run cell's
# read group (svbench's hifi-28x: one haplotype of a 250 kb job, 14x, 13.5
# kb reads at 0.2% error) first, then CLR and ONT error, a repeat-rich
# group (the 64-hit cap and the occurrence filter) and a tandem array
# (segments sorted in device memory)
AVA_CASES = (
    ("run_group", dict(err=0.002)),
    ("clr", dict(err=0.1)),
    ("ont", dict(err=0.05)),
    ("repeats", dict(err=0.002, repeats=30)),
    ("tandem", dict(hap_len=60_000, coverage=6.0, read_len=12_000,
                    read_sd=500, tandem=20)),
)
# int32 operations of one predecessor test of the chain DP (chain.cpp's
# loop body): dt, dq and the gap (3), the four range tests and the band
# test (5), min(dq, dt, k) (2), the score's add and subtract (2), the
# compare with the best (1); the cost table read is no operation
AVA_TEST_OPS = 13


def _ava_bound(shape, n_idx: int, n_ov: int) -> dict:
    """The pass's least time: the minimizers and the index entries read
    once (13 bytes each: hash, read, pos, strand), the eight columns
    written once (45 bytes an overlap); 16 predecessor tests an anchor."""
    n_reads, n_min, n_anchors, _chunks, _past = shape
    return _bound(13 * (n_min + n_idx) + 45 * n_ov,
                  n_anchors * 16 * AVA_TEST_OPS)


def _ava_device_ms(fn) -> tuple[float, dict]:
    """The pass's kernels' device time (ms) in one call of `fn`, from a
    torch.profiler trace, and the time by kernel."""
    import torch
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        if "ava_" in e.key:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            name = re.search(r"ava_\w*?kernel", e.key)
            name = name.group(0) if name else e.key[:60]
            by[name] = by.get(name, 0.0) + us / 1e3
    return sum(by.values()), by


def _ava_columns_err(got, want) -> float:
    """The largest |score| difference of two sets of ava_overlaps columns
    (inf where any column differs in dtype, length or value)."""
    import numpy as np
    if any(g.dtype != w.dtype or not np.array_equal(g, w)
           for g, w in zip(got, want)):
        return float("inf")
    return float(np.abs(got[3].astype(np.float64) - want[3]).max()) \
        if len(want[3]) else 0.0


def phase4c_overlap_pass(seed: int) -> dict:
    """The all-vs-all overlap pass (csrc/ava.cu) against ava.cpp on the
    host on AVA_CASES: the eight columns equal; at the run cell's group,
    the plain version on the card equals them too, and the pass is timed
    (its kernels' device time beside the bound, the whole call with its
    host sketch and index, ava.cpp on the host's threads and the plain
    version on the card, in turns)."""
    import numpy as np
    import torch

    from volcanosv_tpu_torch import native
    from volcanosv_tpu_torch.config import AlignConfig
    from volcanosv_tpu_torch.ops import overlap
    acfg = AlignConfig.preset("ava")
    lib = native.get_lib()
    dev = torch.device("cuda")
    rows = []
    for i, (name, args) in enumerate(AVA_CASES):
        reads = _ava_group(seed + 500 + i, **args)
        want = native.ava_overlaps_np(lib, reads, acfg)
        got = overlap.ava_overlaps(reads, acfg, dev)
        torch.cuda.synchronize()
        err = _ava_columns_err(got, want)
        if err != 0:
            raise AssertionError(f"phase 4c: the pass != ava.cpp at {name}")
        shape = overlap.ava_overlaps.shapes[-1]
        with native.ava_index_views(lib, reads, acfg.k, acfg.w) as ix:
            n_idx = len(ix["idx_hash"])
        row = dict(name=name, reads=shape[0], minimizers=shape[1],
                   index=n_idx, anchors=shape[2], chunks=shape[3],
                   past_smem=shape[4], overlaps=len(want[0]),
                   max_abs_err=err)
        if i == 0:
            def card():
                overlap.ava_overlaps(reads, acfg, dev)
                torch.cuda.synchronize()

            def host():
                native.ava_overlaps_np(lib, reads, acfg)

            def plain():
                cols, _stats = overlap._ava_pass(
                    reads, acfg, dev, True, overlap.MAX_ANCHORS,
                    overlap.MAX_SEGMENTS)
                torch.cuda.synchronize()
                return cols
            card()
            turns = {"card": [], "host": []}
            for fn in (card, host, host, card, card, host, host, card):
                t0 = time.perf_counter()
                fn()
                turns["card" if fn is card else "host"].append(
                    (time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            plain_cols = plain()
            plain_ms = (time.perf_counter() - t0) * 1e3
            plain_err = _ava_columns_err(plain_cols, want)
            if plain_err != 0:
                raise AssertionError(
                    f"phase 4c: the plain version on the card != ava.cpp "
                    f"at {name}")
            ms, by_kernel = _ava_device_ms(card)
            row.update(ms=ms, by_kernel=by_kernel,
                       pass_ms=statistics.median(turns["card"]),
                       host_ms=statistics.median(turns["host"]),
                       turns_ms=turns, plain_ms=plain_ms,
                       plain_max_abs_err=plain_err,
                       **_ava_bound(shape, n_idx, len(want[0])))
            row["share"] = row["bound_ms"] / ms
        rows.append(row)
        _log(f"phase 4c: {json.dumps(row)}")
    return dict(rows=rows, host_threads=os.cpu_count())


def start_cpu_sides_4b() -> dict:
    """Phase 4b's three `asm` cases written, and their CPU sides started
    (`_start_cpu_cli`); they need nothing of the card, so the whole run
    starts them after phase 1, to run beside phases 2-4b."""
    started = {}
    for key, dtype, err, length, sub in ASM_CASES:
        d = os.path.join(WORK, sub)
        _write_pipeline_case(d, err, length)
        started[key] = _start_cpu_cli(
            _asm_args(d, os.path.join(d, "out_cpu"), "cpu")
            + ["-d", dtype, "--profile"], os.path.join(d, "cpu.log"))
    return started


def phase4b_asm_cuda_vs_cpu(seed: int, kept: dict, started: dict) -> dict:
    """`asm` on cuda and cpu (byte-identical outputs), HiFi, CLR and ONT
    (where the pair-HMM kernel must launch), then the pair-HMM kernel
    against its plain version (`_viterbi_rows`, `_viterbi_wide_rows`), the
    MEC kernel (`_mec_rows`), canonical_hashes' kernel (`_canonical_rows`)
    and the k-mer kernels (`_kmer_rows`, `_kmer_edges`) against theirs,
    each timed beside its bound.  The three `asm` runs' CPU sides
    (`started`, by `start_cpu_sides_4b`) are joined at the phase's end."""
    cases = ASM_CASES
    info = {key: _asm_on_card(os.path.join(WORK, sub), dtype, err, length)
            for key, dtype, err, length, sub in cases}
    for key, dtype, *_ in cases[1:]:
        if info[key]["kernel_launches"]["pairhmm_viterbi"] <= 0:
            raise AssertionError(f"phase 4b: asm -d {dtype} launched no "
                                 "pair-HMM kernel")
    vrows = _viterbi_rows(seed) + _viterbi_wide_rows(seed)
    info["mec"] = _mec_rows(seed, kept)
    info["canonical"] = _canonical_rows(seed)
    info["kmer"] = _kmer_rows(kept)
    info["kmer_edges"] = _kmer_edges()
    info["pairhmm_viterbi"] = vrows
    for key, _dtype, _err, _length, sub in cases:
        _join_cpu_asm(os.path.join(WORK, sub), info[key], started[key])
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
# the JAX package's golden sim inputs and `run` outputs: sha256 and sizes
# (tools/pin_golden_run.py, on the CPU), and its merged VCF for a diff
GOLDEN_PIN = os.path.join(REPO, "tests", "data", "golden_run_sha256.json")
GOLDEN_VARIANTS = os.path.join(REPO, "tests", "data", "golden_variants.vcf")
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


def _bucket_stats(lens, R: int, W: int) -> dict:
    """One pair-HMM launch's (B,) lengths: its real pairs (0 < len <= R),
    the group design's warps (32 / G pairs each) that hold one, those of
    them whose lengths differ, and the rows the group design runs (a warp
    its longest segment, for each of its pairs) over the rows the
    segments need."""
    import numpy as np

    from volcanosv_tpu_torch.phasing import realign
    G = realign.viterbi_group_shape(W)[0] if W <= 1024 else 32
    real = np.where((lens > 0) & (lens <= R), lens, 0).astype(np.int64)
    warps = np.pad(real, (0, -len(real) % (32 // G))).reshape(-1, 32 // G)
    top = warps.max(axis=1)
    live = top > 0
    return dict(B=len(lens), R=R, W=W, G=G, real=int((real > 0).sum()),
                warps=len(warps), live_warps=int(live.sum()),
                mixed_warps=int((live & (warps.min(axis=1) != top)).sum()),
                row_ratio=float(top.sum() * warps.shape[1]
                                / max(1, real.sum())))


def _watch_buckets(buckets: list, reads: list, kept: dict):
    """Wrap realign.pairhmm_alleles (pileup imports it at each call) and
    partition._read_codes, neither a kernel wrapper: `buckets` receives
    `_bucket_stats` of each pair-HMM launch, `reads` the real reads of each
    vote chunk, `kept` the inputs of the bucket with the most real pairs.
    Returns the undo."""
    from volcanosv_tpu_torch.partition import partition
    from volcanosv_tpu_torch.phasing import realign
    alleles, read_codes = realign.pairhmm_alleles, partition._read_codes

    def watched_alleles(read_segs, seg_lens, hap_ref, hap_alt, error_rate,
                        *a, **kw):
        for lo in range(0, len(seg_lens), realign._BUCKET):
            args = (read_segs, seg_lens, hap_ref, hap_alt, lo)
            st = _bucket_stats(realign._bucket(*args)[1],
                               read_segs.shape[1], hap_ref.shape[1])
            buckets.append(st)
            if st["real"] > kept.get("real", -1):
                kept.update(real=st["real"], args=args, err=error_rate)
        return alleles(read_segs, seg_lens, hap_ref, hap_alt, error_rate,
                       *a, **kw)

    def watched_codes(seqs, device):
        out = read_codes(seqs, device)
        reads.append(out[2])
        return out
    realign.pairhmm_alleles = watched_alleles
    partition._read_codes = watched_codes

    def undo():
        realign.pairhmm_alleles = alleles
        partition._read_codes = read_codes
    return undo


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


def _digest(path: str) -> dict:
    """A file's sha256 and size, as the pins hold them."""
    import hashlib
    data = _read(path)
    return {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}


def _check_pin(pin: dict, sim_args: list, sim_dir: str, out: str,
               variants: str, tag: str, args_key: str = "sim_args") -> dict:
    """A sim's inputs and the card's six `run` outputs against the JAX
    package's pinned sha256 and sizes (`pin`: the arguments that made the
    sim under `args_key`, sim and run digests); on a mismatch the merged
    VCF's diff against the pinned copy `variants` is printed, then it
    raises."""
    import difflib
    if pin[args_key] != sim_args:
        raise AssertionError(f"{tag}: the pin's sim arguments are not "
                             f"{sim_args}")
    bad = []
    for group, d in (("sim", sim_dir), ("run", out)):
        for name, want in pin[group].items():
            got = _digest(os.path.join(d, name))
            if got != want:
                bad.append(dict(file=name, got=got, want=want))
    if bad:
        with open(variants) as a, \
                open(os.path.join(out, "volcanosv_variants.vcf")) as b:
            diff = list(difflib.unified_diff(
                a.readlines(), b.readlines(), "jax", "card", n=0))
        _log(f"{tag}: merged VCF against the JAX package's:\n"
             + "".join(diff[:200]))
        raise AssertionError(f"{tag}: the bytes differ from the JAX "
                             f"package's pin: {json.dumps(bad)}")
    return {"files": len(pin["sim"]) + len(pin["run"]), "equal": True}


def _traced_cli(args: list, undo: tuple, host: bool = False):
    """`cli.main(args)` from zeroed launch counts and stage times, traced
    on the card for its busy time (`host`: the host's ops too); then each
    of `undo` restores what the caller watched.  Returns (exit code, wall
    seconds, the profiler)."""
    import torch

    from volcanosv_tpu_torch import cli
    from volcanosv_tpu_torch.utils.logging import STAGE_TIMES
    STAGE_TIMES.clear()
    activities = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    prof = torch.profiler.profile(activities=activities)
    _reset_counts()
    t0 = time.perf_counter()
    try:
        with prof:
            rc = cli.main(args)
            torch.cuda.synchronize()
            # the wall time, before the trace is collected on leaving
            run_s = time.perf_counter() - t0
    finally:
        for fn in undo:
            fn()
    return rc, run_s, prof


def phase5_run_golden(profile: bool) -> dict:
    """`sim` with the golden recipe (its truth must be the pinned
    tests/data/golden_truth.vcf), `run --device cuda`, traced on the card
    for its busy time, the golden gates; stage times, the launches (the
    pair-HMM kernel's among them) by shape and the DP's of the complex-SV
    stage, which must include the pairing's W = 128."""
    from volcanosv_tpu_torch import cli
    from volcanosv_tpu_torch.ops import banded_align as ba
    from volcanosv_tpu_torch.phasing import realign
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
    buckets, vote_reads, fullest = [], [], {}
    undo_buckets = _watch_buckets(buckets, vote_reads, fullest)
    mec_calls, mec_kept = {}, {}
    undo_mec = _watch(mec_calls, mec_kept, WATCHED[:1])
    rc, run_s, prof = _traced_cli(_run_args(sim_dir, out, "cuda"),
                                  (undo, undo_buckets, undo_mec), profile)
    kernel_launches = _counts()
    mec_shapes = [dict(zip(("O", "NR", "S", "R"), x)) for x in
                  _wrappers()["mec_phase"].shapes]
    pairhmm_shapes = _shape_counts(_wrappers()["pairhmm_viterbi"].shapes,
                                   ("B", "R", "W"))
    launches = {"banded_dp": ba.banded_dp.launches,
                "tb_walk": ba.tb_walk.launches,
                "pairhmm_viterbi": kernel_launches["pairhmm_viterbi"]}
    launches.update({k: kernel_launches[k]
                     for k in KMER_KERNELS + ("mec_phase", "ava_overlaps")})
    dp_shapes = _dp_shapes(ba.banded_dp.shapes)
    walk_shapes = _walk_shapes(ba.tb_walk.shapes)
    kmer_shapes = _kmer_shapes()
    cx_shapes = _dp_shapes(complex_shapes)
    stages = {k: round(v[0], 3) for k, v in STAGE_TIMES.items()}
    if rc != 0:
        raise AssertionError(f"phase 5: run exited {rc}")
    with open(GOLDEN_PIN) as fh:
        pinned = _check_pin(json.load(fh), GOLDEN_SIM, sim_dir, out,
                            GOLDEN_VARIANTS, "phase 5")
    _log(f"phase 5: the sim's inputs and run's six outputs are the JAX "
         f"package's pinned bytes {json.dumps(pinned)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"phase 5: {name} never launched in run")
    pairing = [r for r in cx_shapes
               if r["mode"] == PAIRING_MODE and r["W"] == PAIRING_W]
    if not pairing:
        raise AssertionError(f"phase 5: no banded_dp launch at W = "
                             f"{PAIRING_W} inside complex-sv: {cx_shapes}")
    _log(f"phase 5: run {run_s:.1f} s, launches {kernel_launches}\n"
         f"phase 5: pairhmm_viterbi launches by shape "
         f"{json.dumps(pairhmm_shapes)}\n"
         f"phase 5: k-mer kernel launches by shape "
         f"{json.dumps(kmer_shapes)}\n"
         f"phase 5: banded_dp launches by shape {json.dumps(dp_shapes)}\n"
         f"phase 5: tb_walk launches by shape {json.dumps(walk_shapes)}\n"
         f"phase 5: banded_dp launches inside complex-sv "
         f"{json.dumps(cx_shapes)}\n" + stage_report())
    profile_info = _profile_summary(prof, run_s)
    mixed = sum(b["mixed_warps"] for b in buckets)
    _log(f"phase 5: pair-HMM launches, real pairs of B and the group "
         f"design's warps (mixed: lengths differ) {json.dumps(buckets)}; "
         f"{mixed} mixed warps in {len(buckets)} launches\n"
         f"phase 5: vote launches, real reads of 64 {vote_reads}\n"
         f"phase 5: MEC launches (O, NR, S, R) {json.dumps(mec_shapes)}\n"
         f"phase 5: device time of the pair-HMM and k-mer kernels "
         f"{json.dumps(profile_info['focus'])}")
    # the pair-HMM kernel at the run's fullest bucket, untraced
    golden_bucket = _viterbi_row(
        "the golden run's fullest bucket", *realign._bucket(*fullest["args"]),
        fullest["err"], fullest["args"][2].shape[1], True)
    # the MEC designs at the run's largest observation set, untraced
    from volcanosv_tpu_torch.phasing import phase
    margs, mkw = phase._mec_inputs(*mec_kept["_mec_solve"][0][:-1], "cuda")
    golden_mec = _mec_row("the golden run's largest observation set",
                          margs, **mkw, timed=True)
    golden_mec["designs_ms"] = _mec_designs_in_turns(
        margs, mkw["n_reads"], mkw["n_iter"], golden_mec["snps"])
    _log(f"phase 5: MEC at the run's largest set, designs in turns (ms) "
         f"{json.dumps(golden_mec['designs_ms'])}")
    _log(f"phase 5: device busy {profile_info['busy_ms']:.1f} ms of "
         f"{run_s:.1f} s; profile {json.dumps(profile_info)}")
    gates = _golden_gates(sim_dir, out)
    _log(f"phase 5: golden gates passed {json.dumps(gates)}")
    return dict(run_s=run_s, sim_s=sim_s, stages=stages, launches=launches,
                kernel_launches=kernel_launches,
                pairhmm_viterbi_shapes=pairhmm_shapes,
                pairhmm_buckets=buckets, golden_bucket=golden_bucket,
                mec_shapes=mec_shapes, golden_mec=golden_mec,
                vote_reads=vote_reads,
                kmer_shapes=kmer_shapes, pinned=pinned,
                busy_ms=profile_info["busy_ms"],
                banded_dp_shapes=dp_shapes, tb_walk_shapes=walk_shapes,
                complex_sv_shapes=cx_shapes,
                pairing_launches=sum(r["count"] for r in pairing),
                gates=gates, profile=profile_info)


def start_cpu_side_5b():
    """The CPU side of phase 5b's `run` (its sim written first), started
    (`_start_cpu_cli`) to run beside phase 5."""
    from volcanosv_tpu_torch import cli
    d = os.path.join(WORK, "run_cuda_vs_cpu")
    if cli.main(["sim", "-o", os.path.join(d, "sim")] + RUN_SIM) != 0:
        raise AssertionError("phase 5b: sim failed")
    return _start_cpu_cli(
        _run_args(os.path.join(d, "sim"), os.path.join(d, "out_cpu"),
                  "cpu") + ["--profile"], os.path.join(d, "cpu.log"))


def start_cpu_side_6():
    """The CPU side of phase 6's `qc` (on phase 4's outputs), started
    (`_start_cpu_cli`) after phase 4, to run beside phases 4b-5b."""
    return _start_cpu_cli(
        _qc_args() + ["-o", os.path.join(WORK, "qc", "cpu"), "--device",
                      "cpu"], os.path.join(WORK, "qc", "cpu.log"))


def phase5b_run_cuda_vs_cpu(cpu_proc) -> dict:
    """`run` with --device cuda on the 2 x 50 kb recipe, and the same with
    --device cpu (`cpu_proc`, started by `start_cpu_side_5b`): the six
    outputs and phased.bam byte-identical.  Nothing is caught."""
    from volcanosv_tpu_torch import cli
    from volcanosv_tpu_torch.utils.logging import STAGE_TIMES
    d = os.path.join(WORK, "run_cuda_vs_cpu")
    STAGE_TIMES.clear()
    t0 = time.perf_counter()
    if cli.main(_run_args(os.path.join(d, "sim"), os.path.join(d, "out_cuda"),
                          "cuda")) != 0:
        raise AssertionError("phase 5b: run --device cuda failed")
    secs = {"cuda": time.perf_counter() - t0}
    stages = {"cuda": {k: round(v[0], 3) for k, v in STAGE_TIMES.items()}}
    secs["cpu"] = _join_cpu_cli(cpu_proc, "phase 5b: run")
    with open(os.path.join(d, "out_cpu", "stage_times.json")) as fh:
        stages["cpu"] = {k: v["total_s"] for k, v in json.load(fh).items()}
    outs = {}
    for device in ("cuda", "cpu"):
        outs[device] = {}
        for name in RUN_OUT + ["phased.bam"]:
            outs[device][name] = _read(os.path.join(d, f"out_{device}", name))
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


# the SM clock (the boost clock) that turns a kernel's ms into cycles
SM_HZ = 1.98e9


def _coverage_chain(kind: str, B: int, T: int, S: int) -> int:
    """Window steps on a contig's longest dependent chain in a coverage
    kernel's design (qc/flagger.py's plans): the Viterbi's forward walk
    (T - 1), then its backtrace (a segment's map, the walk over the
    segments' maps, a segment's windows); the forward-backward's segment
    matrix, the boundary walk (forward and backward side by side) and the
    segment's windows forward and back."""
    from volcanosv_tpu_torch.qc import flagger
    if kind == "viterbi":
        p = flagger.viterbi_plan(B, T, S)
        return T - 1 + 2 * p.seg + p.segs - 1
    p = flagger.coverage_plan(B, T, S)
    return 3 * p.seg + p.segs - 1


def _coverage_timed(kind: str, emit: tuple) -> dict:
    """A coverage kernel's device ms a call at these emissions, the steps
    on its longest chain (`_coverage_chain`) and its cycles a step."""
    from volcanosv_tpu_torch.qc import flagger
    T, B, S = emit[0].shape
    kernel = getattr(flagger, f"coverage_{kind}")
    ms = _time_queued_ms(lambda: kernel(*emit))
    steps = _coverage_chain(kind, B, T, S)
    return dict(ms=ms, chain_steps=steps,
                cycles_per_step=ms * 1e-3 * SM_HZ / steps)


def _viterbi_backtrace_split(emit: tuple) -> dict:
    """The Viterbi kernel at its plan's backtrace split against one serial
    walk over the packed pointers (the same kernel launched with one
    segment of T windows), in turns (`_time_turns`): equal labels, and the
    ms a call of each."""
    import torch

    from volcanosv_tpu_torch.ops import cuda_build
    from volcanosv_tpu_torch.qc import flagger
    lib = cuda_build.lib("coverage_hmm")
    T, B, S = emit[0].shape
    plan = flagger.viterbi_plan(B, T, S)
    scratch = torch.empty(plan.scratch, dtype=torch.uint8, device="cuda") \
        if plan.scratch else None
    labels = {n: torch.empty((B, T), dtype=torch.int8, device="cuda")
              for n in ("split", "serial")}

    def launch(name, L, Q):
        def fn():
            cuda_build.check(lib.coverage_viterbi_launch(
                *(x.data_ptr() for x in emit), B, T, S, L, Q, plan.contigs,
                scratch.data_ptr() if scratch is not None else None,
                labels[name].data_ptr(),
                torch.cuda.current_stream().cuda_stream),
                "coverage_viterbi launch", "coverage_hmm")
        return fn

    fns = {"split": launch("split", plan.seg, plan.segs),
           "serial": launch("serial", T, 1)}
    for fn in fns.values():
        fn()
    if not torch.equal(labels["split"], labels["serial"]):
        raise AssertionError("phase 6: the Viterbi's split backtrace != "
                             "its serial walk")
    ms = _time_turns(fns)
    return dict(segments=plan.segs, split_ms=ms["split"],
                serial_ms=ms["serial"])


def _viterbi_step_latency() -> dict:
    """The Viterbi forward walk's step (csrc/coverage_hmm.cu::viterbi_step
    at S = 4), timed by `viterbi_step_chase` over 2^16 steps: cycles and ns
    a step of one warp alone, of one warp on each of an SM's four
    schedulers, and of two on each (twice the cycles there: the
    scheduler's instruction rate sets the step; the same: its latency)."""
    import numpy as np
    import torch

    from volcanosv_tpu_torch.ops import cuda_build
    lib = cuda_build.lib("coverage_hmm")
    rng = np.random.default_rng(11)
    init = torch.tensor(np.concatenate([np.log(rng.dirichlet(np.ones(4), 4))
                                        .ravel(), rng.normal(0, 3, 32)]),
                        dtype=torch.float32, device="cuda")
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    n = 1 << 16
    res = {}
    for warps in (1, 4, 8):
        cuda_build.check(lib.viterbi_step_chase(
            init.data_ptr(), warps, n, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream),
            "viterbi_step_chase", "coverage_hmm")
        cycles, ns, _ = out.tolist()
        res[f"warps_{warps}"] = dict(cycles=cycles / n, ns=ns / n)
    return res


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
    """fn() with every launch count set to 0 first: (its result, the counts
    after, the launches' shapes: banded_dp's (mode, design, B, M, W),
    tb_walk's (design, B, M, W), and the coverage kernels' (B, T, S))."""
    _reset_counts()
    out = fn()
    w = _wrappers()
    return out, _counts(), \
        (list(w["banded_dp"].shapes), list(w["tb_walk"].shapes),
         list(w["coverage_viterbi"].shapes),
         list(w["coverage_posteriors"].shapes))


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


def _cli_cuda_vs_cpu(args, out_dir: str, names: list[str], tag: str,
                     cpu_proc=None):
    """One CLI command with --device cuda and --device cpu into
    out_dir/{cuda,cpu} (the CPU side: `cpu_proc` where one was started
    with `_start_cpu_cli`): the named outputs byte-identical.  Returns the
    seconds on each, the card's launches and their shapes
    (`_count_kernels`) and the output sizes."""
    from volcanosv_tpu_torch import cli
    secs, outs, launches, shapes = {}, {}, None, None
    for device in ("cuda", "cpu"):
        out = os.path.join(out_dir, device)
        if device == "cpu" and cpu_proc is not None:
            secs[device] = _join_cpu_cli(cpu_proc, f"phase 6: {tag}")
        else:
            t0 = time.perf_counter()
            rc, counts, launched = _count_kernels(
                lambda: cli.main(args + ["-o", out, "--device", device]))
            secs[device] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"phase 6: {tag} --device {device} "
                                     "failed")
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


def _hmm_at_scale(seed: int, qc_shapes: list) -> dict:
    """The coverage HMM at chromosome scale (`_coverage_case`), card
    against CPU: fit_coverage_hmm (the same iterations; λ, τ and means
    within rtol 1e-4); the two kernels against their plain versions on the
    card and on the CPU: Viterbi labels equal, the kernel's posteriors no
    further from a float64 forward-backward than twice the CPU's; each
    timed beside its bound.  Then `_hmm_edges` at the tie-rich batches and
    at qc's most launched shape (`qc_shapes`, (B, T, S) tuples)."""
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
    emit = {d: hmm._emissions(cov, valid, torch.device(d))
            for d in ("cpu", "cuda")}
    exact = flagger.posteriors_float64(hmm, cov, valid).transpose(1, 0, 2)
    for kind in ("viterbi", "posteriors"):
        kernel = getattr(flagger, f"coverage_{kind}")
        plain = getattr(flagger, f"_{kind}_plain")
        t0 = time.perf_counter()
        want = plain(*emit["cpu"]).numpy()
        cpu_ms = (time.perf_counter() - t0) * 1e3
        on_card, plain_ms = _timed_once(lambda: plain(*emit["cuda"]))
        got = kernel(*emit["cuda"]).cpu().numpy()
        on_card = on_card.cpu().numpy()
        timed = _coverage_timed(kind, emit["cuda"])
        ms = timed["ms"]
        # the method as qc calls it: emissions made on the card, the
        # kernel, the result copied to the host
        t0 = time.perf_counter()
        getattr(hmm, kind)(cov, valid, "cuda")
        method_ms = (time.perf_counter() - t0) * 1e3
        out_bytes = 1 if kind == "viterbi" else 4 * S
        row = dict(name=f"coverage_{kind}", B=B, T=T, S=S,
                   windows=int(valid.sum()), plain_ms=plain_ms,
                   cpu_ms=cpu_ms, method_ms=method_ms, **timed,
                   **_bound(n_win * (5 + out_bytes), n_win * _hmm_ops(S, kind),
                            FP32_OPS_PER_S))
        row["share_of_bound"] = row["bound_ms"] / ms
        if kind == "viterbi":
            # the forward walk's floor: T - 1 steps of one warp alone
            step = _viterbi_step_latency()
            row.update(step_probe=step,
                       chain_ms=(T - 1) * step["warps_1"]["ns"] * 1e-6,
                       backtrace=_viterbi_backtrace_split(emit["cuda"]))
            # emissions and transitions are the same bits on both devices
            # and the recursion is adds and maxes: the labels are equal
            if not (np.array_equal(got, on_card)
                    and np.array_equal(got, want)):
                raise AssertionError("phase 6: Viterbi labels of the kernel "
                                     "!= the plain version's")
            row.update(labels_equal=True, max_abs_err=0.0)
        else:
            # float32 sums of 5000 windows' log likelihoods round at
            # |alpha| x 6e-8, and the card's exp and log round differently
            # from the CPU's: the kernel is held to the float64
            # forward-backward, at most twice as far from it as the CPU
            cpu_err = float(np.abs(want - exact).max())
            card_err = float(np.abs(got - exact).max())
            row.update(max_abs_err=float(np.abs(got - on_card).max()),
                       card_vs_f64=card_err, cpu_vs_f64=cpu_err,
                       plain_card_vs_f64=float(np.abs(on_card - exact).max()),
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
    return dict(contigs=len(lens), windows=int(valid.sum()), rows=rows,
                edges=_hmm_edges(qc_shapes))


# the tie-rich batches of the coverage kernels' check, (S, B, T);
# tests/torch_inputs.py::hmm_tie_case's inputs, copied since the smoke run
# imports no tests
HMM_EDGES = [(S, B, T) for S in (3, 4, 5) for B, T in ((3, 1), (3, 2),
                                                       (8, 300), (9, 241))] \
    + [(4, 9, 4915), (4, 9, 4928)]
STATE_MULTS = {3: [0.05, 1.0, 2.0], 4: [0.05, 0.5, 1.0, 2.0],
               5: [0.05, 0.5, 1.0, 2.0, 4.0]}


def _hmm_tie_case(rng, n_states: int, B: int, T: int):
    """(means, tau, cov, valid): row 0 full, row 1 all padding (equal
    scores in every state), the rest ragged; the two highest states share
    one mean (tests/torch_inputs.py::hmm_tie_case)."""
    import numpy as np
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


def _hmm_edges(qc_shapes: list) -> list[dict]:
    """Both coverage kernels against their plain versions on the card and
    on the CPU at HMM_EDGES and at qc's most launched (B, T, S), on
    tie-rich inputs: labels equal; posteriors no further from float64 than
    1e-5 or twice the CPU's distance (tests/test_torch_qc.py's tolerance).
    Each shape is timed, and qc's plain versions too."""
    from collections import Counter

    import numpy as np
    import torch

    from volcanosv_tpu_torch.qc import flagger
    rng = np.random.default_rng(26)
    cases = [(f"ties S={S} B={B} T={T}", S, B, T) for S, B, T in HMM_EDGES]
    if qc_shapes:
        (B, T, S), _n = Counter(map(tuple, qc_shapes)).most_common(1)[0]
        cases.append(("qc's top shape", S, B, T))
    rows = []
    for name, S, B, T in cases:
        means, tau, cov, valid = _hmm_tie_case(rng, S, B, T)
        hmm = flagger.CoverageHMM(means=means, tau=tau)
        emit = {d: hmm._emissions(cov, valid, torch.device(d))
                for d in ("cpu", "cuda")}
        labels = [flagger.coverage_viterbi(*emit["cuda"]),
                  flagger._viterbi_plain(*emit["cuda"]),
                  flagger._viterbi_plain(*emit["cpu"])]
        labels = [x.cpu().numpy() for x in labels]
        post = [flagger.coverage_posteriors(*emit["cuda"]),
                flagger._posteriors_plain(*emit["cuda"]),
                flagger._posteriors_plain(*emit["cpu"])]
        post = [x.cpu().numpy() for x in post]
        exact = flagger.posteriors_float64(hmm, cov, valid).transpose(1, 0, 2)
        card_err, _, cpu_err = (float(np.abs(p - exact).max()) for p in post)
        row = dict(name=name, B=B, T=T, S=S,
                   labels_equal=bool(np.array_equal(labels[0], labels[1])
                                     and np.array_equal(labels[0],
                                                        labels[2])),
                   max_abs_err=float(np.abs(post[0] - post[1]).max()),
                   card_vs_f64=card_err, cpu_vs_f64=cpu_err,
                   tolerance=max(1e-5, 2 * cpu_err))
        if not row["labels_equal"] or card_err > row["tolerance"]:
            raise AssertionError(f"phase 6: coverage kernels != plain "
                                 f"{json.dumps(row)}")
        for kind in ("viterbi", "posteriors"):
            row[kind] = _coverage_timed(kind, emit["cuda"])
        if name == "qc's top shape":
            for kind in ("viterbi", "posteriors"):
                plain = getattr(flagger, f"_{kind}_plain")
                row[kind]["plain_ms"] = _timed_once(
                    lambda: plain(*emit["cuda"]))[1]
            row["viterbi"]["backtrace"] = _viterbi_backtrace_split(
                emit["cuda"])
        rows.append(row)
        _log(f"phase 6: {json.dumps(row)}")
    return rows


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


def _qc_args() -> list[str]:
    """`qc` on phase 4's contigs and reads."""
    d4 = os.path.join(WORK, "asm")
    return ["qc", "--ref", os.path.join(d4, "ref.fa"),
            "--contig", os.path.join(d4, "out", "final_contigs.fa"),
            "--fastq", os.path.join(d4, "reads.fastq")]


def phase6_qc_sd(seed: int, qc_cpu) -> dict:
    """QC and SD recovery on the card: `qc` on phase 4's contigs and reads
    (its CPU side `qc_cpu`, started by `start_cpu_side_6`), the
    coverage HMM at chromosome scale, `sd_recover` and `asm --sd` on phase
    4b's HiFi case, each on cuda against cpu."""
    info = {}
    info["qc"] = _cli_cuda_vs_cpu(_qc_args(), os.path.join(WORK, "qc"),
                                  ["flagger_blocks.bed"], "qc", qc_cpu)
    for name in ("banded_dp", "coverage_viterbi", "coverage_posteriors"):
        if info["qc"]["launches"][name] <= 0:
            raise AssertionError(f"phase 6: qc launched no {name}")
    _log(f"phase 6: qc on phase 4's contigs, flagger_blocks.bed "
         f"byte-identical on cuda and cpu {json.dumps(info['qc'])}")
    info["hmm"] = _hmm_at_scale(seed, info["qc"]["shapes"][2])
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
    launched = {k: n for k, n in launches.items() if n}
    if not split == unsplit == want or launched != {"banded_dp": 2,
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


# tests/test_golden_dtype.py's SIM and CASES (copied: the smoke run imports
# no tests): 1 x 200 kb, the full SV mix, 25x, 8 kb reads; per read type
# its --err and its floors: SV recall, precision and GT, SNP precision and
# recall (and a switch error of at most 0.05)
DTYPE_SIM = ["--length", "200000", "--chroms", "1",
             "--n_del", "6", "--n_ins", "6", "--n_inv", "2", "--n_dup", "2",
             "--n_clustered", "2", "--n_nested", "1", "--n_small", "5",
             "--coverage", "25", "--read_len", "8000", "--seed", "23"]
DTYPE_CASES = [("CLR", 0.09, 0.90, 0.90, 0.80, 0.85, 0.80),
               ("ONT", 0.06, 0.90, 0.95, 0.85, 0.80, 0.90)]
# the JAX package's CLR and ONT sim inputs and `run` outputs: sha256 and
# sizes (tools/pin_golden_dtype.py, on the CPU), and each merged VCF
DTYPE_PIN = os.path.join(REPO, "tests", "data", "golden_dtype_sha256.json")


def _dtype_gates(sim_dir: str, out: str, floors) -> dict:
    """tests/test_golden_dtype.py's floors on `run`'s outputs, through the
    port's eval on the card."""
    from volcanosv_tpu_torch.eval import (EvalParams, evaluate_files,
                                          evaluate_snp_files)
    min_r, min_p, min_gt, min_sp, min_sr = floors
    sv = evaluate_files(os.path.join(sim_dir, "truth.vcf"),
                        os.path.join(out, "volcanosv_variants.vcf"),
                        EvalParams(pctsim=0.0), device="cuda")
    snp = evaluate_snp_files(os.path.join(sim_dir, "truth_snps.vcf"),
                             os.path.join(out, "phased_snps.vcf"))
    gates = dict(sv=sv.summary(), snp=snp)
    failed = [name for name, ok in (
        ("sv recall", sv.recall >= min_r),
        ("sv precision", sv.precision >= min_p),
        ("sv gt", sv.gt_concordance >= min_gt),
        ("snp precision", snp["snp_precision"] >= min_sp),
        ("snp recall", snp["snp_recall"] >= min_sr),
        ("switch error", snp["switch_error_rate"] <= 0.05)) if not ok]
    if failed:
        raise AssertionError(f"phase 8: floors failed {failed}: "
                             f"{json.dumps(gates)}")
    return gates


def _run_shapes() -> dict:
    """Every kernel of `run` by its launches' shapes since the counts were
    set to 0: the DP's (mode, design, B, M, W), the walk's (design, B, M,
    W), the pair-HMM's (B, R, W), the MEC's (O, restarts, S, R) with the
    design `mec_plan` takes, and the k-mer kernels'."""
    from volcanosv_tpu_torch.ops import banded_align as ba
    from volcanosv_tpu_torch.phasing import phase
    mec_shapes = []
    for O, NR, S, R in _wrappers()["mec_phase"].shapes:
        branch, ctas = phase.mec_design(S, R, O)
        mec_shapes.append(dict(O=O, NR=NR, S=S, R=R,
                               design=_mec_design_name(branch, ctas or None)))
    return dict(
        banded_dp=_dp_shapes(ba.banded_dp.shapes),
        tb_walk=_walk_shapes(ba.tb_walk.shapes),
        pairhmm_viterbi=_shape_counts(_wrappers()["pairhmm_viterbi"].shapes,
                                      ("B", "R", "W")),
        mec_phase=mec_shapes, **_kmer_shapes())


def _noisy_run(dtype: str, err: float, floors, pin: dict) -> dict:
    """`sim` at DTYPE_SIM and `err`, then `run --device cuda -d dtype`,
    traced on the card for its busy time: the sim's inputs and the six
    outputs must be the pinned JAX bytes, the calls must meet the floors,
    and the pair-HMM and the MEC kernels must have launched.  Then the
    pair-HMM kernel at the run's fullest bucket, the MEC kernel at its
    largest observation set (every design in turns) and the three k-mer
    kernels at its inputs (`_kmer_rows`), each against its plain version
    and timed beside its bound."""
    from volcanosv_tpu_torch import cli
    from volcanosv_tpu_torch.phasing import phase, realign
    from volcanosv_tpu_torch.utils.logging import STAGE_TIMES, stage_report
    tag = f"phase 8: run -d {dtype}"
    d = os.path.join(WORK, f"dtype_{dtype}")
    sim_dir, out = os.path.join(d, "sim"), os.path.join(d, "out")
    sim_args = DTYPE_SIM + ["--err", str(err)]
    t0 = time.perf_counter()
    if cli.main(["sim", "-o", sim_dir] + sim_args) != 0:
        raise AssertionError(f"{tag}: sim failed")
    sim_s = time.perf_counter() - t0
    buckets, vote_reads, fullest = [], [], {}
    undo_buckets = _watch_buckets(buckets, vote_reads, fullest)
    calls, kept = {}, {}
    undo = _watch(calls, kept)
    rc, run_s, prof = _traced_cli(
        _run_args(sim_dir, out, "cuda") + ["-d", dtype], (undo, undo_buckets))
    kernel_launches = _counts()
    shapes = _run_shapes()
    mec_shapes = shapes["mec_phase"]
    stages = {k: round(v[0], 3) for k, v in STAGE_TIMES.items()}
    if rc != 0:
        raise AssertionError(f"{tag} exited {rc}")
    pinned = _check_pin(pin, sim_args, sim_dir, out, os.path.join(
        REPO, "tests", "data", f"golden_dtype_{dtype}_variants.vcf"), tag)
    for name in ("pairhmm_viterbi", "mec_phase", "ava_overlaps"):
        if kernel_launches[name] <= 0:
            raise AssertionError(f"{tag}: {name} never launched")
    _log(f"{tag}: the sim's inputs and run's six outputs are the JAX "
         f"package's pinned bytes {json.dumps(pinned)}\n"
         f"{tag}: {run_s:.1f} s, launches {kernel_launches}\n"
         f"{tag}: launches by shape {json.dumps(shapes)}\n" + stage_report())
    profile_info = _profile_summary(prof, run_s)
    _log(f"{tag}: device busy {profile_info['busy_ms']:.1f} ms of "
         f"{run_s:.1f} s; pair-HMM launches {json.dumps(buckets)}; profile "
         f"{json.dumps(profile_info)}")
    gates = _dtype_gates(sim_dir, out, floors)
    _log(f"{tag}: floors met {json.dumps(gates)}")
    # the run's new shapes, untraced
    bucket = _viterbi_row(
        f"the {dtype} run's fullest bucket",
        *realign._bucket(*fullest["args"]), fullest["err"],
        fullest["args"][2].shape[1], True)
    margs, mkw = phase._mec_inputs(*kept["_mec_solve"][0][:-1], "cuda")
    mec = _mec_row(f"the {dtype} run's largest observation set", margs,
                   **mkw, cpu=True, timed=True)
    mec["designs_ms"] = _mec_designs_in_turns(margs, mkw["n_reads"],
                                              mkw["n_iter"], mec["snps"])
    kmer_rows = _kmer_rows(kept)
    return dict(dtype=dtype, err=err, sim_s=sim_s, run_s=run_s,
                stages=stages, kernel_launches=kernel_launches,
                shapes=shapes, pairhmm_buckets=buckets,
                vote_reads=vote_reads, pinned=pinned,
                busy_ms=profile_info["busy_ms"], profile=profile_info,
                gates=gates, pairhmm_bucket=bucket, mec=mec, kmer=kmer_rows)


def phase8_noisy_runs() -> dict:
    """`run --device cuda` with CLR and with ONT reads at
    tests/test_golden_dtype.py's recipe, held to the JAX package's pin
    (tests/data/golden_dtype_sha256.json) and that file's floors
    (`_noisy_run`)."""
    with open(DTYPE_PIN) as fh:
        pin = json.load(fh)["types"]
    return {dtype: _noisy_run(dtype, err, floors, pin[dtype])
            for dtype, err, *floors in DTYPE_CASES}


def _new_dp_classes(rows: list[dict], shapes: list[dict], check) -> list:
    """The DP or walk launches of a path whose (mode, design, W) no row of
    `rows` holds: check(top) at the largest B x M launch of each such
    class; returns the new rows."""
    keys = [k for k in ("mode", "branch", "W") if k in shapes[0]]
    held = {tuple(r[k] for k in keys) for r in rows}
    tops = {}
    for sh in shapes:
        cls = tuple(sh[k] for k in keys)
        if cls not in held and (cls not in tops or sh["B"] * sh["M"] >
                                tops[cls]["B"] * tops[cls]["M"]):
            tops[cls] = sh
    return [check(top) for top in tops.values()]


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


def _scan_kernel_entries(info: dict, rng) -> list[dict]:
    """The kernels-line entries of the pair-HMM kernel (launches on the
    golden `run`, phase 5; checked and timed in phase 4b at the shape that
    run launched most, or here when 4b lacks it) and of the two coverage
    kernels (launches on `qc` and `asm --sd`, times at chromosome scale,
    phase 6)."""
    vrows = info["asm_cuda_vs_cpu"]["pairhmm_viterbi"]
    top = info["run"]["pairhmm_viterbi_shapes"][0]
    key = (top["B"], top["R"], top["W"])
    head = next((r for r in vrows if "ms" in r
                 and (r["B"], r["R"], r["W"]) == key), None)
    if head is None:
        B, R, W = key
        segs, lens, haps = _viterbi_pairs(rng, B, R, W, 0.002)
        head = _viterbi_row("the golden run's top shape", segs, lens, haps,
                            0.002, W, True)
        vrows = vrows + [head]
    run = info["run"]
    focus = run["profile"]["focus"]
    entries = [dict(
        name="pairhmm_viterbi", route="cuda",
        source="volcanosv_tpu_torch/csrc/pairhmm.cu",
        replaces="volcanosv_tpu/phasing/realign.py:35",
        path="run (golden sim)", design=head["design"],
        launches=run["kernel_launches"]["pairhmm_viterbi"],
        **{f"launches_asm_{t}": info["asm_cuda_vs_cpu"][t][
            "kernel_launches"]["pairhmm_viterbi"] for t in ("clr", "ont")},
        max_abs_err=max(r["max_abs_err"] for r in vrows), ms=head["ms"],
        plain_ms=head["plain_ms"],
        cpu_ms=head["cpu_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None,
        golden_bucket=run["golden_bucket"],
        real_pairs=[b["real"] for b in run["pairhmm_buckets"]],
        mixed_warps=sum(b["mixed_warps"] for b in run["pairhmm_buckets"]),
        trace={k: v for k, v in focus.items() if "pairhmm" in k},
        shapes=vrows)]
    hmm = info["qc_sd"]["hmm"]
    qc_sd = [info["qc_sd"][k]["launches"] for k in ("qc", "asm_sd")]
    for kind, line in (("viterbi", 120), ("posteriors", 146)):
        name = f"coverage_{kind}"
        row = next(r for r in hmm["rows"] if r["name"] == name)
        entries.append(dict(
            name=name, route="cuda",
            source="volcanosv_tpu_torch/csrc/coverage_hmm.cu",
            replaces=f"volcanosv_tpu/qc/flagger.py:{line}",
            path="qc and asm --sd", launches=sum(c[name] for c in qc_sd),
            max_abs_err=max([row["max_abs_err"]] + (
                [e["max_abs_err"] for e in hmm["edges"]]
                if kind == "posteriors" else [])),
            ms=row["ms"], plain_ms=row["plain_ms"], cpu_ms=row["cpu_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None, cycles_per_step=row["cycles_per_step"],
            **({"chain_ms": row["chain_ms"]} if kind == "viterbi" else {}),
            shapes=[row] + hmm["edges"]))
    return entries


def _kmer_kernel_entries(info: dict) -> list[dict]:
    """The kernels-line entries of the three k-mer kernels: launches on the
    golden `run` (phase 5) and on `asm` (phase 4), checked and timed at
    phase 4's kept inputs (4b), the error the largest over those and the
    edge cases (exact: 0)."""
    src = dict(route="cuda", source="volcanosv_tpu_torch/csrc/kmer.cu")
    replaces = {"kmer_count": "volcanosv_tpu/ops/kmer.py:45",
                "unique_mask": "volcanosv_tpu/ops/kmer.py:89",
                "kmer_vote": "volcanosv_tpu/ops/kmer.py:100"}
    rows = info["asm_cuda_vs_cpu"]["kmer"]
    edges = info["asm_cuda_vs_cpu"]["kmer_edges"]
    focus = info["run"]["profile"]["focus"]
    entries = []
    for row in rows:
        name = row["name"]
        mine = [e for e in edges if e["name"] == name]
        extra = {}
        if name == "kmer_count":
            extra = dict(
                design="atomic", probes=row["probes"],
                trace={k: v for k, v in focus.items() if "kmer_count" in k})
        if name == "kmer_vote":
            extra = dict(
                design=row["design"], cold_ms=row["cold_ms"],
                real_reads=info["run"]["vote_reads"],
                trace={k: v for k, v in focus.items() if "kmer_vote" in k})
        entries.append(dict(
            name=name, **src, replaces=replaces[name],
            path="run (golden sim)",
            launches=info["run"]["kernel_launches"][name],
            launches_asm=info["asm"]["kernel_launches"][name],
            max_abs_err=max([row["max_abs_err"]] + [e.get("max_abs_err", 0)
                                                    for e in mine]),
            ms=row["ms"], plain_ms=row["plain_ms"], cpu_ms=row["cpu_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], **extra, shapes=[row] + mine))
    return entries


def _mec_kernel_entries(info: dict) -> list[dict]:
    """The kernels-line entries of the MEC kernel (launches on the golden
    `run` and on `asm`, checked and timed at phase 4's largest observation
    set, the chromosome-scale row, the threshold pair and the edge cases
    beside it) and of canonical_hashes' (on no path: 0 launches; timed at
    2^21 hashes and k 12)."""
    mec = info["asm_cuda_vs_cpu"]["mec"]
    asm = mec["asm"]
    canon = info["asm_cuda_vs_cpu"]["canonical"]
    k12 = next(r for r in canon if r["k"] == 12)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    return [
        dict(name="mec_phase", route="cuda",
             source="volcanosv_tpu_torch/csrc/mec.cu",
             replaces="volcanosv_tpu/phasing/phase.py:63",
             path="run (golden sim)", design=asm["design"],
             launches=info["run"]["kernel_launches"]["mec_phase"],
             launches_asm=info["asm"]["kernel_launches"]["mec_phase"],
             max_abs_err=0, cpu_ms=asm["cpu_ms"],
             **{k: asm[k] for k in keys}, library_ms=None,
             chain_ms=asm["chain_ms"], designs_ms=asm["designs_ms"],
             barriers=mec["barriers"], one_cta_limit=mec["one_cta_limit"],
             golden_shapes=info["run"]["mec_shapes"],
             golden_set=info["run"]["golden_mec"],
             trace={k: v for k, v in info["run"]["profile"]["focus"].items()
                    if "mec_" in k},
             shapes=[asm, mec["chromosome"]] + mec["threshold"]
             + mec["edges"]),
        dict(name="canonical_hashes", route="cuda",
             source="volcanosv_tpu_torch/csrc/kmer.cu",
             replaces="volcanosv_tpu/ops/kmer.py:63", path=None,
             launches=info["run"]["kernel_launches"]["canonical_hashes"],
             max_abs_err=0, cpu_ms=k12["cpu_ms"],
             **{k: k12[k] for k in keys}, library_ms=None,
             shapes=canon),
    ]


def _add_run_rows(kernels: list, run: dict, suffix: str) -> None:
    """Into each wrapper's kernels-line entry: its launches on `run` (a
    `run` of phase 8, 9 or 10) as `launches_<suffix>` and, for the
    pair-HMM, MEC and k-mer kernels, their rows at that run's inputs
    (`max_abs_err` taken over them too)."""
    for e in kernels:
        if e["name"] not in run["kernel_launches"]:
            continue
        e[f"launches_{suffix}"] = run["kernel_launches"][e["name"]]
        rows = {"pairhmm_viterbi": [run["pairhmm_bucket"]],
                "mec_phase": [run["mec"]]}.get(
            e["name"], [r for r in run["kmer"] if r["name"] == e["name"]])
        e["shapes"] = e["shapes"] + rows
        e["max_abs_err"] = max([e["max_abs_err"]]
                               + [r["max_abs_err"] for r in rows])


# tools/pin_scale_run.py's pin of tools/scale_run.py's 5 Mb row (the JAX
# package on the CPU): the arguments, the sim's inputs and `run`'s six
# outputs, and the same of its 10 Mb row under "rows" → "10"; and the 5 Mb
# row's merged VCF for a diff (the 10 Mb row's:
# scale_run_10mb_variants.vcf)
SCALE_PIN = os.path.join(REPO, "tests", "data", "scale_run_sha256.json")
SCALE_VARIANTS = os.path.join(REPO, "tests", "data",
                              "scale_run_variants.vcf")
# the scale runs' floor on SV recall, precision and GT against the truth
SCALE_FLOOR = 0.95


def _scale_args(pin: dict, mb: float) -> list[str]:
    """The pin's arguments at `mb` Mb: tools/scale_run.py's recipe at 24x
    (seed 11, 9 kb HiFi reads at err 0.002)."""
    args = pin["scale_args"]
    i = args.index("--mb")
    return args[:i + 1] + [f"{mb:g}"] + args[i + 2:]


def phase9_scale_run(args: list[str], pin,
                     variants: str = SCALE_VARIANTS) -> dict:
    """tools/scale_run_torch.py (the port's twin of tools/scale_run.py)
    with `--device cuda` at `args`: `sim`, then `run --profile --resume` on
    one chromosome, then the port's eval on the card.  With `pin` the sim's
    inputs and the six outputs must be the JAX package's pinned bytes
    (a mismatch prints the merged VCF's diff against `variants`).  SV
    recall, precision and GT must reach SCALE_FLOOR.  Prints the stage
    table, peak RSS and device memory, the launches by shape (the MEC's
    (O, restarts, S, R) with the design `mec_plan` takes) and the k-mer
    tables built against the partition's cap; then, untraced, the pair-HMM
    kernel at the run's fullest bucket, the MEC kernel at its largest
    observation set (every design in turns) and the three k-mer kernels at
    its largest chunk, each against its plain version and timed beside its
    bound."""
    from volcanosv_tpu_torch.phasing import phase, realign
    from volcanosv_tpu_torch.utils.logging import stage_report
    mb = float(args[args.index("--mb") + 1])
    tag = f"phase 9: scale run {mb:g} Mb"
    d = os.path.join(WORK, f"scale{mb:g}")
    report_path = os.path.join(d, "scale_torch.json")
    buckets, vote_reads, fullest = [], [], {}
    undo_buckets = _watch_buckets(buckets, vote_reads, fullest)
    calls, kept = {}, {}
    undo = _watch(calls, kept)
    _reset_counts()
    t0 = time.perf_counter()
    try:
        # the tool prints its report; this script's standard output ends
        # with the contract's lines alone
        with contextlib.redirect_stdout(sys.stderr):
            rc = _scale_tool().main(args + ["--work", d, "--out",
                                            report_path, "--device", "cuda"])
    finally:
        undo()
        undo_buckets()
    wall_s = time.perf_counter() - t0
    kernel_launches = _counts()
    shapes = _run_shapes()
    mec_shapes = shapes["mec_phase"]
    if rc != 0:
        raise AssertionError(f"{tag}: tools/scale_run_torch.py exited {rc}")
    with open(report_path) as fh:
        report = json.load(fh)
    pinned = None
    if pin is not None:
        pinned = _check_pin(pin, args, os.path.join(d, "sim"),
                            os.path.join(d, "out"), variants, tag,
                            "scale_args")
        _log(f"{tag}: the sim's inputs and run's six outputs are the JAX "
             f"package's pinned bytes {json.dumps(pinned)}")
    for name in ("banded_dp", "tb_walk", "pairhmm_viterbi", "mec_phase",
                 "ava_overlaps", *KMER_KERNELS):
        if kernel_launches[name] <= 0:
            raise AssertionError(f"{tag}: {name} never launched")
    acc = report["accuracy"]
    _log(f"{tag}: {report['pipeline_wall_s']} s ({report['s_per_mb']} s a "
         f"Mb; {wall_s:.1f} s with the sim and eval), peak RSS "
         f"{report['peak_rss_gb']} GB, peak device memory "
         f"{report['device_max_allocated_gb']} GB allocated, "
         f"{report['device_max_reserved_gb']} GB reserved, on "
         f"{report['card']}\n"
         f"{tag}: SV accuracy (the port's eval on the card) "
         f"{json.dumps(acc)}\n"
         f"{tag}: launches {json.dumps(kernel_launches)}\n"
         f"{tag}: launches by shape {json.dumps(shapes)}\n"
         f"{tag}: k-mer tables built {json.dumps(report['partition_tables'])}"
         f"\n" + stage_report())
    low = [k for k in ("recall", "precision", "gt_concordance")
           if acc[k] < SCALE_FLOOR]
    if low:
        raise AssertionError(f"{tag}: {low} below {SCALE_FLOOR}: "
                             f"{json.dumps(acc)}")
    top = max(mec_shapes, key=lambda r: r["O"])
    beyond = [r for r in mec_shapes if r["design"] != "smem/1"]
    if beyond:
        _log(f"{tag}: MEC launches past one CTA a restart "
             f"{json.dumps(beyond)}")
    else:
        _log(f"{tag}: every MEC launch took one CTA a restart; the largest "
             f"set has O = {top['O']} (one CTA up to "
             f"{phase.MEC_ONE_CTA_MAX_OBS})")
    if not fullest:
        raise AssertionError(f"{tag}: no pair-HMM bucket was kept")
    bucket = _viterbi_row(
        f"the {mb:g} Mb run's fullest bucket",
        *realign._bucket(*fullest["args"]), fullest["err"],
        fullest["args"][2].shape[1], True)
    margs, mkw = phase._mec_inputs(*kept["_mec_solve"][0][:-1], "cuda")
    mec = _mec_row(f"the {mb:g} Mb run's largest observation set", margs,
                   **mkw, cpu=True, timed=True)
    mec["designs_ms"] = _mec_designs_in_turns(margs, mkw["n_reads"],
                                              mkw["n_iter"], mec["snps"])
    _log(f"{tag}: MEC at the run's largest set, designs in turns (ms) "
         f"{json.dumps(mec['designs_ms'])}")
    kmer_rows = _kmer_rows(kept)
    return dict(args=args, wall_s=wall_s, report=report,
                kernel_launches=kernel_launches, shapes=shapes,
                pairhmm_buckets=len(buckets),
                pairhmm_real_pairs=sum(b["real"] for b in buckets),
                vote_chunks=len(vote_reads), pinned=pinned,
                mec_past_one_cta=len(beyond), mec_largest_O=top["O"],
                pairhmm_bucket=bucket, mec=mec, kmer=kmer_rows)


def _scale_only(mb: float, seed: int, smi: str) -> int:
    """`--scale MB`: phase 9 at MB Mb, held to the pin's row of that length
    where it has one (5 Mb at its top level, 10 Mb under "rows"), then the
    DP and the walk at the largest launch of each (mode, design, W) of the
    run (`_new_dp_classes` against no rows).  Prints the phase's summary,
    the card and the kernels' rows."""
    import numpy as np
    import torch
    with open(SCALE_PIN) as fh:
        pin = json.load(fh)
    args = _scale_args(pin, mb)
    row, variants = (pin, SCALE_VARIANTS) if args == pin["scale_args"] \
        else (pin.get("rows", {}).get(f"{mb:g}"), os.path.join(
            REPO, "tests", "data", f"scale_run_{mb:g}mb_variants.vcf"))
    scale = phase9_scale_run(args, row, variants)
    smem = _smem_latency()
    rng = np.random.default_rng(seed + 9)

    def check(top):
        row, wrow = _check_top_shape(rng, smem, top)
        return row if "mode" in top else wrow
    dp, walk = scale["shapes"]["banded_dp"], scale["shapes"]["tb_walk"]
    scale["dp_classes"] = _new_dp_classes([], dp, check) \
        + _new_dp_classes([], walk, check)
    _log(f"phase 9: the DP and the walk at the largest launch of each "
         f"class {json.dumps(scale['dp_classes'])}")
    print(json.dumps(scale))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# tools/pin_repeat_run.py's pin (the JAX package on the CPU) of
# tests/test_repeat_rich.py's sim and of `run` on its FASTQ, on the same
# reads as an unaligned BAM and on the FASTQ run's phased.bam; the merged
# VCF of each run, for a diff (the BAM of the FASTQ's reads gives the
# FASTQ run's bytes)
REPEAT_PIN = os.path.join(REPO, "tests", "data", "repeat_run_sha256.json")
REPEAT_VARIANTS = {
    "fastq": os.path.join(REPO, "tests", "data", "repeat_run_variants.vcf"),
    "bam": os.path.join(REPO, "tests", "data", "repeat_run_variants.vcf"),
    "phased_bam": os.path.join(REPO, "tests", "data",
                               "repeat_run_bam_variants.vcf")}
# phase 10's BED: sub-intervals of both chromosomes of phase 5b's recipe
REGION_BED = "chr1\t10000\t30000\nchr2\t5000\t30000\n"
REGION_VCF = {"vc-large-indel": "volcanosv_large_indel.vcf",
              "vc-small-indel": "volcanosv_small_indel.vcf",
              "vc-complex-sv": "volcanosv_complex_sv.vcf"}


def _repeat_tool():
    """tools/pin_repeat_run.py (it imports nothing of JAX until its main
    runs): the sim's recipe, the runs, the floors and `write_reads_bam`."""
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import pin_repeat_run
    return pin_repeat_run


def _region_args() -> dict:
    """Phase 10's restricted commands on phase 5b's sim and the contigs of
    its card run, without `-o` and `--device`: each vc command with `--chrom
    chr2` and with REGION_BED, and vc-large-indel unrestricted.  Returns
    the output's directory name → the arguments."""
    src = os.path.join(WORK, "run_cuda_vs_cpu")
    sim = os.path.join(src, "sim")
    bed = os.path.join(WORK, "region", "sub.bed")
    cases = {}
    for cmd in REGION_VCF:
        base = [cmd, "--ref", os.path.join(sim, "ref.fa"), "--contig",
                os.path.join(src, "out_cuda", "final_contigs.fa"),
                "--fastq", os.path.join(sim, "reads.fastq")]
        if cmd == "vc-large-indel":
            cases[cmd] = base
        cases[f"{cmd}_chrom"] = base + ["--chrom", "chr2"]
        cases[f"{cmd}_bed"] = base + ["--bed", bed]
    return cases


def start_cpu_side_10():
    """The CPU side of phase 10's restricted runs (`_region_args`, on phase
    5b's outputs): one process that runs them in turn beside the card
    (from the end of phase 6 in the whole run)."""
    d = os.path.join(WORK, "region")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "sub.bed"), "w") as fh:
        fh.write(REGION_BED)
    cmds = [args + ["-o", os.path.join(d, "cpu", name), "--device", "cpu"]
            for name, args in _region_args().items()]
    return _start_cpu_cli([json.dumps(cmds)], os.path.join(d, "cpu.log"),
                          CLI_SEQ_TIMED)


def _region_cuda_vs_cpu(cpu_proc) -> dict:
    """Phase 10's restricted runs on the card, then joined with their CPU
    side (`start_cpu_side_10`): each VCF byte-identical on cuda and cpu;
    each command with records in a restricted VCF; vc-large-indel's `--chrom
    chr2` records the (pos, svtype, svlen) of the unrestricted run's chr2
    records (tests/test_cli_multichrom.py's subset)."""
    from volcanosv_tpu_torch import cli
    from volcanosv_tpu_torch.io.vcf import read_vcf
    d = os.path.join(WORK, "region")
    cases = _region_args()
    secs, launches, recs = {"cuda": {}}, {}, {}
    for name, args in cases.items():
        t0 = time.perf_counter()
        rc, launches[name], _shapes = _count_kernels(
            lambda a=args, n=name: cli.main(
                a + ["-o", os.path.join(d, "cuda", n), "--device", "cuda"]))
        secs["cuda"][name] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"phase 10: {name} --device cuda failed")
        if launches[name]["banded_dp"] <= 0:
            raise AssertionError(f"phase 10: {name} launched no DP")
    secs["cpu"] = dict(zip(cases, _join_cpu_cli(
        cpu_proc, "phase 10: restricted runs")))
    for name, args in cases.items():
        vcf = REGION_VCF[args[0]]
        got, want = (_read(os.path.join(d, dev, name, vcf))
                     for dev in ("cuda", "cpu"))
        if got != want or not want:
            raise AssertionError(f"phase 10: {name} {vcf} differs between "
                                 "cuda and cpu")
        _h, r = read_vcf(os.path.join(d, "cuda", name, vcf))
        recs[name] = [(x.chrom, x.pos, x.svtype, x.svlen) for x in r]
    for cmd in REGION_VCF:
        if not (recs[f"{cmd}_chrom"] or recs[f"{cmd}_bed"]):
            raise AssertionError(f"phase 10: {cmd} has no record in a "
                                 "restricted run")
    chr2 = [x[1:] for x in recs["vc-large-indel"] if x[0] == "chr2"]
    got = recs["vc-large-indel_chrom"]
    if not chr2 or {x[0] for x in got} != {"chr2"} \
            or [x[1:] for x in got] != chr2:
        raise AssertionError(f"phase 10: vc-large-indel --chrom chr2 gave "
                             f"{got}, not the unrestricted run's chr2 "
                             f"records {chr2}")
    info = dict(s=secs, launches=launches,
                records={n: len(r) for n, r in recs.items()})
    _log(f"phase 10: restricted runs byte-identical on cuda and cpu "
         f"{json.dumps(info)}")
    return info


def _repeat_pinned(pin: dict, run: str, sim_dir: str, out: str,
                   tag: str) -> dict:
    """One repeat-rich run's outputs (the FASTQ run's with its
    phased.bam) and the sim's files against the pin (`_check_pin`)."""
    want = dict(pin["runs"][run]["run"])
    if run == "fastq":
        want["phased.bam"] = pin["runs"][run]["phased.bam"]
    return _check_pin(dict(sim_args=pin["sim_args"], sim=pin["sim"],
                           run=want), _repeat_tool().SIM, sim_dir, out,
                      REPEAT_VARIANTS[run], tag)


def phase10_repeat_runs(smem: dict, seed: int, cpu_proc) -> dict:
    """(a) The port's `sim` at tests/test_repeat_rich.py's recipe (tandem
    arrays, segdup pairs and homopolymer runs in the reference) and its
    reads written as an unaligned BAM, then `run --device cuda --fastq`,
    traced on the card for its busy time: the sim's files, reads.bam, the
    six outputs and phased.bam must be the JAX package's pinned bytes
    (tests/data/repeat_run_sha256.json), that test's floors must hold
    through the port's eval on the card (recall, precision, a <DUP> among
    the complex-SV calls) and every kernel of `run` must have launched;
    the stage table and the launches by shape are printed.  Then,
    untraced, each kernel at the run's fullest shapes against its plain
    version: the pair-HMM at its fullest bucket, the MEC at its largest
    observation set (every design in turns), the three k-mer kernels at
    the largest chunk, and the DP and the walk at the largest launch of
    each (mode, design, W) the run made.  (b) `run --device cuda --bam`
    on reads.bam and on (a)'s phased.bam: each run's six outputs pinned.
    (c) The restricted runs (`_region_cuda_vs_cpu`)."""
    import numpy as np

    from volcanosv_tpu_torch import cli
    from volcanosv_tpu_torch.eval import evaluate_files
    from volcanosv_tpu_torch.io import bam
    from volcanosv_tpu_torch.io.fastq import read_fastq
    from volcanosv_tpu_torch.io.vcf import read_vcf
    from volcanosv_tpu_torch.phasing import phase, realign
    from volcanosv_tpu_torch.utils.logging import STAGE_TIMES, stage_report
    tool = _repeat_tool()
    with open(REPEAT_PIN) as fh:
        pin = json.load(fh)
    tag = "phase 10: repeat-rich run"
    d = os.path.join(WORK, "repeat")
    sim_dir = os.path.join(d, "sim")
    t0 = time.perf_counter()
    if cli.main(["sim", "-o", sim_dir] + tool.SIM) != 0:
        raise AssertionError(f"{tag}: sim failed")
    n_reads = tool.write_reads_bam(
        os.path.join(sim_dir, "reads.bam"),
        read_fastq(os.path.join(sim_dir, "reads.fastq")), bam)
    sim_s = time.perf_counter() - t0

    def run_args(run):
        flag, path = tool.RUNS[run]
        return ["run", "--ref", os.path.join(sim_dir, "ref.fa"), flag,
                os.path.join(d, path), "-o", os.path.join(d, run),
                "--device", "cuda"]
    buckets, vote_reads, fullest = [], [], {}
    undo_buckets = _watch_buckets(buckets, vote_reads, fullest)
    calls, kept = {}, {}
    undo = _watch(calls, kept)
    rc, run_s, prof = _traced_cli(run_args("fastq"), (undo, undo_buckets))
    kernel_launches = _counts()
    shapes = _run_shapes()
    stages = {k: round(v[0], 3) for k, v in STAGE_TIMES.items()}
    if rc != 0:
        raise AssertionError(f"{tag}: run --fastq exited {rc}")
    out = os.path.join(d, "fastq")
    pinned = {"fastq": _repeat_pinned(pin, "fastq", sim_dir, out, tag)}
    for name in ("banded_dp", "tb_walk", "pairhmm_viterbi", "mec_phase",
                 "ava_overlaps", *KMER_KERNELS):
        if kernel_launches[name] <= 0:
            raise AssertionError(f"{tag}: {name} never launched")
    profile_info = _profile_summary(prof, run_s)
    _log(f"{tag}: the sim's inputs, reads.bam ({n_reads} reads), run's six "
         f"outputs and phased.bam are the JAX package's pinned bytes "
         f"{json.dumps(pinned['fastq'])}\n"
         f"{tag}: {run_s:.1f} s, launches {kernel_launches}\n"
         f"{tag}: launches by shape {json.dumps(shapes)}\n" + stage_report())
    _log(f"{tag}: device busy {profile_info['busy_ms']:.1f} ms of "
         f"{run_s:.1f} s; pair-HMM launches {json.dumps(buckets)}; vote "
         f"launches, real reads {vote_reads}; profile "
         f"{json.dumps(profile_info)}")
    sv = evaluate_files(os.path.join(sim_dir, "truth.vcf"),
                        os.path.join(out, "volcanosv_variants.vcf"),
                        device="cuda")
    _h, cx = read_vcf(os.path.join(out, "volcanosv_complex_sv.vcf"))
    gates = dict(sv=sv.summary(), complex_dups=sum(
        str(r.svtype).startswith("DUP") for r in cx))
    if sv.recall < tool.FLOORS["recall"] \
            or sv.precision < tool.FLOORS["precision"] \
            or not gates["complex_dups"]:
        raise AssertionError(f"{tag}: floors {tool.FLOORS} and a <DUP> "
                             f"failed: {json.dumps(gates)}")
    _log(f"{tag}: floors met {json.dumps(gates)}")
    # the kernels at the run's fullest shapes, untraced
    bucket = _viterbi_row(
        "the repeat-rich run's fullest bucket",
        *realign._bucket(*fullest["args"]), fullest["err"],
        fullest["args"][2].shape[1], True)
    margs, mkw = phase._mec_inputs(*kept["_mec_solve"][0][:-1], "cuda")
    mec = _mec_row("the repeat-rich run's largest observation set", margs,
                   **mkw, cpu=True, timed=True)
    mec["designs_ms"] = _mec_designs_in_turns(margs, mkw["n_reads"],
                                              mkw["n_iter"], mec["snps"])
    _log(f"{tag}: MEC at the run's largest set, designs in turns (ms) "
         f"{json.dumps(mec['designs_ms'])}")
    kmer_rows = _kmer_rows(kept)
    rng = np.random.default_rng(seed + 10)

    def check(top):
        row, wrow = _check_top_shape(rng, smem, top)
        return row if "mode" in top else wrow
    dp_classes = _new_dp_classes([], shapes["banded_dp"], check) \
        + _new_dp_classes([], shapes["tb_walk"], check)
    _log(f"{tag}: the DP and the walk at the largest launch of each class "
         f"{json.dumps(dp_classes)}")
    # (b) the BAM runs
    bam_runs = {}
    for run in ("bam", "phased_bam"):
        STAGE_TIMES.clear()
        t1 = time.perf_counter()
        rc, counts, _shapes = _count_kernels(
            lambda r=run: cli.main(run_args(r)))
        secs = time.perf_counter() - t1
        if rc != 0:
            raise AssertionError(f"{tag}: run {tool.RUNS[run]} exited {rc}")
        pinned[run] = _repeat_pinned(pin, run, sim_dir,
                                     os.path.join(d, run), tag)
        bam_runs[run] = dict(run_s=secs, launches=counts, stages={
            k: round(v[0], 3) for k, v in STAGE_TIMES.items()})
        _log(f"{tag}: run {' '.join(tool.RUNS[run])} gave the pinned bytes "
             f"in {secs:.1f} s {json.dumps(bam_runs[run])}")
    region = _region_cuda_vs_cpu(cpu_proc)
    return dict(sim_s=sim_s, run_s=run_s, stages=stages,
                kernel_launches=kernel_launches, shapes=shapes,
                pairhmm_buckets=buckets, vote_reads=vote_reads,
                pinned=pinned, busy_ms=profile_info["busy_ms"],
                profile=profile_info, gates=gates, pairhmm_bucket=bucket,
                mec=mec, kmer=kmer_rows, dp_classes=dp_classes,
                bam_runs=bam_runs, region=region)


def _repeat_only(seed: int, smi: str) -> int:
    """`--repeat`: phase 5b's `run` on the card alone (the restricted
    runs' contigs), then phase 10.  Prints the phase's summary, the card
    and the contract's last line."""
    import torch

    from volcanosv_tpu_torch import cli
    d = os.path.join(WORK, "run_cuda_vs_cpu")
    if cli.main(["sim", "-o", os.path.join(d, "sim")] + RUN_SIM) != 0 \
            or cli.main(_run_args(os.path.join(d, "sim"),
                                  os.path.join(d, "out_cuda"), "cuda")) != 0:
        raise AssertionError("phase 5b's run --device cuda failed")
    cpu = start_cpu_side_10()
    t0 = time.perf_counter()
    info = phase10_repeat_runs(_smem_latency(), seed, cpu)
    _log(f"phase 10 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps(info))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace phases 2, 4 and 5 with torch.profiler and "
                         "print the device time by kernel")
    ap.add_argument("--scale", type=float, metavar="MB",
                    help="run phase 9 alone at MB Mb (the pin's recipe at "
                         "another length; the bytes are held to the pin at "
                         "the lengths it has a row for, 5 and 10), then "
                         "the DP and the walk at the largest launch of each "
                         "(mode, design, W) the run made")
    ap.add_argument("--repeat", action="store_true",
                    help="run phase 10 alone (after phase 5b's card run, "
                         "whose contigs its restricted runs take)")
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

    if args.scale is not None:
        return _scale_only(args.scale, args.seed, smi)
    if args.repeat:
        return _repeat_only(args.seed, smi)
    info = {"phase_s": {}}

    def timed(phase: str, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        info["phase_s"][phase] = time.perf_counter() - t0
        _log(f"phase {phase} took {info['phase_s'][phase]:.1f} s")
        return out

    dp_rows, walk_rows, smem = timed("1", phase1_kernels, args.seed)
    # each cuda = cpu check's CPU side starts as soon as its inputs exist
    # and runs in a process of its own beside the card's phases: 4b's from
    # here, 6's after phase 4, 5b's before phase 5, 10's after phase 6
    cpu_4b = start_cpu_sides_4b()
    launches, info["slice"] = timed("2", phase2_slice, args.seed,
                                    args.profile)
    info["slice"]["eval_alt"] = timed("2b", phase2b_eval_alt)
    timed("3", phase3_cuda_vs_cpu, args.seed)
    info["asm"], kept = timed("4", phase4_asm, args.seed, args.profile)
    cpu_6 = start_cpu_side_6()
    info["asm_cuda_vs_cpu"] = timed("4b", phase4b_asm_cuda_vs_cpu,
                                    args.seed, kept, cpu_4b)
    info["overlap"] = timed("4c", phase4c_overlap_pass, args.seed)
    cpu_5b = start_cpu_side_5b()
    info["run"] = timed("5", phase5_run_golden, args.profile)
    info["run_cuda_vs_cpu"] = timed("5b", phase5b_run_cuda_vs_cpu, cpu_5b)
    info["qc_sd"] = timed("6", phase6_qc_sd, args.seed, cpu_6)
    cpu_10 = start_cpu_side_10()
    info["two_ranks"] = timed("7", phase7_two_ranks, args.seed)
    info["noisy"] = timed("8", phase8_noisy_runs)
    with open(SCALE_PIN) as fh:
        pin = json.load(fh)
    info["scale"] = timed("9", phase9_scale_run, pin["scale_args"], pin)
    info["repeat"] = timed("10", phase10_repeat_runs, smem, args.seed,
                           cpu_10)
    _log(f"total {time.perf_counter() - t_start:.1f} s; by phase (s) "
         f"{json.dumps(info['phase_s'])}")

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
    # the later slices' paths: qc and asm --sd on the card (phase 6), `run`
    # over two ranks (phase 7, summed over the ranks), `run -d CLR` and
    # `run -d ONT` (phase 8), `run` at 5 Mb (phase 9); their launches by
    # shape
    qc_sd = info["qc_sd"]
    paths = {
        "qc": ("qc and asm --sd",
               {k: qc_sd["qc"]["launches"][k] + qc_sd["asm_sd"]["launches"][k]
                for k in ("banded_dp", "tb_walk")},
               [f(qc_sd["qc"]["shapes"][i] + qc_sd["asm_sd"]["shapes"][i])
                for i, f in enumerate((_dp_shapes, _walk_shapes))]),
        "ranks": ("run over two ranks",
                  {k: sum(r["launches"]["run"][k]
                          for r in info["two_ranks"]["ranks"])
                   for k in ("banded_dp", "tb_walk")},
                  [f(info["two_ranks"]["run_shapes"][i])
                   for i, f in enumerate((_dp_shapes, _walk_shapes))]),
    }
    for dtype, run in info["noisy"].items():
        paths[dtype.lower()] = (
            f"run -d {dtype}",
            {k: run["kernel_launches"][k] for k in ("banded_dp", "tb_walk")},
            [run["shapes"]["banded_dp"], run["shapes"]["tb_walk"]])
    scale = info["scale"]
    paths["scale"] = (
        f"run at {scale['report']['genome_mb']:g} Mb "
        f"(tools/scale_run_torch.py)",
        {k: scale["kernel_launches"][k] for k in ("banded_dp", "tb_walk")},
        [scale["shapes"]["banded_dp"], scale["shapes"]["tb_walk"]])
    repeat = info["repeat"]
    paths["repeat"] = (
        "run on the repeat-rich sim (tests/test_repeat_rich.py's recipe)",
        {k: repeat["kernel_launches"][k] for k in ("banded_dp", "tb_walk")},
        [repeat["shapes"]["banded_dp"], repeat["shapes"]["tb_walk"]])
    path_rows = {tag: (_row_at_top_shape(dp_rows, dp, check),
                       _row_at_top_shape(walk_rows, walk, check))
                 for tag, (_p, _n, (dp, walk)) in paths.items()}
    # every (mode, design, W) the noisy runs and the scale run launched
    # that no row holds yet
    for tag, run in [(t.lower(), r) for t, r in info["noisy"].items()] \
            + [("scale", scale)]:
        _p, _n, (dp, walk) = paths[tag]
        run["new_dp_classes"] = _new_dp_classes(dp_rows, dp, check) \
            + _new_dp_classes(walk_rows, walk, check)
    _log(f"top shapes of qc/asm --sd, of the two ranks' run, of the CLR "
         f"and ONT runs, of the scale run and of the repeat-rich run: "
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
    ov = info["overlap"]["rows"][0]
    kernels.append(dict(
        name="ava_overlaps", route="cuda",
        source="volcanosv_tpu_torch/csrc/ava.cu",
        replaces="no TPU kernel: volcanosv_tpu/native/ava.cpp on the host",
        launches=info["run"]["kernel_launches"]["ava_overlaps"],
        launches_asm=info["asm"]["kernel_launches"]["ava_overlaps"],
        max_abs_err=max(max(r["max_abs_err"], r.get("plain_max_abs_err", 0))
                        for r in info["overlap"]["rows"]),
        ms=ov["ms"], pass_ms=ov["pass_ms"],
        host_ms=ov["host_ms"], plain_ms=ov["plain_ms"],
        bound_ms=ov["bound_ms"], bound_by=ov["bound_by"], library_ms=None,
        shapes=info["overlap"]["rows"]))
    kernels += _scan_kernel_entries(info, rng)
    kernels += _kmer_kernel_entries(info)
    kernels += _mec_kernel_entries(info)
    for dtype, run in info["noisy"].items():
        _add_run_rows(kernels, run, f"run_{dtype.lower()}")
    _add_run_rows(kernels, info["scale"], "scale")
    _add_run_rows(kernels, info["repeat"], "repeat")
    print(json.dumps(info))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
