"""Command-line drivers of the port — same subcommands, flags and output
files as `volcanosv_tpu.cli`, plus `--device`:

    python -m volcanosv_tpu_torch.cli sim            -o sim/ [--seed 0] ...
    python -m volcanosv_tpu_torch.cli asm            --ref ref.fa (--fastq reads.fq | --bam reads.bam) \\
        -o out/ [--sd] [--hybrid_bed regions.bed] [--emit_fastqs] [--device cuda]
    python -m volcanosv_tpu_torch.cli qc             --ref ref.fa --contig contigs.fa --fastq reads.fq \\
        -o out/ [--device cuda]
    python -m volcanosv_tpu_torch.cli vc-large-indel --ref ref.fa --contig contigs.fa \\
        [--fastq reads.fq | --bam reads.bam] -o out/ [--device cuda]
    python -m volcanosv_tpu_torch.cli vc-small-indel --ref ref.fa --contig contigs.fa \\
        [--fastq reads.fq] -o out/ [--device cuda]
    python -m volcanosv_tpu_torch.cli vc-complex-sv  --ref ref.fa --contig contigs.fa \\
        [--fastq reads.fq] [--large_vcf large.vcf] -o out/ [--device cuda]
    python -m volcanosv_tpu_torch.cli eval           --base truth.vcf --comp calls.vcf [--device cuda]
    python -m volcanosv_tpu_torch.cli merge-vcf      --out_vcf merged.vcf a.vcf b.vcf ...
    python -m volcanosv_tpu_torch.cli run            --ref ref.fa --fastq reads.fq -o out/ \\
        [--resume] [--device cuda]

`--device` names the torch device the device stages run on (default
`cuda`); asking for CUDA on a host without it raises.  `--profile_trace
DIR` writes a torch.profiler trace of the whole command (Chrome/Perfetto
JSON) into DIR.

`vc-large-indel`, `vc-small-indel`, `vc-complex-sv` and `run` also run as
N ranks of one `torch.distributed` group (torchrun's environment, or
`python -m volcanosv_tpu_torch.parallel.multihost`; see parallel/mesh.py):
each rank owns a round-robin share of the chromosomes and aligns a
contiguous 1/N slice of the queries, the records are exchanged through
<out_dir>/xch/, the WGS-global coverage median is taken over every rank's
values, each rank writes its chromosomes' records as a part file and rank 0
merges them.  The outputs are those of one process, byte for byte.  `asm`
under such a group assembles the rank's chromosomes and writes
phased_p<rank>.bam.

The `--contig` FASTAs use the reference's contig naming contract
(PS<pb>_<start>_<end>_hp{1,2}_<n>, or hp1/hp2-only names for whole-haplotype
assemblies)."""
from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np

from .config import PipelineConfig
from .device import resolve_device
from .utils.logging import get_logger, stage_timer

log = get_logger("cli")


# ---------------------------------------------------------------------------
# shared loading helpers
# ---------------------------------------------------------------------------

def _load_reads(args) -> dict[str, str]:
    """Read name → sequence from --fastq or --bam."""
    seqs: dict[str, str] = {}
    if getattr(args, "fastq", None):
        from .io.fastq import read_fastq
        for name, seq, _q in read_fastq(args.fastq):
            seqs[name] = seq
    elif getattr(args, "bam", None):
        from .io.bam import scan_bam
        return scan_bam(args.bam).read_seqs()   # native parallel inflate
    return seqs


def _align_by_chrom(ref: dict[str, str], seqs: dict[str, str], preset: str,
                    device, out_dir: str, tag: str,
                    want: list[str] | None = None) -> dict[str, list]:
    """Align sequences to ref; returns the records of the chromosomes in
    `want` (None: all), by chromosome.

    In a process group the alignment is query-sharded: each rank aligns a
    contiguous 1/P slice of the query set against the (identical) full
    reference index, then per-chromosome record lists are exchanged over
    the shared filesystem (<out_dir>/xch/<tag>_*) so that this rank
    receives the chromosomes in `want` — the single-process record sets
    and order, byte for byte (parallel.multiproc.exchange_by_chrom)."""
    from .aligner import Aligner
    from .config import AlignConfig
    from .parallel import multiproc as mp
    items = list(seqs.items())
    lo, hi = mp.shard_interval(len(items))
    chunk = dict(items[lo:hi])
    aligner = Aligner(ref, AlignConfig.preset(preset), device=device)
    recs = aligner.to_bam_records(aligner.align(list(chunk.items())), chunk)
    local: dict[str, list] = {c: [] for c in ref}
    for r in recs:
        local[aligner.names[r.ref_id]].append(r)
    if mp.n_processes() > 1:
        log.info("rank %d/%d aligned queries [%d:%d) of %d (%s)",
                 mp.process_id(), mp.n_processes(), lo, hi, len(items), tag)
    return mp.exchange_by_chrom(local, out_dir, tag,
                                want=list(ref) if want is None else want)


def _read_preset(dtype: str) -> str:
    return {"Hifi": "map-hifi", "CLR": "map-pb", "ONT": "map-ont"}[dtype]


def _reads_by_chrom(args, ref, device, chroms):
    """The --fastq/--bam reads aligned to ref (query-sharded over the
    ranks), by chromosome of `chroms`; None when neither is given."""
    if not (getattr(args, "fastq", None) or getattr(args, "bam", None)):
        return None
    read_seqs = _load_reads(args)
    with stage_timer("align-reads", log):
        return _align_by_chrom(ref, read_seqs,
                                       _read_preset(args.dtype), device,
                                       args.out_dir, "reads", want=chroms)


def _vcf_out(out_dir: str, name: str, ref: dict[str, str], records) -> str:
    from .io.vcf import make_header, write_vcf
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    n = write_vcf(path, make_header({c: len(s) for c, s in ref.items()}),
                  records)
    log.info("wrote %d records → %s", n, path)
    return path


def _vcf_out_sharded(out_dir: str, name: str, ref: dict[str, str],
                     records) -> str:
    """Multi-process VCF output: each rank writes its owned chromosomes'
    records as a part file, rank 0 merges them in rank order — the
    reference's per-chromosome concat (volcanosv-vc-large-indel.py:266-278
    + Merge_VCF.py).  Single-process: plain _vcf_out."""
    from .parallel import multiproc as mp
    if mp.n_processes() == 1:
        return _vcf_out(out_dir, name, ref, records)
    parts_dir = os.path.join(out_dir, "parts")
    os.makedirs(parts_dir, exist_ok=True)
    _vcf_out(parts_dir, f"{name}.p{mp.process_id()}.vcf", ref, records)
    mp.barrier(f"vcf:{name}")
    path = os.path.join(out_dir, name)
    if mp.is_rank0():
        from .io.vcf import merge_vcfs
        n = merge_vcfs([os.path.join(parts_dir, f"{name}.p{p}.vcf")
                        for p in range(mp.n_processes())], path)
        log.info("rank 0 merged %d records from %d parts → %s",
                 n, mp.n_processes(), path)
    mp.barrier(f"vcf-merged:{name}")
    return path


def _reads_sigs_cached(args, cfg, reads_by_chrom, chroms):
    """Per-chrom reads signatures with checkpoint reuse (the -rdsig dir
    contract, volcanosv-vc-large-indel.py:18-19).  `chroms` are this
    rank's chromosomes, so ranks never write each other's checkpoint
    artifacts."""
    if reads_by_chrom is None:
        return None
    from .vc.reads_sig import extract_reads_signatures
    ckpt = _ckpt(args)
    sigs = {}
    for chrom in chroms:
        name = f"reads_sig_{chrom}.tsv"
        if ckpt.has(name):
            sigs[chrom] = ckpt.load_sigs(name)
        else:
            sigs[chrom] = extract_reads_signatures(
                reads_by_chrom.get(chrom, []), chrom, cfg.fp_filter)
            ckpt.save_sigs(name, sigs[chrom])
    return sigs


def _own_chroms(ref: dict[str, str]) -> list[str]:
    """This process's chromosome shard.  Single-process → all chromosomes;
    in a process group each rank owns a round-robin share (the
    multi-process replacement for '22 SLURM jobs', README.md:244-255)."""
    from .parallel import multiproc as mp
    from .parallel.mesh import host_chromosome_shard
    chroms = list(ref)
    if mp.n_processes() > 1:
        chroms = host_chromosome_shard(chroms)
        log.info("rank %d/%d owns chromosomes: %s", mp.process_id(),
                 mp.n_processes(), chroms)
    return chroms


def _pipeline_mesh(device) -> None:
    """Install the (genome, data) mesh of this process's cards as the
    ACTIVE mesh for the command (single process, `device` a card, more
    than one card; else no mesh): the aligner's DP window batches are then
    split over its cards (ops.banded_align._sharded_cigars_dispatch) and
    the WGS median runs as its collective.  Called at the top of each
    command that aligns; `_mesh_scoped` clears it when the command ends."""
    import torch

    from .parallel import make_mesh
    from .parallel import multiproc as mp
    from .parallel.mesh import set_active_mesh
    if mp.n_processes() == 1:
        set_active_mesh(make_mesh(device=device) if (
            device.type == "cuda" and torch.cuda.device_count() > 1)
            else None)


def _mesh_scoped(cmd):
    """cmd(args) with the active mesh cleared when it returns or raises, so
    that no later command of the process inherits it."""
    @functools.wraps(cmd)
    def run(args):
        from .parallel.mesh import set_active_mesh
        try:
            return cmd(args)
        finally:
            set_active_mesh(None)
    return run


def _call_large_indels(ref, by_chrom, contigs, cfg, reads_by_chrom,
                       reads_sigs, chroms, device, include_bed=None,
                       read_hp=None):
    """Large-indel calling of `chroms` with the WGS-global coverage median
    over every rank's chromosomes' rel_cov values (the reference's
    per-run median after the all-chromosome concat,
    volcanosv-vc-large-indel.py:266-278 + filter_vcf_by_sig_cov_insdel.py
    :38-55; parallel.wgs.wgs_global_median).  read_hp (chrom → read →
    (hap, block)) drives the phase-aware GT downgrade."""
    from .parallel.mesh import active_mesh
    from .parallel.multiproc import gather_across_processes
    from .parallel.wgs import wgs_global_median
    from .vc.gt_correction import rel_coverage
    from .vc.large_indel import call_chromosome_raw, finalize_chromosome
    raw: dict[str, tuple] = {}
    for chrom in chroms:
        with stage_timer(f"large-indel[{chrom}]", log):
            raw[chrom] = call_chromosome_raw(
                chrom, by_chrom.get(chrom, []), ref[chrom], contigs, cfg,
                reads_records=(reads_by_chrom or {}).get(chrom),
                reads_sigs=(reads_sigs or {}).get(chrom),
                include_bed=(include_bed or {}).get(chrom), device=device)
    medians: dict[str, float] = {}
    have_sigs = [c for c in chroms if raw[c][1] is not None]
    if reads_by_chrom is not None:
        # every rank MUST take this branch symmetrically (the gather is a
        # collective): reads_by_chrom is None on all ranks or none, and
        # apply_del/apply_ins come from the shared config
        mesh = active_mesh()
        for svtype, apply_it in (("DEL", cfg.cov_filter.apply_del),
                                 ("INS", cfg.cov_filter.apply_ins)):
            if not apply_it:
                continue
            rels = [rel_coverage(raw[c][0], raw[c][1], cfg.cov_filter,
                                 svtype)[1] for c in have_sigs]
            local = np.concatenate(rels) if rels else np.zeros(0, np.float32)
            with stage_timer("wgs-global-median", log):
                # the union of every rank's owned-chromosome vectors
                glob = gather_across_processes(local)
                if len(glob) < cfg.cov_filter.min_calls:
                    continue
                medians[svtype] = wgs_global_median([glob], mesh)
            log.info("WGS-global %s rel_cov median: %.4f over %d calls (%s)",
                     svtype, medians[svtype], len(glob),
                     "mesh collective" if mesh is not None else "host")
    records = []
    for chrom in chroms:
        recs, gt_sigs = raw[chrom]
        records += finalize_chromosome(
            recs, gt_sigs, (reads_by_chrom or {}).get(chrom), cfg,
            cov_medians=medians or None,
            read_hp=(read_hp or {}).get(chrom))
    return records


def _load_bed(args):
    """--bed regions by chromosome, or None."""
    if not getattr(args, "bed", None):
        return None
    from .io.bed import read_bed
    return read_bed(args.bed)


def _restrict_chroms(args, chroms: list[str], bed) -> list[str]:
    """Apply --chrom / --bed region restriction (the reference's
    single-chromosome vc mode, volcanosv-vc-large-indel.py:280 +
    filter_GT_correction.py:67-82)."""
    one = getattr(args, "chrom", None)
    if one:
        chroms = [c for c in chroms if c == one]
    if bed:
        chroms = [c for c in chroms if c in bed]
    return chroms


def _ckpt(args):
    from .utils.checkpoint import CheckpointDir
    return CheckpointDir(args.out_dir, resume=getattr(args, "resume", False))


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def _run_asm(ref, read_seqs, args, device, reads_by_chrom=None):
    """phase → partition → assemble every chromosome on `device`.

    Returns (contigs, phased SNP VcfRecords — the longshot-VCF-equivalent
    output, README.md:237-238 —, read → (hap, block) by chromosome).
    `reads_by_chrom`, when given, is the reads' alignment the caller made
    (`run` aligns once for every stage); else the reads are aligned here.
    Per-chromosome results checkpoint to <out_dir>/checkpoints/ and are
    reused under --resume (the reference's log.txt skip-list contract,
    General_Assembly_Workflow.py:530-547).  Writes <out_dir>/phased.bam
    with HP/PS tags when any chromosome is assembled.

    Multi-process: each rank assembles its owned chromosome shard (the
    reads' alignment is query-sharded too) and writes phased_p<rank>.bam;
    the per-chromosome checkpoint artifacts in the shared out_dir ARE the
    exchange medium — after the barrier every rank loads all chromosomes'
    contigs/SNPs, so later stages see the identical full assembly on every
    rank."""
    from .io.bam import BamWriter
    from .ops.pack import encode_seq
    from .parallel import multiproc as mp
    from .parallel.mesh import host_chromosome_shard
    from .phasing import snp_vcf_records
    from .pipeline.asm import assemble_chromosome
    cfg = PipelineConfig.for_dtype(args.dtype)
    ckpt = _ckpt(args)
    bed = {}
    if getattr(args, "hybrid_bed", None):
        from .io.bed import read_bed
        bed = read_bed(args.hybrid_bed)
    chroms = [args.chrom] if getattr(args, "chrom", None) else list(ref)
    multi = mp.n_processes() > 1
    own = host_chromosome_shard(chroms) if multi else chroms
    todo = [c for c in own
            if not (ckpt.has(f"asm_{c}.fa") and ckpt.has(f"snps_{c}.vcf"))]
    by_chrom, phased_writer = {}, None
    if todo:
        if reads_by_chrom is not None:
            by_chrom = {c: reads_by_chrom.get(c, []) for c in own}
        else:
            with stage_timer("align-reads", log):
                by_chrom = _align_by_chrom(
                    ref, read_seqs, _read_preset(args.dtype), device,
                    args.out_dir, "reads_asm", want=own)
        # phased BAM with HP/PS tags — longshot's '-O phased.bam' artifact
        # (volcanosv-asm.py:75-80; tag semantics prepare_info_v1.py:42-63);
        # per-rank part files under multi-process (owned chromosomes only)
        os.makedirs(args.out_dir, exist_ok=True)
        suffix = f"_p{mp.process_id()}" if multi else ""
        phased_writer = BamWriter(
            os.path.join(args.out_dir, f"phased{suffix}.bam"),
            list(ref), [len(s) for s in ref.values()])
    results: dict[str, tuple[dict, list]] = {}
    for chrom in own:
        if chrom not in todo:
            log.info("resume: reusing checkpointed assembly for %s", chrom)
            results[chrom] = (ckpt.load_fasta(f"asm_{chrom}.fa"),
                              ckpt.load_vcf(f"snps_{chrom}.vcf"))
            continue
        recs = by_chrom.get(chrom, [])
        if not recs:
            ckpt.save_fasta(f"asm_{chrom}.fa", {})
            ckpt.save_vcf(f"snps_{chrom}.vcf", [])
            results[chrom] = ({}, [])
            continue
        with stage_timer(f"asm[{chrom}]", log):
            ctgs, ph, part = assemble_chromosome(
                recs, encode_seq(ref[chrom]), read_seqs, cfg,
                hybrid_bed=bed.get(chrom), device=device)
        if getattr(args, "emit_fastqs", False):
            # per-hap FASTQs (write_fastq_asm_general.py:97-142 parity;
            # double-assigned reads are duplicated into both haps)
            from .io.fastq import write_fastq
            fq_dir = os.path.join(args.out_dir, "fastq_by_hap")
            os.makedirs(fq_dir, exist_ok=True)
            by_hap: dict[str, list] = {}
            for rname, haps in part.assignment.items():
                seq = read_seqs.get(rname)
                if seq:
                    for h in haps:
                        by_hap.setdefault(h, []).append((rname, seq, None))
            for h, entries in by_hap.items():
                write_fastq(os.path.join(fq_dir, f"{h}.fastq"), entries)
        snps = snp_vcf_records(chrom, ph)
        ckpt.save_fasta(f"asm_{chrom}.fa", ctgs)
        ckpt.save_vcf(f"snps_{chrom}.vcf", snps)
        results[chrom] = (ctgs, snps)
        hp_of = {n: (int(ph.read_hap[i]), int(ph.read_block[i]))
                 for i, n in enumerate(ph.read_names)
                 if ph.read_hap[i] != 0}
        # read_hp_og.p-equivalent artifact (prepare_info_v1.py:79-85) —
        # also drives the phase-aware GT downgrade at vc time
        ckpt.save_read_hp(f"read_hp_{chrom}.tsv", hp_of)
        for r in recs:
            hp = hp_of.get(r.name)
            if hp is not None:
                r.tags = dict(r.tags or {})
                r.tags["HP"] = hp[0]
                r.tags["PS"] = hp[1]
            phased_writer.write(r)
    if phased_writer is not None:
        phased_writer.close()
    mp.barrier("asm-exchange")
    contigs: dict[str, str] = {}
    snp_records = []
    read_hp_by_chrom: dict[str, dict[str, tuple[int, int]]] = {}
    for chrom in chroms:
        if chrom in results:
            ctgs, snps = results[chrom]
        elif os.path.exists(ckpt.path(f"asm_{chrom}.fa")):
            # another rank's shard — read its checkpoint artifacts
            ctgs = ckpt.load_fasta(f"asm_{chrom}.fa")
            snps = ckpt.load_vcf(f"snps_{chrom}.vcf")
        else:
            continue
        # read back from the checkpoint, fresh or resumed alike
        if os.path.exists(ckpt.path(f"read_hp_{chrom}.tsv")):
            read_hp_by_chrom[chrom] = ckpt.load_read_hp(
                f"read_hp_{chrom}.tsv")
        snp_records += snps
        for name, seq in ctgs.items():
            while name in contigs:            # cross-chrom PS id collision
                name += "b"
            contigs[name] = seq
    return contigs, snp_records, read_hp_by_chrom


def _align_reads_to_contigs(contigs: dict[str, str],
                            read_seqs: dict[str, str], dtype: str, device):
    """The reads aligned to the contigs: (records, contig names)."""
    from .aligner import Aligner
    from .config import AlignConfig
    al = Aligner(contigs, AlignConfig.preset(_read_preset(dtype)),
                 device=device)
    recs = al.to_bam_records(al.align(list(read_seqs.items())), read_seqs)
    return recs, al.names


@_mesh_scoped
def cmd_asm(args) -> int:
    from .io.fasta import read_fasta, write_fasta
    device = resolve_device(args.device)
    _pipeline_mesh(device)
    ref = read_fasta(args.ref)
    read_seqs = _load_reads(args)
    if not read_seqs:
        log.error("asm requires --fastq or --bam")
        return 2
    contigs, snp_records, _read_hp = _run_asm(ref, read_seqs, args, device)
    _vcf_out(args.out_dir, "phased_snps.vcf", ref, snp_records)
    if args.sd:
        # SD loop needs the read partition; approximate groups from contig
        # hap names by re-aligning reads to contigs (Evaluate_Assembly.py)
        from .pipeline.sd import hap_of_contig, sd_recover
        cfg = PipelineConfig.for_dtype(args.dtype)
        with stage_timer("align-reads-to-contigs", log):
            roc, names = _align_reads_to_contigs(contigs, read_seqs,
                                                 args.dtype, device)
        groups: dict[str, list[str]] = {}
        for r in roc:
            if r.is_unmapped or r.is_secondary or r.is_supplementary:
                continue
            h = hap_of_contig(names[r.ref_id])
            seq = read_seqs.get(r.name)
            if seq:
                groups.setdefault(h, []).append(seq)
        with stage_timer("sd-recover", log):
            contigs, _qc = sd_recover(contigs, groups, roc, cfg,
                                      device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "final_contigs.fa")
    write_fasta(out, contigs)
    log.info("assembly: %d contigs → %s", len(contigs), out)
    return 0


@_mesh_scoped
def cmd_qc(args) -> int:
    """Assembly QC report: per-contig window states + collapsed list, as
    <out_dir>/flagger_blocks.bed."""
    from .io.fasta import read_fasta
    from .qc import evaluate_assembly
    from .qc.flagger import state_names
    device = resolve_device(args.device)
    _pipeline_mesh(device)
    contigs = read_fasta(args.contig)
    read_seqs = _load_reads(args)
    if not read_seqs:
        log.error("qc requires --fastq or --bam")
        return 2
    cfg = PipelineConfig.for_dtype(args.dtype)
    with stage_timer("align-reads-to-contigs", log):
        roc, names = _align_reads_to_contigs(contigs, read_seqs, args.dtype,
                                             device)
    with stage_timer("qc", log):
        res = evaluate_assembly(contigs, roc, names, cfg.qc, device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "flagger_blocks.bed")
    names_q = state_names(cfg.qc.n_states)
    with open(out, "w") as fh:
        for c in res.states:
            for st in range(len(names_q)):
                for s, e in res.blocks(c, st):
                    fh.write(f"{c}\t{s}\t{e}\t{names_q[st]}\n")
    log.info("QC: λ=%.1f, collapsed contigs: %s → %s",
             res.lam, res.collapsed or "none", out)
    return 0


def cmd_sim(args) -> int:
    """Synthesize ref + diploid SVs + reads (+ truth VCF) for testing."""
    from . import sim
    from .io.fasta import write_fasta
    from .io.fastq import write_fastq
    from .io.vcf import VcfRecord, make_header, write_vcf
    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    ref = sim.random_genome(rng, args.length, n_chroms=args.chroms)
    if args.n_tandem or args.n_segdup or args.n_homopoly:
        ref, feats = sim.implant_repeats(
            rng, ref, n_tandem=args.n_tandem, n_segdup=args.n_segdup,
            n_homopoly=args.n_homopoly)
        from .io.bed import write_bed
        write_bed(os.path.join(args.out_dir, "repeats.bed"),
                  [(c, s, e, kind) for c, fs in feats.items()
                   for kind, s, e in fs])
    hap1, hap2, truth = sim.implant_svs(
        rng, ref, n_del=args.n_del, n_ins=args.n_ins, n_inv=args.n_inv,
        n_dup=args.n_dup, min_len=args.min_len, max_len=args.max_len,
        n_clustered=args.n_clustered, n_nested=args.n_nested,
        n_small=args.n_small)
    # SNPs go in at REF coordinates BEFORE the translocation tail-swap (the
    # swap moves hap sequence between chromosome records but every allele
    # keeps its reference locus, so the truth coordinates stay valid)
    hap1, hap2, truth_snps = sim.implant_snps_ref(
        rng, ref, hap1, hap2, truth, rate=args.snp_rate)
    if args.n_tra:
        if args.chroms < 2:
            log.error("--n_tra requires --chroms >= 2")
            return 2
        truth += sim.implant_tra(rng, ref, hap1, hap2, truth)
    reads = sim.simulate_reads(
        rng, {1: hap1, 2: hap2}, coverage=args.coverage,
        read_len=args.read_len, sub_rate=args.err, indel_rate=args.err / 2)
    write_fasta(os.path.join(args.out_dir, "ref.fa"), ref)
    write_fastq(os.path.join(args.out_dir, "reads.fastq"),
                ((n, s, None) for n, s, *_ in reads))
    trecs = []
    for i, t in enumerate(truth):
        gt = "1|1" if t.gt == (1, 1) else ("1|0" if t.gt[0] else "0|1")
        if t.svtype == "BND":
            trecs.append(VcfRecord(
                chrom=t.chrom, pos=t.pos + 1, id=f"truth-{i}", ref="N",
                alt=f"N[{t.chrom2}:{t.pos2 + 1}[", gt=gt,
                info={"SVTYPE": "BND", "CHR2": t.chrom2,
                      "END": t.pos2 + 1}))
            continue
        trecs.append(VcfRecord(
            chrom=t.chrom, pos=t.pos + 1, id=f"truth-{i}", ref="N",
            alt=f"<{t.svtype}>", gt=gt,
            info={"SVTYPE": t.svtype, "SVLEN": t.svlen,
                  "END": t.pos + 1 + t.svlen}))
    header = make_header({c: len(s) for c, s in ref.items()})
    write_vcf(os.path.join(args.out_dir, "truth.vcf"), header, trecs)
    # truth SNPs: GT encodes the carrying haplotype (1|0 = hap1, 0|1 =
    # hap2, 1/1 = hom) — the phasing switch-error gate's ground truth
    snp_recs = [VcfRecord(
        chrom=s.chrom, pos=s.pos + 1, id=f"tsnp-{i}", ref=s.ref, alt=s.alt,
        gt=("1/1" if s.hap == 0 else ("1|0" if s.hap == 1 else "0|1")))
        for i, s in enumerate(truth_snps)]
    order = {c: i for i, c in enumerate(ref)}
    snp_recs.sort(key=lambda r: (order[r.chrom], r.pos))
    write_vcf(os.path.join(args.out_dir, "truth_snps.vcf"), header, snp_recs)
    contigs = sim.contigs_from_haplotypes(hap1, hap2)
    write_fasta(os.path.join(args.out_dir, "true_contigs.fa"), contigs)
    log.info("sim → %s (%d reads, %d truth SVs)", args.out_dir,
             len(reads), len(truth))
    return 0


@_mesh_scoped
def cmd_vc_large_indel(args) -> int:
    from .io.fasta import read_fasta
    from .parallel.mesh import init_multihost
    init_multihost()
    device = resolve_device(args.device)
    _pipeline_mesh(device)
    ref = read_fasta(args.ref)
    contigs = read_fasta(args.contig)
    cfg = PipelineConfig.for_dtype(args.dtype, asm=args.asm)
    bed = _load_bed(args)
    chroms = _restrict_chroms(args, _own_chroms(ref), bed)
    with stage_timer("align-contigs", log):
        by_chrom = _align_by_chrom(ref, contigs, "asm5", device,
                                           args.out_dir, "contigs_asm5",
                                           want=chroms)
    reads_by_chrom = _reads_by_chrom(args, ref, device, chroms)
    reads_sigs = _reads_sigs_cached(args, cfg, reads_by_chrom, chroms)
    records = _call_large_indels(ref, by_chrom, contigs, cfg,
                                 reads_by_chrom, reads_sigs, chroms, device,
                                 include_bed=bed)
    _vcf_out_sharded(args.out_dir, "volcanosv_large_indel.vcf", ref, records)
    return 0


@_mesh_scoped
def cmd_vc_small_indel(args) -> int:
    """Standalone small-indel subcommand: contigs aligned with `asm20`, each
    chromosome called in turn (volcanosv-vc-small-indel.py).  In a process
    group each rank calls its chromosome shard (query-sharded alignment)
    and rank 0 merges (the reference's per-chromosome cluster story,
    README.md:244-255)."""
    from .io.fasta import read_fasta
    from .parallel.mesh import init_multihost
    from .vc.small_indel import call_small_indels
    init_multihost()
    device = resolve_device(args.device)
    _pipeline_mesh(device)
    ref = read_fasta(args.ref)
    contigs = read_fasta(args.contig)
    cfg = PipelineConfig.for_dtype(args.dtype)
    chroms = _restrict_chroms(args, _own_chroms(ref), _load_bed(args))
    with stage_timer("align-contigs", log):
        by_chrom = _align_by_chrom(ref, contigs, "asm20", device,
                                           args.out_dir, "contigs_asm20",
                                           want=chroms)
    reads_by_chrom = _reads_by_chrom(args, ref, device, chroms)
    records = []
    for chrom in chroms:
        with stage_timer(f"small-indel[{chrom}]", log):
            records += call_small_indels(
                chrom, by_chrom.get(chrom, []), ref[chrom], cfg,
                reads_records=(reads_by_chrom or {}).get(chrom))
    _vcf_out_sharded(args.out_dir, "volcanosv_small_indel.vcf", ref, records)
    return 0


def _harvest_ins_records(args, ref, contigs, cfg, chroms, device):
    """INS calls driving DUP recovery (volcanosv-vc-complex-sv.py:131-138).

    The reference's complex-SV script consumes the LARGE-INDEL VCF
    (align_ins2ref.py input); --large_vcf reuses one instead of re-running
    the large-indel caller per chromosome."""
    from .io.vcf import read_vcf
    from .vc.large_indel import call_chromosome
    if args.large_vcf:
        _h, recs = read_vcf(args.large_vcf)
        return [r for r in recs if r.svtype == "INS" and r.chrom in chroms]
    by_chrom = _align_by_chrom(ref, contigs, "asm5", device,
                                       args.out_dir, "contigs_asm5",
                                       want=chroms)
    out = []
    for chrom in chroms:
        out += [r for r in call_chromosome(
            chrom, by_chrom.get(chrom, []), ref[chrom], contigs, cfg,
            device=device) if r.svtype == "INS"]
    return out


@_mesh_scoped
def cmd_vc_complex_sv(args) -> int:
    """Standalone complex-SV subcommand: contigs aligned with `asm10`, the INS
    calls of the large-indel caller (or --large_vcf) for DUP recovery, and
    the WGS-global pairing over every chromosome
    (volcanosv-vc-complex-sv.py).  In a process group the alignment and
    the INS harvest run on each rank's shard, the INS records are
    exchanged, the (global, cross-chromosome) pairing runs identically on
    every rank, and rank 0 writes the VCF."""
    from .io.fasta import read_fasta
    from .parallel import multiproc as mp
    from .parallel.mesh import init_multihost
    from .vc.complex_sv import call_complex_svs
    init_multihost()
    device = resolve_device(args.device)
    _pipeline_mesh(device)
    ref = read_fasta(args.ref)
    contigs = read_fasta(args.contig)
    cfg = PipelineConfig.for_dtype(args.dtype)
    chroms = _restrict_chroms(args, list(ref), _load_bed(args))
    own = [c for c in _own_chroms(ref) if c in chroms]
    # complex pairing is WGS-global (cross-chrom BND mates): every rank
    # needs all chromosomes' contig alignments
    with stage_timer("align-contigs", log):
        by_chrom = _align_by_chrom(ref, contigs, "asm10", device,
                                           args.out_dir, "contigs_asm10",
                                           want=chroms)
    reads_by_chrom = _reads_by_chrom(args, ref, device, chroms)
    ins_own = _harvest_ins_records(args, ref, contigs, cfg, own, device)
    ins_by_chrom: dict[str, list] = {c: [] for c in ref}
    for r in ins_own:
        ins_by_chrom[r.chrom].append(r)
    ins_by_chrom = mp.exchange_by_chrom(ins_by_chrom, args.out_dir,
                                        "cx_ins_recs", want=list(ref))
    ins_records = [r for c in ref for r in ins_by_chrom.get(c, [])]
    ins_records.sort(key=lambda r: (r.chrom, r.pos, r.id))
    with stage_timer("complex-sv", log):
        records = call_complex_svs(by_chrom, ref, cfg,
                                   ins_records=ins_records,
                                   reads_by_chrom=reads_by_chrom,
                                   device=device)
    if mp.is_rank0():
        _vcf_out(args.out_dir, "volcanosv_complex_sv.vcf", ref, records)
    mp.barrier("cx-final")
    return 0


def cmd_eval(args) -> int:
    """Truvari-equivalent benchmark (README.md:493-498 protocol)."""
    from .eval import run
    return run(args)


def cmd_merge_vcf(args) -> int:
    from .io.vcf import merge_vcfs
    n = merge_vcfs(args.vcfs, args.out_vcf)
    log.info("merged %d records → %s", n, args.out_vcf)
    return 0


@_mesh_scoped
def cmd_run(args) -> int:
    """Full pipeline: asm + all three vc paths + merge (one command).

    One read-alignment pass serves the assembly and every caller.  The
    large-indel records are ordered by (chromosome rank, pos, id) before
    they drive the DUP recovery; an INS the recovery reclassified leaves
    the large-indel VCF (it is reported once, as <DUP>); the merged VCF
    takes the large-indel, small-indel and complex-SV records in that
    order.

    In a process group the assembly and the per-chromosome vc stages run
    on each rank's chromosome shard with query-sharded alignment; the
    finalized large-indel records are exchanged so the (WGS-only,
    svim-asm-style) complex-SV stage sees the global INS set; that stage
    runs once, on rank 0, and its records and consumed INS ids are
    broadcast; rank 0 writes the complex VCF and the final merge."""
    from .io.fasta import read_fasta, write_fasta
    from .io.vcf import merge_vcfs
    from .parallel import multiproc as mp
    from .parallel.mesh import init_multihost
    from .vc.complex_sv import call_complex_svs
    from .vc.small_indel import call_small_indels
    init_multihost()
    device = resolve_device(args.device)
    _pipeline_mesh(device)
    ref = read_fasta(args.ref)
    read_seqs = _load_reads(args)
    if not read_seqs:
        log.error("run requires --fastq or --bam")
        return 2
    cfg = PipelineConfig.for_dtype(args.dtype)
    os.makedirs(args.out_dir, exist_ok=True)
    multi = mp.n_processes() > 1
    own = _own_chroms(ref)

    # ONE read-alignment pass serves assembly AND every vc stage (the
    # complex-SV WGS stage needs all chromosomes, so exchange want=all)
    with stage_timer("align-reads", log):
        reads_by_chrom = _align_by_chrom(
            ref, read_seqs, _read_preset(args.dtype), device, args.out_dir,
            "reads_run")
    contigs, snp_records, read_hp_by_chrom = _run_asm(
        ref, read_seqs, args, device, reads_by_chrom=reads_by_chrom)
    if mp.is_rank0():
        write_fasta(os.path.join(args.out_dir, "final_contigs.fa"), contigs)
        _vcf_out(args.out_dir, "phased_snps.vcf", ref, snp_records)
    log.info("assembly: %d contigs", len(contigs))

    with stage_timer("align-contigs", log):
        li_by_chrom = _align_by_chrom(ref, contigs, "asm5", device,
                                              args.out_dir, "ctg_asm5")
    reads_sigs = _reads_sigs_cached(args, cfg, reads_by_chrom, own)
    large_own = _call_large_indels(ref, li_by_chrom, contigs, cfg,
                                   reads_by_chrom, reads_sigs, own, device,
                                   read_hp=read_hp_by_chrom)
    # the global finalized record set on every rank (drives the DUP
    # recovery and the consumed-INS filter identically everywhere)
    large_by_chrom: dict[str, list] = {c: [] for c in ref}
    for r in large_own:
        large_by_chrom[r.chrom].append(r)
    large_by_chrom = mp.exchange_by_chrom(large_by_chrom, args.out_dir,
                                          "large_recs", want=list(ref))
    large = [r for c in ref for r in large_by_chrom.get(c, [])]
    rank = {c: i for i, c in enumerate(ref)}
    large.sort(key=lambda r: (rank[r.chrom], r.pos, r.id))
    ins_records = [r for r in large if r.svtype == "INS"]

    with stage_timer("align-contigs", log):
        si_by_chrom = _align_by_chrom(ref, contigs, "asm20", device,
                                              args.out_dir, "ctg_asm20",
                                              want=own)
    small = []
    for chrom in own:
        with stage_timer(f"small-indel[{chrom}]", log):
            small += call_small_indels(
                chrom, si_by_chrom.get(chrom, []), ref[chrom], cfg,
                reads_records=reads_by_chrom.get(chrom),
                read_hp=read_hp_by_chrom.get(chrom))
    p_small = _vcf_out_sharded(args.out_dir, "volcanosv_small_indel.vcf",
                               ref, small)

    with stage_timer("align-contigs", log):
        cx_by_chrom = _align_by_chrom(
            ref, contigs, "asm10", device, args.out_dir, "ctg_asm10",
            want=None if mp.is_rank0() else [])
    consumed: set = set()
    # the WGS-global complex stage (cross-chrom BND pairing + DUP-recovery
    # realignment) runs ONCE, on rank 0; (records, consumed INS ids) are
    # broadcast so every rank filters its large-indel share identically
    complex_recs = None
    if mp.is_rank0():
        with stage_timer("complex-sv", log):
            complex_recs = call_complex_svs(cx_by_chrom, ref, cfg,
                                            ins_records=ins_records,
                                            reads_by_chrom=reads_by_chrom,
                                            consumed_ins=consumed,
                                            device=device)
    complex_recs, consumed = mp.broadcast_from_rank0(
        (complex_recs, consumed) if mp.is_rank0() else None,
        args.out_dir, "complex")
    p_cx = os.path.join(args.out_dir, "volcanosv_complex_sv.vcf")
    if mp.is_rank0():
        _vcf_out(args.out_dir, "volcanosv_complex_sv.vcf", ref, complex_recs)
    # an INS the DUP recovery reclassified is reported once, as <DUP>
    # (align_ins2ref.py role)
    large = [r for r in large if r.id not in consumed]
    # each rank writes its owned chromosomes' share of the global set
    large_mine = [r for r in large if not multi or r.chrom in own]
    p_large = _vcf_out_sharded(args.out_dir, "volcanosv_large_indel.vcf",
                               ref, large_mine)
    out = os.path.join(args.out_dir, "volcanosv_variants.vcf")
    if mp.is_rank0():
        n = merge_vcfs([p_large, p_small, p_cx], out)
        log.info("FINAL: %d variants → %s", n, out)
    mp.barrier("run-final")
    return 0


# ---------------------------------------------------------------------------

def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device of the DP kernels: cuda (default; "
                        "raises when absent) or cpu")


def _add_common(p, contig: bool) -> None:
    p.add_argument("--ref", required=True, help="reference FASTA")
    p.add_argument("--out_dir", "-o", required=True)
    p.add_argument("--dtype", "-d", default="Hifi",
                   choices=["Hifi", "CLR", "ONT"])
    if contig:
        p.add_argument("--contig", required=True,
                       help="hp1/hp2-named contig FASTA (otherasm contract)")
        p.add_argument("--asm", default="volcano",
                       choices=["volcano", "other"],
                       help="coverage-band profile row (filter_para.csv asm "
                            "column; 'other' for imported assemblies)")
        p.add_argument("--chrom",
                       help="restrict calling to one chromosome "
                            "(single-chrom mode, "
                            "volcanosv-vc-large-indel.py:280)")
        p.add_argument("--bed",
                       help="BED restricting calling + the GT-signature "
                            "task grid (sig_extract -include_bed, "
                            "filter_GT_correction.py:67-82)")
    p.add_argument("--fastq", help="reads FASTQ(.gz)")
    p.add_argument("--bam", help="reads BAM")
    p.add_argument("--resume", action="store_true",
                   help="reuse per-stage artifacts from "
                        "<out_dir>/checkpoints/ (skip-list resume)")
    p.add_argument("--profile", action="store_true",
                   help="write <out_dir>/stage_times.json + print the "
                        "per-stage wall-clock table")
    p.add_argument("--profile_trace", metavar="DIR",
                   help="capture a torch.profiler trace (Chrome/Perfetto "
                        "JSON) of the whole command into DIR")
    _add_device(p)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="volcanosv_tpu_torch",
        description="PyTorch/CUDA port of the diploid SV engine")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sim", help="synthesize test data")
    p.add_argument("--out_dir", "-o", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--length", type=int, default=80_000)
    p.add_argument("--chroms", type=int, default=1)
    p.add_argument("--n_del", type=int, default=4)
    p.add_argument("--n_ins", type=int, default=4)
    p.add_argument("--n_inv", type=int, default=0)
    p.add_argument("--n_dup", type=int, default=0)
    p.add_argument("--n_tra", type=int, default=0,
                   help="implant a reciprocal cross-chromosome "
                        "translocation (needs --chroms >= 2)")
    p.add_argument("--n_clustered", type=int, default=0,
                   help="clustered DEL+INS pairs 600-900bp apart, per chrom")
    p.add_argument("--n_nested", type=int, default=0,
                   help="INVs with an interior deletion (nested), per chrom")
    p.add_argument("--n_small", type=int, default=0,
                   help="2-49bp indels (small-indel path truth), per chrom")
    p.add_argument("--n_tandem", type=int, default=0,
                   help="tandem repeat arrays in the REFERENCE, per chrom")
    p.add_argument("--n_segdup", type=int, default=0,
                   help="dispersed ~97%%-identity segdup pairs, per chrom")
    p.add_argument("--n_homopoly", type=int, default=0,
                   help="15-40bp homopolymer runs, per chrom")
    p.add_argument("--min_len", type=int, default=60)
    p.add_argument("--max_len", type=int, default=400)
    p.add_argument("--snp_rate", type=float, default=1 / 1500)
    p.add_argument("--coverage", type=float, default=24.0)
    p.add_argument("--read_len", type=int, default=8_000)
    p.add_argument("--err", type=float, default=0.001)
    p.set_defaults(fn=cmd_sim)

    p = sub.add_parser("asm", help="phase + partition + assemble")
    _add_common(p, contig=False)
    p.add_argument("--chrom", help="restrict to one chromosome")
    p.add_argument("--sd", action="store_true",
                   help="QC + re-assemble collapsed blocks (SD recovery)")
    p.add_argument("--hybrid_bed",
                   help="BED of regions assembled with the in-BED profile "
                        "(hybrid mode, volcanosv-asm_hybrid.py parity)")
    p.add_argument("--emit_fastqs", action="store_true",
                   help="also write fastq_by_hap/<hap>.fastq per haplotype "
                        "(write_fastq_asm_general.py parity)")
    p.set_defaults(fn=cmd_asm)

    p = sub.add_parser("qc", help="coverage-HMM assembly QC (Flagger equiv)")
    _add_common(p, contig=True)
    p.set_defaults(fn=cmd_qc)

    p = sub.add_parser("vc-large-indel", help="large-indel calling (≥30bp)")
    _add_common(p, contig=True)
    p.set_defaults(fn=cmd_vc_large_indel)

    p = sub.add_parser("vc-small-indel", help="small-indel calling (2-49bp)")
    _add_common(p, contig=True)
    p.set_defaults(fn=cmd_vc_small_indel)

    p = sub.add_parser("vc-complex-sv", help="INV/DUP/TRA calling")
    _add_common(p, contig=True)
    p.add_argument("--large_vcf",
                   help="large-indel VCF whose INS records drive DUP "
                        "recovery (align_ins2ref.py input contract); "
                        "without it the large-indel caller runs inline")
    p.set_defaults(fn=cmd_vc_complex_sv)

    p = sub.add_parser("eval", help="truvari-equivalent SV benchmark")
    from .eval import add_arguments
    add_arguments(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("merge-vcf", help="merge VCFs (Merge_VCF.py)")
    p.add_argument("vcfs", nargs="+")
    p.add_argument("--out_vcf", required=True)
    p.set_defaults(fn=cmd_merge_vcf)

    p = sub.add_parser("run", help="full pipeline reads → merged VCF")
    _add_common(p, contig=False)
    p.set_defaults(fn=cmd_run)
    return ap


def _profiled(fn, args, trace_dir: str) -> int:
    """fn(args) under torch.profiler (CPU, plus CUDA where a card is
    present); the trace goes to <trace_dir>/trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        rc = fn(args)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace → %s", path)
    return rc


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    trace_dir = getattr(args, "profile_trace", None)
    rc = _profiled(args.fn, args, trace_dir) if trace_dir else args.fn(args)
    if getattr(args, "profile", False) and getattr(args, "out_dir", None):
        import json
        from .utils.logging import STAGE_TIMES, stage_report
        path = os.path.join(args.out_dir, "stage_times.json")
        os.makedirs(args.out_dir, exist_ok=True)
        with open(path, "w") as fh:
            json.dump({k: {"total_s": round(v[0], 4), "calls": v[1]}
                       for k, v in STAGE_TIMES.items()}, fh, indent=1)
        log.info("profile:\n%s\n→ %s", stage_report(), path)
    return rc


if __name__ == "__main__":
    sys.exit(main())
