"""Command-line drivers of the port — same subcommands, flags and output
files as `volcanosv_tpu.cli`, plus `--device`:

    python -m volcanosv_tpu_torch.cli asm --ref ref.fa (--fastq reads.fq | --bam reads.bam) \\
        -o out/ [--hybrid_bed regions.bed] [--emit_fastqs] [--device cuda]
    python -m volcanosv_tpu_torch.cli vc-large-indel --ref ref.fa --contig contigs.fa \\
        [--fastq reads.fq | --bam reads.bam] -o out/ [--device cuda]
    python -m volcanosv_tpu_torch.cli eval --base truth.vcf --comp calls.vcf [--device cuda]

`--device` names the torch device the device stages run on (default
`cuda`); asking for CUDA on a host without it raises.  The drivers run in
one process: each chromosome of the reference is assembled or called here,
and the WGS-global coverage median is the host median of all chromosomes'
values (the single-process path of the reference).

The `--contig` FASTAs use the reference's contig naming contract
(PS<pb>_<start>_<end>_hp{1,2}_<n>, or hp1/hp2-only names for whole-haplotype
assemblies)."""
from __future__ import annotations

import argparse
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
        from .io.bam import BamReader, scan_bam
        sc = scan_bam(args.bam)            # native parallel-inflate loader
        if sc is not None:
            return sc.read_seqs()
        with BamReader(args.bam) as br:
            for rec in br:
                if rec.seq and not rec.is_secondary and not rec.is_supplementary:
                    seqs[rec.name] = rec.seq
    return seqs


def _align_by_chrom(ref: dict[str, str], seqs: dict[str, str], preset: str,
                    device, want: list[str]) -> dict[str, list]:
    """Align sequences to ref; returns the records of the chromosomes in
    `want`, by chromosome."""
    from .aligner import Aligner
    from .config import AlignConfig
    aligner = Aligner(ref, AlignConfig.preset(preset), device=device)
    recs = aligner.to_bam_records(aligner.align(list(seqs.items())), seqs)
    by_chrom: dict[str, list] = {c: [] for c in ref}
    for r in recs:
        by_chrom[aligner.names[r.ref_id]].append(r)
    return {c: by_chrom.get(c, []) for c in want}


def _read_preset(dtype: str) -> str:
    return {"Hifi": "map-hifi", "CLR": "map-pb", "ONT": "map-ont"}[dtype]


def _vcf_out(out_dir: str, name: str, ref: dict[str, str], records) -> str:
    from .io.vcf import make_header, write_vcf
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    n = write_vcf(path, make_header({c: len(s) for c, s in ref.items()}),
                  records)
    log.info("wrote %d records → %s", n, path)
    return path


def _reads_sigs_cached(args, cfg, reads_by_chrom, chroms):
    """Per-chrom reads signatures with checkpoint reuse (the -rdsig dir
    contract, volcanosv-vc-large-indel.py:18-19)."""
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


def host_median(values: np.ndarray) -> float:
    """float32 median of the concatenated all-chromosome values — the
    reference's WGS-global statistic on its single-process path
    (parallel/wgs.py:88-111), bit for bit."""
    s = np.sort(np.asarray(values, np.float32).reshape(-1))
    n = len(s)
    if n == 0:
        return 0.0
    return float((s[(n - 1) // 2] + s[n // 2]) / np.float32(2))


def _call_large_indels(ref, by_chrom, contigs, cfg, reads_by_chrom,
                       reads_sigs, chroms, device, include_bed=None):
    """All-chromosome large-indel calling with the WGS-global coverage
    median over every chromosome's rel_cov values (the reference's
    per-run median after the all-chromosome concat,
    volcanosv-vc-large-indel.py:266-278 + filter_vcf_by_sig_cov_insdel.py
    :38-55)."""
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
        for svtype, apply_it in (("DEL", cfg.cov_filter.apply_del),
                                 ("INS", cfg.cov_filter.apply_ins)):
            if not apply_it:
                continue
            rels = [rel_coverage(raw[c][0], raw[c][1], cfg.cov_filter,
                                 svtype)[1] for c in have_sigs]
            glob = np.concatenate(rels).astype(np.float32) if rels \
                else np.zeros(0, np.float32)
            if len(glob) < cfg.cov_filter.min_calls:
                continue
            medians[svtype] = host_median(glob)
            log.info("WGS-global %s rel_cov median: %.4f over %d calls",
                     svtype, medians[svtype], len(glob))
    records = []
    for chrom in chroms:
        recs, gt_sigs = raw[chrom]
        records += finalize_chromosome(
            recs, gt_sigs, (reads_by_chrom or {}).get(chrom), cfg,
            cov_medians=medians or None)
    return records


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

def _run_asm(ref, read_seqs, args, device):
    """phase → partition → assemble every chromosome on `device`.

    Returns (contigs, phased SNP VcfRecords — the longshot-VCF-equivalent
    output, README.md:237-238).
    Per-chromosome results checkpoint to <out_dir>/checkpoints/ and are
    reused under --resume (the reference's log.txt skip-list contract,
    General_Assembly_Workflow.py:530-547).  Writes <out_dir>/phased.bam
    with HP/PS tags when any chromosome is assembled."""
    from .io.bam import BamWriter
    from .ops.pack import encode_seq
    from .phasing import snp_vcf_records
    from .pipeline.asm import assemble_chromosome
    cfg = PipelineConfig.for_dtype(args.dtype)
    ckpt = _ckpt(args)
    bed = {}
    if args.hybrid_bed:
        from .io.bed import read_bed
        bed = read_bed(args.hybrid_bed)
    chroms = [args.chrom] if args.chrom else list(ref)
    todo = [c for c in chroms
            if not (ckpt.has(f"asm_{c}.fa") and ckpt.has(f"snps_{c}.vcf"))]
    by_chrom, phased_writer = {}, None
    if todo:
        with stage_timer("align-reads", log):
            by_chrom = _align_by_chrom(ref, read_seqs,
                                       _read_preset(args.dtype), device,
                                       chroms)
        # phased BAM with HP/PS tags — longshot's '-O phased.bam' artifact
        # (volcanosv-asm.py:75-80; tag semantics prepare_info_v1.py:42-63)
        os.makedirs(args.out_dir, exist_ok=True)
        phased_writer = BamWriter(os.path.join(args.out_dir, "phased.bam"),
                                  list(ref), [len(s) for s in ref.values()])
    results: dict[str, tuple[dict, list]] = {}
    for chrom in chroms:
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
        if args.emit_fastqs:
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
    contigs: dict[str, str] = {}
    snp_records = []
    for chrom in chroms:
        ctgs, snps = results[chrom]
        snp_records += snps
        for name, seq in ctgs.items():
            while name in contigs:            # cross-chrom PS id collision
                name += "b"
            contigs[name] = seq
    return contigs, snp_records


def cmd_asm(args) -> int:
    from .io.fasta import read_fasta, write_fasta
    device = resolve_device(args.device)
    ref = read_fasta(args.ref)
    read_seqs = _load_reads(args)
    if not read_seqs:
        log.error("asm requires --fastq or --bam")
        return 2
    contigs, snp_records = _run_asm(ref, read_seqs, args, device)
    _vcf_out(args.out_dir, "phased_snps.vcf", ref, snp_records)
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "final_contigs.fa")
    write_fasta(out, contigs)
    log.info("assembly: %d contigs → %s", len(contigs), out)
    return 0


def cmd_vc_large_indel(args) -> int:
    from .io.fasta import read_fasta
    device = resolve_device(args.device)
    ref = read_fasta(args.ref)
    contigs = read_fasta(args.contig)
    cfg = PipelineConfig.for_dtype(args.dtype, asm=args.asm)
    bed = None
    if args.bed:
        from .io.bed import read_bed
        bed = read_bed(args.bed)
    chroms = _restrict_chroms(args, list(ref), bed)
    with stage_timer("align-contigs", log):
        by_chrom = _align_by_chrom(ref, contigs, "asm5", device, chroms)
    reads_by_chrom = None
    if args.fastq or args.bam:
        read_seqs = _load_reads(args)
        with stage_timer("align-reads", log):
            reads_by_chrom = _align_by_chrom(
                ref, read_seqs, _read_preset(args.dtype), device, chroms)
    reads_sigs = _reads_sigs_cached(args, cfg, reads_by_chrom, chroms)
    records = _call_large_indels(ref, by_chrom, contigs, cfg,
                                 reads_by_chrom, reads_sigs, chroms, device,
                                 include_bed=bed)
    _vcf_out(args.out_dir, "volcanosv_large_indel.vcf", ref, records)
    return 0


def cmd_eval(args) -> int:
    """Truvari-equivalent benchmark (README.md:493-498 protocol)."""
    import json
    from .eval import EvalParams, evaluate_files
    res = evaluate_files(args.base, args.comp, EvalParams(
        refdist=args.refdist, pctsize=args.pctsize, pctsim=args.pctsim,
        pctovl=args.pctovl, minsize=args.minsize),
        device=resolve_device(args.device))
    print(json.dumps(res.summary()))
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
    _add_device(p)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="volcanosv_tpu_torch",
        description="PyTorch/CUDA port of the diploid SV engine")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("asm", help="phase + partition + assemble")
    _add_common(p, contig=False)
    p.add_argument("--chrom", help="restrict to one chromosome")
    p.add_argument("--hybrid_bed",
                   help="BED of regions assembled with the in-BED profile "
                        "(hybrid mode, volcanosv-asm_hybrid.py parity)")
    p.add_argument("--emit_fastqs", action="store_true",
                   help="also write fastq_by_hap/<hap>.fastq per haplotype "
                        "(write_fastq_asm_general.py parity)")
    p.set_defaults(fn=cmd_asm)

    p = sub.add_parser("vc-large-indel", help="large-indel calling (≥30bp)")
    _add_common(p, contig=True)
    p.set_defaults(fn=cmd_vc_large_indel)

    p = sub.add_parser("eval", help="truvari-equivalent SV benchmark")
    p.add_argument("--base", required=True, help="truth VCF")
    p.add_argument("--comp", required=True, help="call VCF")
    p.add_argument("-r", "--refdist", type=int, default=500)
    p.add_argument("-P", "--pctsize", type=float, default=0.5)
    p.add_argument("-p", "--pctsim", type=float, default=0.5)
    p.add_argument("-O", "--pctovl", type=float, default=0.01)
    p.add_argument("-S", "--minsize", type=int, default=30)
    _add_device(p)
    p.set_defaults(fn=cmd_eval)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    rc = args.fn(args)
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
