"""File-level checkpoint/resume, the reference's resumability contract.

ref: General_Assembly_Workflow.py log.txt/fail_log.txt skip lists
(:530-547), volcanosv-vc-large-indel.py -rdsig/-presig precomputed
signature dirs (:18-19, :158-181), check_reads_kmer_support.py --restart
kmer cache (:200-204).

Here one checkpoint directory per run holds per-stage artifacts; every
write is atomic (tmp + rename) so an interrupted run never leaves a
corrupt cache, and `--resume` re-enters at the first missing artifact.
"""
from __future__ import annotations

import os
import tempfile

from ..io.fasta import read_fasta, write_fasta
from ..io.vcf import VcfRecord, make_header, read_vcf, write_vcf
from ..vc.signatures import Signature
from .logging import get_logger, stage_timer

log = get_logger("checkpoint")

_SIG_FIELDS = ("chrom", "svtype", "pos", "svlen", "qname", "q_start",
               "q_end", "strand", "source", "mapq")


class CheckpointDir:
    """Per-run artifact cache under <out_dir>/checkpoints/.

    Artifacts are always written (cheap, atomic); `resume` gates whether
    existing artifacts are *reused* — a fresh run with the same out_dir
    recomputes unless --resume is passed."""

    def __init__(self, out_dir: str, resume: bool = False,
                 enabled: bool = True):
        self.base = os.path.join(out_dir, "checkpoints")
        self.resume = resume
        self.enabled = enabled
        if enabled:
            os.makedirs(self.base, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.base, name)

    def has(self, name: str) -> bool:
        return (self.enabled and self.resume
                and os.path.exists(self.path(name)))

    def _atomic(self, name: str, write_fn) -> None:
        if not self.enabled:
            return
        with stage_timer("io_write"):
            fd, tmp = tempfile.mkstemp(dir=self.base, prefix=name + ".")
            os.close(fd)
            try:
                write_fn(tmp)
                os.replace(tmp, self.path(name))
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)

    # FASTA (per-chromosome assembled contigs — the log.txt skip unit)
    def save_fasta(self, name: str, contigs: dict[str, str]) -> None:
        self._atomic(name, lambda p: write_fasta(p, contigs))

    def load_fasta(self, name: str) -> dict[str, str]:
        return read_fasta(self.path(name))

    # reads-signature TSV (chr*_reads_sig.txt / -rdsig equivalent)
    def save_sigs(self, name: str, sigs: list[Signature]) -> None:
        def w(p):
            with open(p, "w") as fh:
                fh.write("#" + "\t".join(_SIG_FIELDS) + "\n")
                for s in sigs:
                    fh.write("\t".join(
                        str(getattr(s, f)) for f in _SIG_FIELDS) + "\n")
        self._atomic(name, w)

    def load_sigs(self, name: str) -> list[Signature]:
        out: list[Signature] = []
        with open(self.path(name)) as fh:
            for line in fh:
                if line.startswith("#") or not line.strip():
                    continue
                f = line.rstrip("\n").split("\t")
                out.append(Signature(
                    chrom=f[0], svtype=f[1], pos=int(f[2]), svlen=int(f[3]),
                    qname=f[4], q_start=int(f[5]), q_end=int(f[6]),
                    strand=f[7], source=f[8], mapq=f[9]))
        return out

    # VCF records (per-chromosome phased SNPs)
    def save_vcf(self, name: str, records: list[VcfRecord]) -> None:
        self._atomic(name, lambda p: write_vcf(
            p, make_header({}, source="volcanosv_tpu-checkpoint"), records))

    def load_vcf(self, name: str) -> list[VcfRecord]:
        _h, recs = read_vcf(self.path(name))
        return recs

    # read-haplotype map (read_hp_og.p equivalent, prepare_info_v1.py:79-85)
    # rows: name<TAB>hp<TAB>phase-block — the block id matters because hap
    # labels are only orientation-consistent WITHIN a block
    def save_read_hp(self, name: str,
                     hp: dict[str, tuple[int, int]]) -> None:
        def w(p):
            with open(p, "w") as fh:
                for n, (h, b) in hp.items():
                    fh.write(f"{n}\t{h}\t{b}\n")
        self._atomic(name, w)

    def load_read_hp(self, name: str) -> dict[str, tuple[int, int]]:
        out: dict[str, tuple[int, int]] = {}
        with open(self.path(name)) as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if len(f) == 3:
                    out[f[0]] = (int(f[1]), int(f[2]))
        return out
