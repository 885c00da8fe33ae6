"""The benchmark's plain judge: a job's outputs against what the generator
implanted.  Plain Python and NumPy; it imports nothing of the program.

The SV matcher is a frozen copy of `evaluate` in volcanosv_tpu_torch/eval.py
at commit 656570a (truvari 4 semantics: -r 500 -P 0.5 -p 0.5 -O 0.01 -S 30,
one-to-one greedy by score, DUP and INS compatible), with its ALT-sequence
similarity worked out by a plain edit distance in NumPy in place of the
port's device kernel.  The SNP scorer is a frozen copy of `evaluate_snps`
from the same file.  The contigs are judged by canonical 21-mers against
the two true haplotypes, in the manner of Merqury's k-mer QV and
completeness.

`judge_job` gives a job's counts; `pool` turns the counts of a window's jobs
into the numbers compared with the cell's limits.  `sv_err` and `small_err`
count the missed truth and the false calls together, over the truth: a
caller that reports nothing reads 1, and so does one that reports every
call twice.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

K = 21


# --- VCF ------------------------------------------------------------------

@dataclass
class Rec:
    chrom: str
    pos: int          # 1-based
    ref: str
    alt: str
    info: dict
    gt: str
    ps: int | None = None

    @property
    def svtype(self) -> str:
        return self.info.get("SVTYPE", "")

    @property
    def svlen(self) -> int:
        if "SVLEN" in self.info:
            return abs(int(self.info["SVLEN"]))
        return abs(len(self.alt) - len(self.ref))


def read_vcf(path: str) -> list[Rec]:
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 8:
                raise ValueError(f"{path}: malformed VCF line {line[:80]!r}")
            info = {}
            if f[7] != ".":
                for kv in f[7].split(";"):
                    k, _, v = kv.partition("=")
                    info[k] = v if _ else True
            gt, ps = "./.", None
            if len(f) > 9:
                d = dict(zip(f[8].split(":"), f[9].split(":")))
                gt = d.get("GT", "./.")
                if d.get("PS", ".") not in (".", ""):
                    ps = int(d["PS"])
            out.append(Rec(f[0], int(f[1]), f[3], f[4], info, gt, ps))
    return out


def read_fasta(path: str) -> dict[str, str]:
    seqs: dict[str, list[str]] = {}
    name = None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                name = line[1:].split()[0]
                seqs[name] = []
            elif name is not None:
                seqs[name].append(line)
    return {k: "".join(v) for k, v in seqs.items()}


# --- the SV matcher (eval.py's `evaluate`, frozen) --------------------------

@dataclass(frozen=True)
class EvalParams:
    refdist: int = 500
    pctsize: float = 0.5
    pctsim: float = 0.5
    pctovl: float = 0.01
    minsize: int = 30
    maxsize: int = 0
    typematch: bool = True
    dup_to_ins: bool = True


_SPAN_TYPES = ("DEL", "INV", "DUP")


def _svtype(r: Rec) -> str:
    t = r.svtype
    if t:
        return "DUP" if t.startswith("DUP") else t
    return "INS" if len(r.alt) > len(r.ref) else "DEL"


def _end(r: Rec, svtype: str) -> int:
    if "END" in r.info:
        return int(r.info["END"])
    return r.pos + (r.svlen if svtype in _SPAN_TYPES else 0)


def _is_symbolic(r: Rec) -> bool:
    return r.alt.startswith("<") or r.alt in (".", "") or r.ref == "N"


def zygosity(gt: str) -> str:
    alleles = gt.replace("|", "/").split("/")
    alts = sum(a == "1" for a in alleles)
    return "hom" if alts >= 2 else ("het" if alts == 1 else "ref")


def _ins_seq(r: Rec) -> str:
    return r.alt[1:] if len(r.alt) > len(r.ref) else r.alt


_CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[ord(chr(_c).lower())] = _i


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance, one NumPy row at a time: a row's diagonal and
    up moves first, then the left moves as a running minimum of
    (cell - column) + column."""
    x = np.frombuffer(a.encode(), np.uint8)
    y = np.frombuffer(b.encode(), np.uint8)
    if len(x) == 0 or len(y) == 0:
        return max(len(x), len(y))
    cols = np.arange(len(y) + 1, dtype=np.int64)
    prev = cols.copy()
    for i in range(1, len(x) + 1):
        cur = np.empty_like(prev)
        cur[0] = i
        cur[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (y != x[i - 1]))
        prev = np.minimum.accumulate(cur - cols) + cols
    return int(prev[-1])


def edit_sim(a: str, b: str) -> float:
    """(len1 + len2 - ed) / (len1 + len2), as the port's edit_sim_batch."""
    tot = max(len(a) + len(b), 1)
    return (tot - edit_distance(a, b)) / tot


def evaluate(base: list[Rec], comp: list[Rec],
             params: EvalParams = EvalParams()) -> dict:
    """Match comp calls against base truth: TP, FP, FN and the matched
    pairs whose zygosity agrees."""
    def keep(r: Rec) -> bool:
        if _svtype(r) == "BND":
            return not params.maxsize
        s = r.svlen
        if s < params.minsize:
            return False
        return not (params.maxsize and s > params.maxsize)

    bidx = [i for i, r in enumerate(base) if keep(r)]
    cidx = [j for j, r in enumerate(comp) if keep(r)]
    cands: list[tuple[float, int, int]] = []
    seq_pairs: list[tuple[str, str]] = []
    seq_pos: list[int] = []
    for j in cidx:
        c = comp[j]
        ct = _svtype(c)
        for i in bidx:
            b = base[i]
            bt = _svtype(b)
            if b.chrom != c.chrom:
                continue
            if params.typematch and bt != ct:
                if not ({bt, ct} == {"DUP", "INS"} and params.dup_to_ins):
                    continue
            if abs(b.pos - c.pos) > params.refdist:
                continue
            if bt == "BND":
                if str(b.info.get("CHR2", "")) != str(c.info.get("CHR2", "")):
                    continue
                if abs(int(b.info.get("END", b.pos))
                       - int(c.info.get("END", c.pos))) > params.refdist:
                    continue
                ssim = 1.0
            else:
                ssim = min(b.svlen, c.svlen) / max(b.svlen, c.svlen, 1)
                if ssim < params.pctsize:
                    continue
            ovl = 1.0
            if bt in _SPAN_TYPES and ct in _SPAN_TYPES:
                be, ce = _end(b, bt), _end(c, ct)
                inter = min(be, ce) - max(b.pos, c.pos)
                ovl = inter / max(min(be - b.pos, ce - c.pos), 1)
                if ovl < params.pctovl:
                    continue
            score = ssim + max(ovl, 0.0) \
                - abs(b.pos - c.pos) / max(params.refdist, 1) * 0.1
            k = len(cands)
            cands.append((score, i, j))
            if (bt == "INS" and params.pctsim > 0
                    and not _is_symbolic(b) and not _is_symbolic(c)):
                seq_pairs.append((_ins_seq(b), _ins_seq(c)))
                seq_pos.append(k)
    if seq_pairs:
        drop = {seq_pos[n] for n, (a, b) in enumerate(seq_pairs)
                if 2.0 * edit_sim(a, b) - 1.0 < params.pctsim}
        cands = [c for k, c in enumerate(cands) if k not in drop]
    cands.sort(key=lambda t: -t[0])
    used_b: set[int] = set()
    used_c: set[int] = set()
    tp = gt_ok = 0
    for _score, i, j in cands:
        if i in used_b or j in used_c:
            continue
        used_b.add(i)
        used_c.add(j)
        tp += 1
        gt_ok += zygosity(base[i].gt) == zygosity(comp[j].gt)
    return dict(truth=len(bidx), calls=len(cidx), tp=tp,
                fn=len(bidx) - tp, fp=len(cidx) - tp, gt_ok=gt_ok)


def evaluate_snps(truth: list[Rec], calls: list[Rec]) -> dict:
    """eval.py's `evaluate_snps`, frozen, as counts: TP (site and ALT),
    calls, zygosity agreements, and adjacent phase switches in each called
    block."""
    t_by_key = {(r.chrom, r.pos): r for r in truth}
    tp = zyg_ok = n_called = 0
    blocks: dict[tuple, list[tuple[int, int]]] = {}
    for c in calls:
        if len(c.ref) != 1 or len(c.alt) != 1:
            continue
        n_called += 1
        t = t_by_key.get((c.chrom, c.pos))
        if t is None or t.alt != c.alt:
            continue
        tp += 1
        t_hom = t.gt in ("1/1", "1|1")
        c_hom = c.gt in ("1/1", "1|1")
        zyg_ok += t_hom == c_hom
        if not t_hom and not c_hom and "|" in c.gt and c.ps is not None:
            t_hap = 1 if t.gt == "1|0" else 2
            c_hap = 1 if c.gt == "1|0" else 2
            blocks.setdefault((c.chrom, c.ps), []).append(
                (c.pos, int(t_hap == c_hap)))
    switches = pairs = 0
    for sites in blocks.values():
        sites.sort()
        for (_p0, o0), (_p1, o1) in zip(sites, sites[1:]):
            pairs += 1
            switches += int(o0 != o1)
    return dict(truth=len(t_by_key), calls=n_called, tp=tp, gt_ok=zyg_ok,
                switches=switches, switch_pairs=pairs)


# --- contigs by k-mers ------------------------------------------------------

def canonical_kmers(seq: str, k: int = K) -> np.ndarray:
    """Every canonical k-mer of seq (2 bits a base) that holds only A, C,
    G and T, in order."""
    codes = _CODE[np.frombuffer(seq.encode(), np.uint8)].astype(np.uint64)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    fwd = np.zeros(n, np.uint64)
    rev = np.zeros(n, np.uint64)
    bad = np.zeros(n, bool)
    for j in range(k):
        c = codes[j:j + n]
        bad |= c > 3
        c = np.minimum(c, 3)
        fwd = (fwd << np.uint64(2)) | c
        rev |= (np.uint64(3) - c) << np.uint64(2 * j)
    return np.minimum(fwd, rev)[~bad]


def judge_contigs(contigs: dict[str, str], hap1: dict, hap2: dict) -> dict:
    """Contig k-mers absent from both haplotypes, and distinct haplotype
    k-mers absent from the contigs."""
    hap = np.unique(np.concatenate(
        [canonical_kmers(s) for h in (hap1, hap2) for s in h.values()]))
    ctg = np.concatenate([canonical_kmers(s) for s in contigs.values()]
                         or [np.zeros(0, np.uint64)])
    bad = int((~np.isin(ctg, hap, assume_unique=False)).sum())
    ctg_set = np.unique(ctg)
    missing = int((~np.isin(hap, ctg_set, assume_unique=True)).sum())
    return dict(kmers=int(len(ctg)), bad=bad, hap_kmers=int(len(hap)),
                missing=missing)


# --- a job ------------------------------------------------------------------

def truth_records(truth: dict) -> tuple[list[Rec], list[Rec]]:
    """The implanted SVs and indels, and the SNPs, as VCF records.  An INS
    carries its inserted sequence after the reference base, so that the
    matcher compares sequences; the other types are symbolic."""
    svs = []
    for chrom, pos, svtype, svlen, gt, seq in truth["svs"]:
        g = "1|1" if tuple(gt) == (1, 1) else ("1|0" if gt[0] else "0|1")
        info = {"SVTYPE": svtype, "SVLEN": svlen, "END": pos + 1 + svlen}
        if svtype == "INS" and seq:
            base = truth["ref"][chrom][pos]
            svs.append(Rec(chrom, pos + 1, base, base + seq, info, g))
        else:
            svs.append(Rec(chrom, pos + 1, "N", f"<{svtype}>", info, g))
    snps = [Rec(c, p + 1, r, a, {},
                "1/1" if h == 0 else ("1|0" if h == 1 else "0|1"))
            for c, p, h, r, a in truth["snps"]]
    return svs, snps


# which output file holds which answer
MERGED = "volcanosv_variants.vcf"
SNPS = "phased_snps.vcf"
CONTIGS = "final_contigs.fa"


def judge_job(truth: dict, out_dir: str, answers: list[str]) -> dict:
    """A job's counts.  `answers` names what the cell's drivers produce:
    "svs" (the merged VCF: SVs of 30 bp and more, and indels of 2-29 bp),
    "snps" (the phased SNP VCF) and "contigs" (the assembly).  A missing
    or malformed output raises."""
    tsv, tsnp = truth_records(truth)
    out = dict(length=sum(len(s) for s in truth["ref"].values()))
    if "svs" in answers:
        calls = read_vcf(os.path.join(out_dir, MERGED))
        out["sv"] = evaluate(tsv, calls, EvalParams())
        out["small"] = evaluate(tsv, calls, EvalParams(
            minsize=2, maxsize=29, pctsim=0.0))
    if "snps" in answers:
        out["snp"] = evaluate_snps(tsnp, read_vcf(os.path.join(out_dir, SNPS)))
    if "contigs" in answers:
        out["contig"] = judge_contigs(
            read_fasta(os.path.join(out_dir, CONTIGS)),
            truth["hap1"], truth["hap2"])
    return out


def _ratio(num: float, den: float) -> float | None:
    return num / den if den else None


def pool(jobs: list[dict]) -> dict:
    """The numbers of a window: each a ratio of sums over its jobs."""
    def s(group, key):
        return sum(j[group][key] for j in jobs if group in j)
    per_100kb = sum(j["length"] for j in jobs) / 1e5
    out = {}
    if any("sv" in j for j in jobs):
        out["sv_miss"] = _ratio(s("sv", "fn"), s("sv", "truth"))
        out["sv_err"] = _ratio(s("sv", "fn") + s("sv", "fp"),
                               s("sv", "truth"))
        out["sv_fp_per_100kb"] = _ratio(s("sv", "fp"), per_100kb)
        out["sv_gt_err"] = _ratio(s("sv", "tp") - s("sv", "gt_ok"),
                                  s("sv", "tp"))
        out["small_miss"] = _ratio(s("small", "fn"), s("small", "truth"))
        out["small_err"] = _ratio(s("small", "fn") + s("small", "fp"),
                                  s("small", "truth"))
        out["small_fp_per_100kb"] = _ratio(s("small", "fp"), per_100kb)
        out["small_gt_err"] = _ratio(s("small", "tp") - s("small", "gt_ok"),
                                     s("small", "tp"))
    if any("snp" in j for j in jobs):
        out["snp_miss"] = _ratio(s("snp", "truth") - s("snp", "tp"),
                                 s("snp", "truth"))
        out["snp_fp_per_100kb"] = _ratio(s("snp", "calls") - s("snp", "tp"),
                                         per_100kb)
        out["snp_gt_err"] = _ratio(s("snp", "tp") - s("snp", "gt_ok"),
                                   s("snp", "tp"))
        out["switch_err"] = _ratio(s("snp", "switches"),
                                   s("snp", "switch_pairs"))
    if any("contig" in j for j in jobs):
        out["contig_err"] = _ratio(s("contig", "bad"), s("contig", "kmers"))
        out["contig_miss"] = _ratio(s("contig", "missing"),
                                    s("contig", "hap_kmers"))
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every one is
    read and at or under its limit."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        checks[name] = {"value": v, "limit": limit}
        if v is None or v > limit:
            ok = False
    return ok, checks
