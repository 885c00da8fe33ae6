"""Frozen copy of volcanosv_tpu_torch/sim.py at commit 656570a (the port's
simulator), kept under the benchmark so that later changes to the program
never change the benchmark's inputs.  Only this docstring differs from the
source; everything below it is the source as it stood.

Source: volcanosv_tpu_torch/sim.py, commit 656570a4db4e.  The source
describes itself as the diploid genome / SV / read simulator of the
golden tests: a random reference, two haplotypes with implanted SVs
(genotyped), error-bearing long reads per haplotype, and phase-block-style
contigs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BASES = np.array(list("ACGT"))


@dataclass
class TrueSV:
    chrom: str
    pos: int          # 0-based ref position (breakpoint, base before event)
    svtype: str       # DEL / INS / INV / DUP / BND
    svlen: int
    gt: tuple[int, int]   # (hap1, hap2) presence
    seq: str = ""     # inserted sequence for INS
    chrom2: str = ""  # BND mate chromosome
    pos2: int = 0     # BND mate position (0-based)
    nested_del: tuple[int, int] | None = None  # (rel_off, del_len) inside INV


@dataclass
class TrueSNP:
    chrom: str
    pos: int          # 0-based REF position
    hap: int          # 1 / 2 for het (alt on that hap), 0 for hom-alt
    ref: str
    alt: str


def random_genome(rng: np.random.Generator, length: int,
                  n_chroms: int = 1) -> dict[str, str]:
    out = {}
    for i in range(n_chroms):
        out[f"chr{i + 1}"] = "".join(rng.choice(BASES, length))
    return out


def implant_repeats(
    rng: np.random.Generator,
    ref: dict[str, str],
    n_tandem: int = 0,
    n_segdup: int = 0,
    n_homopoly: int = 0,
    tandem_unit: tuple[int, int] = (15, 120),
    tandem_copies: tuple[int, int] = (4, 12),
    segdup_len: tuple[int, int] = (3_000, 8_000),
    segdup_ident: float = 0.97,
    homopoly_len: tuple[int, int] = (15, 40),
    margin: int = 3_000,
) -> tuple[dict[str, str], dict[str, list[tuple[str, int, int]]]]:
    """Repeat-rich reference features — the genome regimes the reference's
    hardest machinery exists for (round-3 verdict item 6): tandem arrays
    (cluster/merge stress), dispersed segdup pairs at ≥95% identity
    (mis-mapping + assembly collapse → Flagger/SD-recovery territory,
    Evaluate_Assembly.py:55-69), and homopolymer runs (indel-error
    hotspots).  Length-preserving: each feature REPLACES its ref window so
    downstream truth coordinates stay valid.

    Returns (ref, features {chrom: [(kind, start, end)]})."""
    feats: dict[str, list[tuple[str, int, int]]] = {c: [] for c in ref}
    out = {}
    for chrom, seq in ref.items():
        arr = list(seq)
        L = len(arr)
        placed: list[tuple[int, int]] = []

        def _spot(width: int) -> int | None:
            for _ in range(2_000):
                p = int(rng.integers(margin, L - margin - width))
                if all(p + width + 500 <= s or p >= e + 500
                       for s, e in placed):
                    placed.append((p, p + width))
                    return p
            return None

        for _ in range(n_tandem):
            unit = int(rng.integers(*tandem_unit))
            copies = int(rng.integers(*tandem_copies))
            width = unit * copies
            p = _spot(width)
            if p is None:
                continue
            u = "".join(rng.choice(BASES, unit))
            arr[p:p + width] = list((u * copies)[:width])
            feats[chrom].append(("tandem", p, p + width))
        for _ in range(n_segdup):
            ln = int(rng.integers(*segdup_len))
            src = _spot(ln)
            dst = _spot(ln)
            if src is None or dst is None:
                continue
            copy = list(arr[src:src + ln])
            n_mut = rng.poisson((1 - segdup_ident) * ln)
            for i in rng.integers(0, ln, n_mut):
                copy[i] = str(rng.choice(BASES))
            arr[dst:dst + ln] = copy
            feats[chrom].append(("segdup_src", src, src + ln))
            feats[chrom].append(("segdup_dst", dst, dst + ln))
        for _ in range(n_homopoly):
            ln = int(rng.integers(*homopoly_len))
            p = _spot(ln)
            if p is None:
                continue
            arr[p:p + ln] = [str(rng.choice(BASES))] * ln
            feats[chrom].append(("homopoly", p, p + ln))
        out[chrom] = "".join(arr)
    return out, feats


_COMP = str.maketrans("ACGT", "TGCA")


def _revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def _rand_gt(rng: np.random.Generator, hom_frac: float) -> tuple[int, int]:
    if rng.random() < hom_frac:
        return (1, 1)
    return (1, 0) if rng.random() < 0.5 else (0, 1)


def implant_svs(
    rng: np.random.Generator,
    ref: dict[str, str],
    n_del: int = 5,
    n_ins: int = 5,
    n_inv: int = 0,
    n_dup: int = 0,
    min_len: int = 50,
    max_len: int = 500,
    min_gap: int = 2_000,
    hom_frac: float = 0.4,
    n_clustered: int = 0,
    n_nested: int = 0,
    n_small: int = 0,
) -> tuple[dict[str, str], dict[str, str], list[TrueSV]]:
    """Returns (hap1_seqs, hap2_seqs, truth). SVs are placed non-overlapping
    with >= min_gap spacing; het SVs are assigned to a random haplotype.

    Beyond the independent events, three stress classes (the reference's
    real-data regimes the golden gate must cover):

    * n_clustered — pairs of same-GT DEL+INS events 600-900bp apart: close
      enough that sloppy clustering (cluster_del max_shift=100 semantics,
      extract_contig_signature_Hifi.py:196-249) would merge them, far
      enough that a correct caller reports both.
    * n_nested — an INV whose inverted segment carries an interior deletion
      (two truth rows: the INV and the DEL in ref coordinates).
    * n_small — 2-49bp indels (the small-indel path's 2-49bp band,
      volcanosv-vc-small-indel.py awk size filter :35-68); excluded from
      the >=30bp large gate by truvari's -S filter.
    """
    hap1, hap2, truth = {}, {}, []
    for chrom, seq in ref.items():
        L = len(seq)
        # --- build the placement plan: (kind, width-reservation) slots ---
        slots: list[tuple[str, int]] = []
        for ty, cnt in (("DEL", n_del), ("INS", n_ins), ("INV", n_inv),
                        ("DUP", n_dup)):
            slots += [(ty, max_len)] * cnt
        slots += [("CLUSTER", 2 * max_len + 1000)] * n_clustered
        slots += [("NESTED", 700)] * n_nested
        slots += [("SMALL", 60)] * n_small
        rng.shuffle(slots)
        placed: list[tuple[int, int]] = []      # (start, end) incl. slack

        def _place(width: int) -> int | None:
            for _ in range(4_000):
                p = int(rng.integers(min_gap, L - min_gap - width))
                if all(p + width + min_gap <= s or p >= e + min_gap
                       for s, e in placed):
                    placed.append((p, p + width))
                    return p
            return None

        events: list[TrueSV] = []
        for kind, width in slots:
            p = _place(width)
            if p is None:
                continue
            if kind == "CLUSTER":
                gt = _rand_gt(rng, hom_frac)
                l1 = int(rng.integers(min_len, max_len + 1))
                l2 = int(rng.integers(min_len, max_len + 1))
                gap = int(rng.integers(600, 901))
                events.append(TrueSV(chrom, p, "DEL", l1, gt))
                events.append(TrueSV(
                    chrom, p + l1 + gap, "INS", l2, gt,
                    seq="".join(rng.choice(BASES, l2))))
            elif kind == "NESTED":
                gt = _rand_gt(rng, hom_frac)
                ln = int(rng.integers(300, 601))
                dlen = int(rng.integers(40, 81))
                off = int(rng.integers(60, ln - dlen - 60))
                events.append(TrueSV(chrom, p, "INV", ln, gt,
                                     nested_del=(off, dlen)))
                events.append(TrueSV(chrom, p + off, "DEL", dlen, gt))
            elif kind == "SMALL":
                # 2-29bp: below the large caller's 30bp floor, so the small
                # and large paths never double-report the same truth event
                gt = _rand_gt(rng, hom_frac)
                ln = int(rng.integers(2, 30))
                if rng.random() < 0.5:
                    events.append(TrueSV(chrom, p, "DEL", ln, gt))
                else:
                    events.append(TrueSV(
                        chrom, p, "INS", ln, gt,
                        seq="".join(rng.choice(BASES, ln))))
            else:
                ln = int(rng.integers(min_len, max_len + 1))
                gt = _rand_gt(rng, hom_frac)
                ins_seq = "".join(rng.choice(BASES, ln)) if kind == "INS" \
                    else ""
                events.append(TrueSV(chrom, p, kind, ln, gt, ins_seq))
        events.sort(key=lambda e: e.pos)
        truth.extend(events)

        for hap_idx, store in ((0, hap1), (1, hap2)):
            parts = []
            cur = 0
            for ev in events:
                if not ev.gt[hap_idx] or ev.pos < cur:
                    # a nested DEL truth row is realized by its parent INV
                    continue
                parts.append(seq[cur : ev.pos + 1])
                if ev.svtype == "DEL":
                    cur = ev.pos + 1 + ev.svlen
                elif ev.svtype == "INS":
                    parts.append(ev.seq)
                    cur = ev.pos + 1
                elif ev.svtype == "INV":
                    seg = seq[ev.pos + 1 : ev.pos + 1 + ev.svlen]
                    if ev.nested_del is not None:
                        off, dlen = ev.nested_del
                        seg = seg[:off] + seg[off + dlen:]
                    parts.append(_revcomp(seg))
                    cur = ev.pos + 1 + ev.svlen
                elif ev.svtype == "DUP":
                    seg = seq[ev.pos + 1 : ev.pos + 1 + ev.svlen]
                    parts.append(seg + seg)
                    cur = ev.pos + 1 + ev.svlen
            parts.append(seq[cur:])
            store[chrom] = "".join(parts)
    return hap1, hap2, truth


def _hap_offset(truth: list[TrueSV], chrom: str, pos: int, hap: int) -> int:
    """Length delta of haplotype `hap` vs the reference left of `pos`."""
    off = 0
    for e in truth:
        if e.chrom != chrom or e.pos >= pos or not e.gt[hap]:
            continue
        if e.svtype == "DEL":
            off -= e.svlen
        elif e.svtype in ("INS", "DUP"):
            off += e.svlen
    return off


def _sv_free_pos(truth: list[TrueSV], chrom: str, length: int,
                 margin: int) -> int:
    """A mid-chromosome position ≥ margin away from every implanted SV."""
    events = sorted(e.pos for e in truth if e.chrom == chrom)
    for p in range(length // 2, length - margin, 997):
        if all(abs(p - q) >= margin for q in events):
            return p
    return length // 2


def implant_tra(
    rng: np.random.Generator,
    ref: dict[str, str],
    hap1: dict[str, str],
    hap2: dict[str, str],
    truth: list[TrueSV] | None = None,
    chrom_a: str = "chr1",
    chrom_b: str = "chr2",
    pos_a: int | None = None,
    pos_b: int | None = None,
) -> list[TrueSV]:
    """Implant a homozygous reciprocal cross-chromosome translocation by
    swapping the chromosome tails of both haplotypes at (pos_a, pos_b) —
    mid-chromosome by default, in an SV-free window, with the tail-swap
    coordinates shifted per haplotype by the length deltas of the SVs
    implant_svs already placed (so the junction sits at EXACTLY
    (pos_a, pos_b) in reference coordinates on both haplotypes).

    Returns the four truth breakend rows (two junctions × two mates, VCF
    BND semantics)."""
    truth = truth or []
    margin = 4_000
    pa = pos_a if pos_a is not None else _sv_free_pos(
        truth, chrom_a, len(ref[chrom_a]), margin)
    pb = pos_b if pos_b is not None else _sv_free_pos(
        truth, chrom_b, len(ref[chrom_b]), margin)
    for hap_idx, hap in ((0, hap1), (1, hap2)):
        pa_h = pa + _hap_offset(truth, chrom_a, pa, hap_idx)
        pb_h = pb + _hap_offset(truth, chrom_b, pb, hap_idx)
        a, b = hap[chrom_a], hap[chrom_b]
        hap[chrom_a] = a[:pa_h] + b[pb_h:]
        hap[chrom_b] = b[:pb_h] + a[pa_h:]
    gt = (1, 1)
    return [
        TrueSV(chrom_a, pa, "BND", 0, gt, chrom2=chrom_b, pos2=pb),
        TrueSV(chrom_b, pb, "BND", 0, gt, chrom2=chrom_a, pos2=pa),
        TrueSV(chrom_b, pb, "BND", 0, gt, chrom2=chrom_a, pos2=pa),
        TrueSV(chrom_a, pa, "BND", 0, gt, chrom2=chrom_b, pos2=pb),
    ]


def implant_snps(
    rng: np.random.Generator,
    hap1: dict[str, str], hap2: dict[str, str],
    rate: float = 1 / 1500,
) -> tuple[dict[str, str], dict[str, str], dict[str, np.ndarray]]:
    """Sprinkle het SNPs (each on one random haplotype) — the phasing
    signal.  Returns (hap1, hap2, positions per chrom in hap coords of the
    mutated haplotype)."""
    bases = "ACGT"
    out1, out2, pos_out = {}, {}, {}
    for chrom in hap1:
        h1, h2 = list(hap1[chrom]), list(hap2[chrom])
        n = int(rate * min(len(h1), len(h2)))
        pos = np.sort(rng.choice(np.arange(100, min(len(h1), len(h2)) - 100),
                                 n, replace=False))
        for p in pos:
            target = h1 if rng.random() < 0.5 else h2
            old = target[p]
            alt = bases[(bases.index(old) + 1 + int(rng.integers(3))) % 4] \
                if old in bases else "A"
            if alt == old:
                alt = bases[(bases.index(old) + 1) % 4]
            target[p] = alt
        out1[chrom] = "".join(h1)
        out2[chrom] = "".join(h2)
        pos_out[chrom] = pos
    return out1, out2, pos_out


def implant_snps_ref(
    rng: np.random.Generator,
    ref: dict[str, str],
    hap1: dict[str, str], hap2: dict[str, str],
    truth: list[TrueSV],
    rate: float = 1 / 1500,
    hom_frac: float = 0.3,
    margin: int = 100,
) -> tuple[dict[str, str], dict[str, str], list[TrueSNP]]:
    """Implant SNPs at REF coordinates (away from every SV interval) so the
    truth supports SNP-accuracy and phasing switch-error gates.  Positions
    are mapped to each haplotype through the SV length offsets
    (_hap_offset), so the truth coordinate is exactly where reads carrying
    the allele align on the reference.  hom_frac of sites mutate both
    haplotypes (longshot emits those as 1/1); the rest are het on a random
    haplotype — the phasing signal."""
    bases = "ACGT"
    out1, out2 = dict(hap1), dict(hap2)
    snps: list[TrueSNP] = []
    for chrom in ref:
        L = len(ref[chrom])
        iv = sorted((e.pos - margin,
                     e.pos + (e.svlen if e.svtype != "INS" else 0) + margin)
                    for e in truth if e.chrom == chrom)
        starts = np.array([s for s, _ in iv] + [L + 1])
        ends = np.array([e for _, e in iv] + [L + 2])
        n = int(rate * L)
        cand = np.sort(rng.choice(np.arange(margin, L - margin),
                                  min(n * 2, L // 4), replace=False))
        # reject candidates inside any SV interval (+margin)
        j = np.searchsorted(starts, cand, side="right") - 1
        bad = (j >= 0) & (cand < ends[np.clip(j, 0, len(ends) - 1)])
        cand = cand[~bad]
        if len(cand) > n:
            # subsample UNIFORMLY — truncating the sorted list ([:n]) piled
            # every SNP into the low-coordinate half and left the tail of
            # the chromosome a het-SNP desert
            cand = np.sort(rng.choice(cand, n, replace=False))
        h1, h2 = list(out1[chrom]), list(out2[chrom])
        for p in cand:
            old = ref[chrom][p]
            if old not in bases:
                continue
            alt = bases[(bases.index(old) + 1 + int(rng.integers(3))) % 4]
            hom = rng.random() < hom_frac
            hap = 0 if hom else (1 if rng.random() < 0.5 else 2)
            wrote = []
            for hidx, arr in ((1, h1), (2, h2)):
                if not hom and hap != hidx:
                    continue
                # offset of this hap vs ref left of p
                hp = int(p) + _hap_offset(truth, chrom, int(p), hidx - 1)
                if 0 <= hp < len(arr):
                    arr[hp] = alt
                    wrote.append(hidx)
            if hom and len(wrote) == 2:
                snps.append(TrueSNP(chrom, int(p), 0, old, alt))
            elif wrote:
                snps.append(TrueSNP(chrom, int(p), wrote[0], old, alt))
        out1[chrom] = "".join(h1)
        out2[chrom] = "".join(h2)
    return out1, out2, snps


def mutate_read(rng: np.random.Generator, seq: str, sub_rate: float,
                indel_rate: float) -> str:
    """Apply sequencing errors (substitutions + 1-3bp indels)."""
    if sub_rate <= 0 and indel_rate <= 0:
        return seq
    arr = list(seq)
    n = len(arr)
    n_sub = rng.poisson(sub_rate * n)
    for i in rng.integers(0, n, n_sub):
        arr[i] = str(rng.choice(BASES))
    n_ind = rng.poisson(indel_rate * n)
    for _ in range(n_ind):
        i = int(rng.integers(1, len(arr) - 4))
        ln = int(rng.integers(1, 4))
        if rng.random() < 0.5:
            del arr[i : i + ln]
        else:
            arr[i:i] = list(rng.choice(BASES, ln))
    return "".join(arr)


def simulate_reads(
    rng: np.random.Generator,
    haps: dict[int, dict[str, str]],
    coverage: float = 20.0,
    read_len: int = 15_000,
    read_len_sd: int = 3_000,
    sub_rate: float = 0.001,
    indel_rate: float = 0.0005,
) -> list[tuple[str, str, int, str, int]]:
    """Sample reads per haplotype.

    Returns [(name, seq, hap, chrom, true_start)] — reads are strand-flipped
    at random; hap in {1, 2}."""
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    rid = 0
    for hap, seqs in haps.items():
        for chrom, seq in seqs.items():
            L = len(seq)
            n_reads = int(coverage * L / (2 * read_len))  # per hap: cov/2
            for _ in range(max(n_reads, 1)):
                ln = int(np.clip(rng.normal(read_len, read_len_sd),
                                 read_len // 4, L))
                start = int(rng.integers(0, max(L - ln, 1)))
                s = seq[start : start + ln]
                s = mutate_read(rng, s, sub_rate, indel_rate)
                if rng.random() < 0.5:
                    s = s.translate(comp)[::-1]
                reads.append((f"read_h{hap}_{rid}", s, hap, chrom, start))
                rid += 1
    return reads


def contigs_from_haplotypes(
    hap1: dict[str, str], hap2: dict[str, str],
    block_size: int = 120_000, overlap: int = 10_000,
) -> dict[str, str]:
    """Cut haplotypes into phase-block-style contigs named like the
    reference's assembly output: PS<pb>_<start>_<end>_hp{1,2}_<n>
    (General_Assembly_Workflow.py reformat_fasta:37-45) — the '-otherasm'
    entry point of the vc pipeline."""
    contigs = {}
    # phase-set ids use a per-chromosome global offset so block names are
    # unique across chromosomes (a 'PS1_...' per chrom would silently
    # collide in any name-keyed FASTA dict)
    base: dict[str, int] = {}
    off = 0
    for chrom in hap1:
        base[chrom] = off
        off += max(len(hap1[chrom]), len(hap2.get(chrom, ""))) + block_size
    for hp, haps in ((1, hap1), (2, hap2)):
        for chrom, seq in haps.items():
            L = len(seq)
            n = 0
            start = 0
            b = base[chrom]
            while start < L:
                end = min(L, start + block_size)
                name = (f"PS{b + start + 1}_{b + start + 1}_{b + end}"
                        f"_hp{hp}_{n}")
                contigs[name] = seq[start:end]
                if end >= L:
                    break
                start = end - overlap
                n += 1
    return contigs
