"""Read-backed phasing: MEC (minimum error correction) via alternating
majority votes — the batched device core of what longshot/HapCUT2 do.

Model: each het SNP s has phase h[s] ∈ {+1,-1} (which haplotype carries the
alt allele); each read r has assignment a[r] ∈ {+1,-1}.  Observation
(r, s, o) with o=+1 (ref) or -1 (alt) is *consistent* when a[r]·h[s]·o = +1
(conventions fixed so hap +1 carries ref at h=+1 sites).  Alternating
updates

    a[r] = sign( Σ_obs(r) h[s]·o )        (read majority vote)
    h[s] = sign( Σ_obs(s) a[r]·o )        (SNP majority vote)

monotonically decrease the MEC objective; both are segment-sums over the
observation list.  Restarts with different random inits escape local
optima.  The random inits are the reference's `jax.random` draws,
reproduced bit for bit by utils/threefry.py, so every restart is the
reference's.  `_mec_phase` runs the hand-written CUDA kernels
(`csrc/mec.cu`: a counting sort of the observations into CSR order on the
card, then row sums; a cluster of 1-16 CTAs a restart with the CSR in
shared memory, or a grid over the rows at chromosome scale, as `mec_plan`
picks) for CUDA tensors and `_mec_phase_plain` (torch ops, the restarts a
batch dimension, `index_add_` for the sums) for CPU tensors.

Phase blocks: consecutive het SNPs stay in one block iff some read covers
both (connectivity sweep); per-block sign is arbitrary, as in any phaser.

ref comparison: longshot (Rust, ~10k LoC) — invoked volcanosv-asm.py:75-80;
phase-block and HP/PS semantics follow prepare_info_v1.py:42-85.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import PhasingConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..utils import threefry
from .pileup import PileupResult


def chain_init(obs_read: np.ndarray, obs_snp: np.ndarray,
               obs_allele: np.ndarray, n_snps: int) -> np.ndarray:
    """Phase init by chain propagation: for consecutive SNPs observed on the
    same read, vote on whether they share a haplotype (o_i·o_j), then take
    the prefix product of vote signs.  Near-exact for SNP chains — the
    alternating MEC pass then heals residual errors."""
    votes = np.zeros(max(n_snps - 1, 0), np.int64)
    order = np.lexsort((obs_snp, obs_read))
    r, s, o = obs_read[order], obs_snp[order], obs_allele[order].astype(np.int64)
    same_read = r[1:] == r[:-1]
    informative = (o[1:] != 0) & (o[:-1] != 0) & same_read
    # vote between s[i] and s[i+1]: sign(o_i*o_j); accumulate at the left
    # SNP of each adjacent pair (pairs may skip SNPs; propagation still
    # anchors where coverage exists)
    left = np.minimum(s[:-1], s[1:])[informative]
    sign = (o[1:] * o[:-1])[informative]
    np.add.at(votes, np.clip(left, 0, n_snps - 2), sign)
    rel = np.where(votes >= 0, 1, -1)
    h = np.ones(n_snps, np.int64)
    if n_snps > 1:
        h[1:] = np.cumprod(rel)
    return h.astype(np.int32)


def restart_inits(h_init: np.ndarray, seed: int,
                  n_restarts: int) -> np.ndarray:
    """(n_restarts, S) int32 initial phases: row 0 is h_init (chain init),
    row i > 0 the reference's `rademacher(split(PRNGKey(seed),
    n_restarts)[i], (S,), int32)`."""
    S = len(h_init)
    keys = threefry.split(threefry.prng_key(seed), n_restarts)
    h0 = np.empty((n_restarts, S), np.int32)
    h0[0] = h_init
    for i in range(1, n_restarts):
        h0[i] = threefry.rademacher(keys[i], S)
    return h0


def _mec_phase_plain(obs_read: torch.Tensor, obs_snp: torch.Tensor,
                     obs_allele: torch.Tensor, h0: torch.Tensor, *,
                     n_reads: int, n_iter: int):
    """Batched alternating majority votes over the restarts, on the inputs'
    device.  h0: (n_restarts, n_snps) int32 initial phases (restart_inits).
    Returns (h, a, mec) of the best restart: h (n_snps,) ±1, a (n_reads,)
    ±1, mec scalar — the first restart of the lowest MEC, as jnp.argmin
    picks it."""
    o = obs_allele.to(torch.int32)
    obs_read = obs_read.to(torch.int64)
    obs_snp = obs_snp.to(torch.int64)
    n_restarts, n_snps = h0.shape
    dev = h0.device

    def votes(x, src, dst, n):          # segment_sum over the restarts
        out = torch.zeros((n_restarts, n), dtype=torch.int32, device=dev)
        return out.index_add_(1, dst, x[:, src] * o)

    def sign(v):
        return torch.where(v >= 0, 1, -1).to(torch.int32)

    h = h0
    for _ in range(n_iter):
        a = sign(votes(h, obs_snp, obs_read, n_reads))
        h = sign(votes(a, obs_read, obs_snp, n_snps))
    a = sign(votes(h, obs_snp, obs_read, n_reads))
    # MEC = #observations inconsistent with (a, h)
    consistent = a[:, obs_read] * h[:, obs_snp] * o
    mecs = ((consistent < 0) & (o != 0)).sum(dim=1)
    best = int(torch.argmin(mecs))      # the first index of the minimum
    return h[best], a[best], mecs[best]


_BRANCHES = {"auto": 0, "smem": 1, "grid": 2}
MAX_RESTARTS = 64
MAX_NODES = 2**30           # reads and SNPs: a CSR entry packs node * 2 + sign
MEC_MAX_CTAS = 16           # a thread-block cluster's most CTAs (non-portable)
# The smem design's CTAs a restart: one up to MEC_ONE_CTA_MAX_OBS
# observations, where a cluster barrier (0.75 us a half-step on an H100)
# costs more than splitting the walk saves (the golden run's sets, O 4-5k),
# and MEC_CLUSTER_CTAS above (`asm`'s set, O 28k).  chip_smoke.py's phase
# 4b times one CTA against 8 in turns from O 4,874 to 19,097
# (`_mec_one_cta_limit`, PERF.md §6): one CTA was faster up to O 12,199
# (by 1% there) and 8 from O 14,414 on.
MEC_ONE_CTA_MAX_OBS = 12_500
MEC_CLUSTER_CTAS = 8


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def mec_smem_need(S: int, R: int, O: int, ctas: int) -> tuple[int, int]:
    """Bytes of one CTA's shared memory in the smem design at `ctas` CTAs a
    restart, for S SNPs, R reads and at most O informative observations:
    (what must fit: int8 h and a, the 32-bit row offsets of its slice of
    each order, at most ceil((rows + O) / ctas) rows and all at one CTA;
    with the entries of an even slice, 16-bit where S and R are below 2^15,
    else 32-bit).  The twin of csrc/mec.cu::smem_need."""
    def per_cta(n):
        return -(-(n + O) // ctas)
    rows_r, rows_s = min(R, per_cta(R)), min(S, per_cta(S))
    ent = min(O, per_cta(R)) + min(O, per_cta(S))
    esize = 2 if S < 2**15 and R < 2**15 else 4
    fixed = _round16(S) + _round16(R) + _round16(4 * (rows_r + 1)) + \
        _round16(4 * (rows_s + 1))
    return fixed, fixed + _round16(esize * ent)


def mec_plan(S: int, R: int, O: int, smem_bytes: int) -> tuple[str, int]:
    """The MEC kernels' design for S SNPs, R reads and O observations:
    ("smem", ctas) at one CTA a restart up to MEC_ONE_CTA_MAX_OBS
    observations, else (or where one CTA's slice does not fit) at
    MEC_CLUSTER_CTAS, where each CTA holds its whole slice in `smem_bytes`
    of shared memory (mec_smem_need); else ("grid", 0)."""
    first = 1 if O <= MEC_ONE_CTA_MAX_OBS else MEC_CLUSTER_CTAS
    for ctas in (first, MEC_CLUSTER_CTAS):
        if mec_smem_need(S, R, O, ctas)[1] <= smem_bytes:
            return "smem", ctas
    return "grid", 0


_SMEM_BYTES = {}


def mec_smem_bytes(lib) -> int:
    """The shared memory a CTA of the smem design takes on the current
    device (csrc/mec.cu), asked once a device."""
    dev = torch.cuda.current_device()
    if dev not in _SMEM_BYTES:
        _SMEM_BYTES[dev] = lib.mec_smem_bytes()
    return _SMEM_BYTES[dev]


def mec_design(S: int, R: int, O: int) -> tuple[str, int]:
    """`mec_plan` on the current CUDA device."""
    from ..ops import cuda_build
    return mec_plan(S, R, O, mec_smem_bytes(cuda_build.lib("mec")))


def _mec_check(obs_read, obs_snp, obs_allele, h0, n_reads: int,
               n_iter: int) -> str:
    """Raise ValueError unless the observations are contiguous (O,) tensors
    (reads and SNPs int32 or int64, alleles int8) and h0 a contiguous
    (n_restarts, S) int32 tensor, all on one device, with O < 2^31,
    1 <= n_restarts <= MAX_RESTARTS, 0 <= n_reads, S < MAX_NODES and
    n_iter >= 0.  Returns the device type."""
    dev = h0.device if isinstance(h0, torch.Tensor) else None
    specs = (("obs_read", obs_read, (torch.int32, torch.int64), 1),
             ("obs_snp", obs_snp, (torch.int32, torch.int64), 1),
             ("obs_allele", obs_allele, (torch.int8,), 1),
             ("h0", h0, (torch.int32,), 2))
    for label, x, dts, dim in specs:
        if not isinstance(x, torch.Tensor) or x.dtype not in dts or \
                x.dim() != dim or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"_mec_phase: {label} must be a contiguous "
                             f"{dim}-d {' or '.join(map(str, dts))} tensor "
                             f"on {dev}")
    n_obs = obs_read.numel()
    if obs_snp.numel() != n_obs or obs_allele.numel() != n_obs or \
            n_obs >= 2**31 or not 1 <= h0.shape[0] <= MAX_RESTARTS or \
            not 0 <= n_reads < MAX_NODES or h0.shape[1] >= MAX_NODES or \
            n_iter < 0:
        raise ValueError(f"_mec_phase: {n_obs}, {obs_snp.numel()} and "
                         f"{obs_allele.numel()} observations, h0 "
                         f"{tuple(h0.shape)}, n_reads {n_reads}, n_iter "
                         f"{n_iter}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"_mec_phase: unsupported device {dev}")
    return dev.type


def _mec_phase(obs_read: torch.Tensor, obs_snp: torch.Tensor,
               obs_allele: torch.Tensor, h0: torch.Tensor, *, n_reads: int,
               n_iter: int, branch: str = "auto", ctas: int | None = None):
    """(h, a, mec) of the best of the restarts, as `_mec_phase_plain`
    computes them: h (S,) int32, a (n_reads,) int32, mec a 0-d int64.
    obs_read / obs_snp (O,) int32 (or int64), obs_allele (O,) int8, h0
    (n_restarts, S) int32 of ±1 (restart_inits).  The CUDA kernels
    (`csrc/mec.cu`, on the current stream) for CUDA tensors: the
    observations sorted into CSR order on the card, then the votes by
    `branch`: "smem" (a cluster of `ctas` CTAs a restart, 1-16, default
    MEC_CLUSTER_CTAS, the CSR in shared memory; its h, a and row offsets
    must fit, `mec_smem_need`), "grid" (a grid over the rows, any size) or
    "auto" (`mec_design`).  `_mec_phase_plain` for CPU tensors.  Each
    launch appends (O, n_restarts, S, n_reads) to `_mec_phase.shapes`."""
    if branch not in _BRANCHES:
        raise ValueError(f"_mec_phase: branch {branch!r} not in "
                         f"{list(_BRANCHES)}")
    dev = _mec_check(obs_read, obs_snp, obs_allele, h0, n_reads, n_iter)
    if ctas is not None and not 1 <= ctas <= MEC_MAX_CTAS:
        raise ValueError(f"_mec_phase: ctas {ctas} outside 1..{MEC_MAX_CTAS}")
    if dev == "cpu":
        return _mec_phase_plain(obs_read, obs_snp, obs_allele, h0,
                                n_reads=n_reads, n_iter=n_iter)
    from ..ops import cuda_build
    lib = cuda_build.lib("mec")
    n_obs = obs_read.numel()
    n_restarts, S = h0.shape
    x = h0.device
    with torch.cuda.device(x):
        smem = mec_smem_bytes(lib)
        if branch == "auto":
            branch, ctas = mec_plan(S, n_reads, n_obs, smem)
        elif branch == "smem":
            ctas = ctas or MEC_CLUSTER_CTAS
            if mec_smem_need(S, n_reads, n_obs, ctas)[0] > smem:
                raise ValueError(f"_mec_phase: S {S} and R {n_reads} exceed "
                                 f"the smem design's shared memory at "
                                 f"{ctas} CTAs")
        n_bytes = lib.mec_scratch_bytes(n_restarts, S, n_reads, n_obs)
        scratch = torch.empty(n_bytes, dtype=torch.uint8, device=x)
        h = torch.empty(S, dtype=torch.int32, device=x)
        a = torch.empty(n_reads, dtype=torch.int32, device=x)
        mec = torch.empty((), dtype=torch.int64, device=x)
        rc = lib.mec_phase_launch(
            obs_read.data_ptr(), obs_read.dtype == torch.int64,
            obs_snp.data_ptr(), obs_snp.dtype == torch.int64,
            obs_allele.data_ptr(), n_obs, h0.data_ptr(), n_restarts, S,
            n_reads, n_iter, _BRANCHES[branch], ctas or 0,
            scratch.data_ptr(), n_bytes, h.data_ptr(), a.data_ptr(),
            mec.data_ptr(), torch.cuda.current_stream(x).cuda_stream)
    cuda_build.check(rc, "mec_phase launch", "mec")
    _mec_phase.launches += 1
    _mec_phase.shapes.append((n_obs, n_restarts, S, n_reads))
    return h, a, mec


_mec_phase.launches = 0
_mec_phase.shapes = []


def _mec_inputs(obs_read, obs_snp, obs_allele, S: int, n_reads: int,
                cfg: PhasingConfig, seed: int, n_restarts: int, device):
    """chain_init + restarts: `_mec_phase`'s arguments on `device`, as
    (args, kwargs)."""
    h0 = restart_inits(chain_init(obs_read, obs_snp, obs_allele, S), seed,
                       n_restarts)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in (obs_read, obs_snp, obs_allele, h0)]
    return args, dict(n_reads=n_reads, n_iter=cfg.max_phase_iter)


def _mec_solve(obs_read, obs_snp, obs_allele, S: int, n_reads: int,
               cfg: PhasingConfig, seed: int, n_restarts: int, device):
    """`_mec_inputs` + `_mec_phase` on `device`; numpy (h, a, mec)."""
    args, kw = _mec_inputs(obs_read, obs_snp, obs_allele, S, n_reads, cfg,
                           seed, n_restarts, device)
    h, a, mec = _mec_phase(*args, **kw)
    return h.cpu().numpy(), a.cpu().numpy(), int(mec)


@dataclass
class PhaseResult:
    snp_pos: np.ndarray         # (S,) het SNP positions (0-based)
    ref_base: np.ndarray
    alt_base: np.ndarray
    phase: np.ndarray           # (S,) ±1: +1 → hap1 carries REF (GT 0|1)
    block_id: np.ndarray        # (S,) int64 phase-set id = block start pos+1
    read_hap: np.ndarray        # (R,) int8 0=unassigned, 1, 2
    read_block: np.ndarray      # (R,) int64 block id or -1
    read_names: list[str]
    mec: int
    # hom-alt (unphased) sites for the SNP VCF
    hom_pos: np.ndarray
    hom_ref: np.ndarray
    hom_alt: np.ndarray
    # SV-marker columns (pileup.PileupResult.marker): phased like SNPs but
    # excluded from the SNP VCF output
    marker: np.ndarray = None   # (S,) bool over snp_pos

    def blocks(self) -> list[tuple[int, int, int]]:
        """[(block_id, start_pos, end_pos)] (0-based inclusive span)."""
        out = []
        for b in np.unique(self.block_id):
            sel = self.block_id == b
            p = self.snp_pos[sel]
            out.append((int(b), int(p.min()), int(p.max())))
        return out


def phase_chromosome(pile: PileupResult, cfg: PhasingConfig,
                     seed: int = 0, n_restarts: int = 8,
                     device=DEFAULT_DEVICE) -> PhaseResult:
    """Phase the het candidates of one chromosome's pileup; the MEC votes
    run on `device`."""
    device = resolve_device(device)
    het_idx = np.nonzero(pile.is_het)[0]
    hom_sel = ~pile.is_het
    n_reads = len(pile.read_names)
    pile_marker = pile.marker if pile.marker is not None \
        else np.zeros(len(pile.snp_pos), bool)
    if len(het_idx) == 0 or n_reads == 0:
        return PhaseResult(
            np.zeros(0, np.int64), np.zeros(0, np.int8), np.zeros(0, np.int8),
            np.zeros(0, np.int8), np.zeros(0, np.int64),
            np.zeros(n_reads, np.int8), np.full(n_reads, -1, np.int64),
            pile.read_names, 0, pile.snp_pos[hom_sel],
            pile.ref_base[hom_sel], pile.alt_base[hom_sel],
            marker=np.zeros(0, bool))

    # compress obs to het sites
    remap = np.full(len(pile.snp_pos), -1, np.int64)
    remap[het_idx] = np.arange(len(het_idx))
    keep = remap[pile.obs_snp] >= 0
    obs_read = pile.obs_read[keep]
    obs_snp = remap[pile.obs_snp[keep]].astype(np.int32)
    obs_allele = pile.obs_allele[keep]
    S = len(het_idx)

    h, a, mec = _mec_solve(obs_read, obs_snp, obs_allele, S, n_reads, cfg,
                           seed, n_restarts, device)

    # self-healing pass: an SV marker column whose observations fight the
    # SNP-derived solution (alignment-representation lottery — the event
    # surfaces in only some carriers' CIGARs) contributes concentrated MEC
    # at its own site.  Null its obs and re-solve; SNP columns stay.
    site_marker = pile_marker[het_idx]
    if site_marker.any() and len(obs_read):
        cons = a[obs_read] * h[obs_snp] * obs_allele
        informative = obs_allele != 0
        bad = np.bincount(obs_snp[informative & (cons < 0)], minlength=S)
        tot = np.bincount(obs_snp[informative], minlength=S)
        poison = site_marker & (tot >= 4) & (bad > 0.15 * tot)
        if poison.any():
            keep_o = ~poison[obs_snp]
            obs_read2 = obs_read[keep_o]
            obs_snp2 = obs_snp[keep_o]
            obs_allele2 = obs_allele[keep_o]
            if len(obs_read2):
                h, a, mec = _mec_solve(obs_read2, obs_snp2, obs_allele2, S,
                                       n_reads, cfg, seed, n_restarts, device)
                obs_read, obs_snp, obs_allele = (obs_read2, obs_snp2,
                                                 obs_allele2)

    # phase blocks: SNP i and i+1 connected iff some read observes both
    # (per-read [min,max] snp interval overlay)
    link = np.zeros(max(S - 1, 0), bool)
    if S > 1 and len(obs_snp):
        order = np.argsort(obs_read, kind="stable")
        ord_r, ord_s = obs_read[order], obs_snp[order]
        first = np.concatenate([[True], ord_r[1:] != ord_r[:-1]])
        starts = np.nonzero(first)[0]
        ends = np.concatenate([starts[1:], [len(ord_r)]])
        lo = np.minimum.reduceat(ord_s, starts)
        hi = np.maximum.reduceat(ord_s, starts)
        d = np.zeros(S, np.int64)
        has = hi > lo
        np.add.at(d, lo[has], 1)
        np.add.at(d, hi[has], -1)
        link = np.cumsum(d)[:-1] > 0
    # linkage-consistency split (the longshot/HapCUT2 block contract): a
    # junction where the solved phase runs AGAINST the read linkage — or
    # where net consistent linkage is thin — is a potential switch point.
    # One mid-block switch error is invisible to the SNP-level solution
    # (both sides are internally consistent) but flips the haplotype label
    # of every read beyond it, which poisons the per-(block, hap) assembly
    # groups chromosome-wide once blocks span whole chromosomes.  Splitting
    # there makes the two sides independent blocks, where the label flip
    # is absorbed by per-block sign freedom.
    if S > 1 and len(obs_snp):
        score_d = np.zeros(S, np.int64)
        order2 = np.lexsort((obs_snp, obs_read))
        r2 = obs_read[order2]
        s2 = obs_snp[order2]
        o2 = obs_allele[order2].astype(np.int64)
        same = r2[1:] == r2[:-1]
        inf2 = (o2[1:] != 0) & (o2[:-1] != 0) & same
        s_a = np.minimum(s2[:-1], s2[1:])[inf2]
        s_b = np.maximum(s2[:-1], s2[1:])[inf2]
        span = s_b > s_a
        s_a, s_b = s_a[span], s_b[span]
        rel_obs = (o2[1:] * o2[:-1])[inf2][span]
        rel_chosen = (h[s_a] * h[s_b]).astype(np.int64)
        consistent = rel_obs * rel_chosen          # ±1 per bridging pair
        np.add.at(score_d, s_a, consistent)
        np.add.at(score_d, s_b, -consistent)
        junction_score = np.cumsum(score_d)[:-1]
        link &= junction_score >= 2
    block_start = np.concatenate([[True], ~link])
    block_idx = np.cumsum(block_start) - 1
    pos_het = pile.snp_pos[het_idx]
    starts_pos = pos_het[block_start]
    block_id = starts_pos[block_idx] + 1     # PS = 1-based block start pos

    # read → haplotype + block (majority block among its observations).
    # Eligibility: a read whose ONLY evidence is a single NOISY SV-marker
    # column is a coin flip (measured 44% misassigned on the HiFi golden —
    # individually-noisy marker carrier/clean calls); such reads stay
    # unassigned and fall through to the k-mer partition vote.  A single
    # marker obs still counts when the column is CLEAN — its observations
    # near-unanimously agree with the solved phase (the het-SV-in-SNP-
    # desert case, where the marker is the only possible signal).
    read_hap = np.zeros(n_reads, np.int8)
    read_block = np.full(n_reads, -1, np.int64)
    if len(obs_read):
        informative = obs_allele != 0
        at_marker = site_marker[obs_snp]
        nm_count = np.bincount(obs_read[informative & ~at_marker],
                               minlength=n_reads)
        mk_count = np.bincount(obs_read[informative & at_marker],
                               minlength=n_reads)
        # NOTE a single-clean-marker exception (with or without a span-
        # based desert test) was tried and reverted: it costs ~3 het SVs
        # on the HiFi golden.  longshot itself phases nothing without an
        # SNV — in the reference, SNV-free reads are assigned by the
        # k-mer partition vote, and that is exactly where single-marker
        # reads fall through to (partition.partition_reads).
        eligible = (nm_count >= 1) | (mk_count >= 2)
        sel = informative & eligible[obs_read]
        r = obs_read[sel]
        b = block_id[obs_snp[sel]]
        # a read's block: the block of its first observation (reads rarely
        # span blocks — blocks break where no read spans)
        order = np.argsort(r, kind="stable")
        r_o, b_o = r[order], b[order]
        first = np.concatenate([[True], r_o[1:] != r_o[:-1]])
        read_block[r_o[first]] = b_o[first]
        covered = np.unique(r)
        read_hap[covered] = np.where(a[covered] > 0, 1, 2).astype(np.int8)

    return PhaseResult(
        snp_pos=pos_het, ref_base=pile.ref_base[het_idx],
        alt_base=pile.alt_base[het_idx], phase=h.astype(np.int8),
        block_id=block_id, read_hap=read_hap, read_block=read_block,
        read_names=pile.read_names, mec=int(mec),
        hom_pos=pile.snp_pos[hom_sel], hom_ref=pile.ref_base[hom_sel],
        hom_alt=pile.alt_base[hom_sel], marker=pile_marker[het_idx])
