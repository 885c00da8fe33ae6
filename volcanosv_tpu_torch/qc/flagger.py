"""Assembly QC: coverage-mixture HMM classifying contig regions.

Replaces the reference's Flagger subsystem (SURVEY.md §2.2):
`Evaluate_Assembly.py` + `preprocess_flagger.sh` (map reads→contigs, compute
coverage) + the cromwell-run `hmm_flagger.c` coverage HMM (flagger-0.3.3),
whose states classify each window as **err** (~0× coverage), **dup**
(assembly duplication, ~0.5×), **hap** (correct haploid, ~1×), or
**collapsed** (two haplotypes collapsed onto one contig, ~2×).  Collapsed
components drive SD re-assembly (`General_Assembly_Workflow_SD.py` →
`Replace_Collapsed_Contigs.py`).

The Viterbi and forward-backward recursions run as torch ops on the
caller's device: a loop over the T windows carrying the (B, S) state of a
padded batch of B contigs, so one pass makes a few launches a window
whatever the number of contigs.  They compute in float32, as the JAX
package does (its x64 mode is off), with the same add order, so that the
state labels are the same; the posteriors' logsumexp is another
implementation's and agrees within a tolerance.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import QCConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..io.bam import BamRecord
from ..utils.logging import get_logger

log = get_logger("qc")

STATE_NAMES = ("err", "dup", "hap", "collapsed")
# state coverage means as multiples of the haploid coverage λ
STATE_MULT = np.array([0.05, 0.5, 1.0, 2.0])
STAY = 0.95                 # sticky transitions (hmm_flagger-style prior)


def state_mults(n_states: int) -> np.ndarray:
    """Multiplier ladder per QCConfig.n_states: 3 = err/hap/collapsed,
    4 = + dup (the hmm_flagger default), 5 = + a high-copy state."""
    table = {3: [0.05, 1.0, 2.0],
             4: [0.05, 0.5, 1.0, 2.0],
             5: [0.05, 0.5, 1.0, 2.0, 4.0]}
    return np.array(table[n_states])


def state_names(n_states: int) -> tuple[str, ...]:
    return {3: ("err", "hap", "collapsed"),
            4: STATE_NAMES,
            5: STATE_NAMES + ("high",)}[n_states]


def contig_coverage_windows(records: list[BamRecord],
                            contig_lengths: dict[str, int],
                            contig_names: list[str],
                            window: int = 1_000) -> dict[str, np.ndarray]:
    """Per-window mean read-depth for each contig from reads→contig
    alignments (preprocess_flagger.sh equivalent)."""
    diffs = {c: np.zeros(contig_lengths[c] + 1, np.int64)
             for c in contig_lengths}
    for r in records:
        if r.is_unmapped or r.is_secondary or r.ref_id < 0:
            continue
        name = contig_names[r.ref_id]
        d = diffs.get(name)
        if d is None:
            continue
        d[min(r.pos, len(d) - 1)] += 1
        d[min(r.reference_end, len(d) - 1)] -= 1
    out = {}
    for c, d in diffs.items():
        cov = np.cumsum(d[:-1])
        L = contig_lengths[c]
        n_win = max(1, (L + window - 1) // window)
        pad = n_win * window - L
        covp = np.concatenate([cov, np.zeros(pad)]) if pad else cov
        means = covp.reshape(n_win, window).mean(axis=1)
        if pad and n_win > 1:           # last partial window: true mean
            means[-1] = cov[(n_win - 1) * window:].mean()
        out[c] = means
    return out


def _log_poisson(cov: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """log P(cov | Poisson(lam)) up to the shared lgamma term (cancels in
    posteriors/Viterbi argmax).  cov (..., 1), lam (S,) → (..., S), float32.
    log(lam) is taken in float64 and rounded, so that it is the same on
    every device (float32 logs of the CPU and the card differ in the last
    bit); the product and the difference are each rounded on their own."""
    lam = torch.clamp(lam, min=1e-3)
    return cov * torch.log(lam.double()).float() - lam


@dataclass
class CoverageHMM:
    """Sticky coverage HMM with (over)dispersed Poisson emissions.

    means: per-state emission means (fitted by fit_coverage_hmm, or fixed
    multiples of a λ estimate).  tau: dispersion index — emissions are
    tempered by 1/tau, the quasi-Poisson widening hmm_flagger fits for
    real coverage tracks (GC waves, mapping bias make var > mean)."""
    means: np.ndarray
    stay: float = STAY
    tau: float = 1.0

    @staticmethod
    def from_lambda(lam: float, n_states: int = 4,
                    stay: float = STAY) -> "CoverageHMM":
        return CoverageHMM(means=state_mults(n_states) * lam, stay=stay)

    @property
    def lam(self) -> float:
        """Haploid coverage = the mean of the 1.0-multiplier state."""
        mults = state_mults(len(self.means))
        return float(self.means[int(np.argmin(np.abs(mults - 1.0)))])

    def _emissions(self, cov: np.ndarray, valid: np.ndarray, device):
        """float32 tensors on `device`: emissions (T, B, S) with padded
        windows at 0, log transitions (S, S), log initial (S,)."""
        S = len(self.means)
        f32 = torch.float32
        means = torch.as_tensor(np.asarray(self.means), dtype=f32,
                                device=device)
        trans = torch.where(
            torch.eye(S, dtype=torch.bool, device=device),
            torch.tensor(self.stay, dtype=f32, device=device),
            torch.tensor((1 - self.stay) / (S - 1), dtype=f32,
                         device=device))
        # float32 probabilities, their logs rounded from float64 (as in
        # _log_poisson: the same bits on every device)
        logA = torch.log(trans.double()).float()
        logpi = torch.log(torch.full((S,), 1.0 / S, dtype=f32,
                                     device=device).double()).float()
        c = torch.as_tensor(np.asarray(cov), dtype=f32, device=device)
        v = torch.as_tensor(np.asarray(valid, bool), device=device)
        emit = _log_poisson(c[..., None], means) / \
            torch.tensor(self.tau, dtype=f32, device=device)
        emit = torch.where(v[..., None], emit, torch.zeros((), dtype=f32,
                                                           device=device))
        return emit.transpose(0, 1).contiguous(), logA, logpi

    def viterbi(self, cov: np.ndarray, valid: np.ndarray,
                device=DEFAULT_DEVICE) -> np.ndarray:
        """cov (B, T) window coverages (padded), valid (B, T) mask.
        Returns (B, T) int8 state labels.  The backpointers stay on
        `device` and are walked back there."""
        device = resolve_device(device)
        emit, logA, logpi = self._emissions(cov, valid, device)
        T, B, S = emit.shape
        ptrs = torch.empty((T - 1, B, S), dtype=torch.int64, device=device)
        delta = logpi + emit[0]
        for t in range(1, T):
            # (delta + logA) + e: the reference's add order
            scores = (delta[:, :, None] + logA) + emit[t][:, None, :]
            delta, ptrs[t - 1] = torch.max(scores, dim=1)
        states = torch.empty((T, B), dtype=torch.int64, device=device)
        states[T - 1] = torch.argmax(delta, dim=1)
        for t in range(T - 2, -1, -1):
            states[t] = ptrs[t].gather(1, states[t + 1][:, None])[:, 0]
        return states.T.to(torch.int8).cpu().numpy()

    def posteriors(self, cov: np.ndarray, valid: np.ndarray,
                   device=DEFAULT_DEVICE) -> np.ndarray:
        """Forward-backward state posteriors (B, T, S), float32."""
        device = resolve_device(device)
        emit, logA, logpi = self._emissions(cov, valid, device)
        T, B, S = emit.shape
        alphas = torch.empty((T, B, S), dtype=torch.float32, device=device)
        alphas[0] = logpi + emit[0]
        for t in range(1, T):
            alphas[t] = torch.logsumexp(alphas[t - 1][:, :, None] + logA,
                                        dim=1) + emit[t]
        betas = torch.empty_like(alphas)
        betas[T - 1] = 0.0
        for t in range(T - 2, -1, -1):
            betas[t] = torch.logsumexp(
                logA + (emit[t + 1] + betas[t + 1])[:, None, :], dim=2)
        post = torch.softmax(alphas + betas, dim=-1)
        return post.transpose(0, 1).cpu().numpy()


def _log_sum_exp(x: np.ndarray, axis: int) -> np.ndarray:
    m = x.max(axis=axis, keepdims=True)
    return (m + np.log(np.exp(x - m).sum(axis=axis, keepdims=True))
            ).squeeze(axis)


def posteriors_float64(hmm, cov: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """CoverageHMM.posteriors' forward-backward in float64 on the host: the
    yardstick of the float32 posteriors' rounding.  `hmm` needs only
    means, stay and tau.  Returns (B, T, S) float64."""
    S = len(hmm.means)
    lam = np.maximum(np.asarray(hmm.means, np.float64), 1e-3)
    emit = (np.asarray(cov, np.float64)[..., None] * np.log(lam) - lam) \
        / hmm.tau
    emit = np.where(np.asarray(valid, bool)[..., None], emit, 0.0)
    logA = np.log(np.where(np.eye(S, dtype=bool), hmm.stay,
                           (1 - hmm.stay) / (S - 1)))
    B, T = emit.shape[:2]
    alpha = np.zeros((B, T, S))
    beta = np.zeros((B, T, S))
    alpha[:, 0] = np.log(1.0 / S) + emit[:, 0]
    for t in range(1, T):
        alpha[:, t] = _log_sum_exp(alpha[:, t - 1, :, None] + logA, 1) \
            + emit[:, t]
    for t in range(T - 2, -1, -1):
        beta[:, t] = _log_sum_exp(
            logA + (emit[:, t + 1] + beta[:, t + 1])[:, None, :], 2)
    lp = alpha + beta
    p = np.exp(lp - lp.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


@dataclass
class FlaggerResult:
    states: dict[str, np.ndarray]          # contig → (n_windows,) int8
    collapsed: list[str]                   # contigs with a collapsed block
    lam: float
    window: int

    def blocks(self, contig: str, state: int) -> list[tuple[int, int]]:
        """[(start, end)] bp spans of `state` runs in one contig."""
        s = self.states[contig]
        out = []
        run = None
        for i, v in enumerate(s):
            if v == state and run is None:
                run = i
            elif v != state and run is not None:
                out.append((run * self.window, i * self.window))
                run = None
        if run is not None:
            out.append((run * self.window, len(s) * self.window))
        return out


def estimate_haploid_coverage(cov_all: np.ndarray) -> float:
    """λ from the coverage histogram mode over non-empty windows."""
    nz = cov_all[cov_all > 0.5]
    if len(nz) == 0:
        return 1.0
    return float(np.median(nz))


def fit_coverage_hmm(cov: np.ndarray, valid: np.ndarray,
                     cfg: QCConfig, device=DEFAULT_DEVICE) -> CoverageHMM:
    """EM-fit the coverage mixture HMM (the hmm_flagger.c role: iterative
    component mean/dispersion fitting, not fixed multiples of a median).

    Per iteration (Baum-Welch E-step on `device`, M-step on host):
      * tied-λ ML update   λ = Σ_ts γ·c / Σ_ts γ·m_s  (Poisson means tied
        to the multiplier ladder — robust to λ mis-estimates)
      * free per-state mean refinement, clamped to ±40% of the tied
        skeleton and monotone (keeps state identities from swapping)
      * dispersion index   τ = Σ w·(c-μ)²/μ / Σ w  (quasi-Poisson
        overdispersion: GC waves / mapping bias make var > mean; τ widens
        every state so smooth coverage undulation stops flagging)
    Stops at max_iter or λ convergence (<0.5%)."""
    device = resolve_device(device)
    mults = state_mults(cfg.n_states)
    lam = estimate_haploid_coverage(cov[valid])
    hmm = CoverageHMM(means=mults * lam)
    for _ in range(max(cfg.max_iter, 0)):
        gamma = hmm.posteriors(cov, valid, device)            # (B,T,S)
        w = gamma * valid[..., None]
        num = (w * cov[..., None]).sum(axis=(0, 1))           # Σ γ·c
        den = w.sum(axis=(0, 1))                              # Σ γ
        lam_new = float(num.sum() / max(float((den * mults).sum()), 1e-9))
        tied = np.maximum(mults * lam_new, 1e-2)
        free = num / np.maximum(den, 1e-9)
        means = np.clip(free, 0.6 * tied, 1.4 * tied)
        means = np.maximum.accumulate(np.maximum(means, 1e-2))
        disp = ((cov[..., None] - means) ** 2 / np.maximum(means, 1e-2))
        tau = float((w * disp).sum() / max(float(w.sum()), 1e-9))
        tau = float(np.clip(tau, 1.0, 10.0))
        converged = abs(lam_new - hmm.lam) <= 0.005 * max(hmm.lam, 1e-9)
        hmm = CoverageHMM(means=means, stay=hmm.stay, tau=tau)
        if converged:
            break
    return hmm


def coverage_batch(covs: dict[str, np.ndarray]
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Per-contig window coverages → the padded (B, T) float64 batch and
    its valid mask, contigs in dict order."""
    T = max((len(v) for v in covs.values()), default=1)
    cov = np.zeros((len(covs), T))
    valid = np.zeros((len(covs), T), bool)
    for i, v in enumerate(covs.values()):
        cov[i, :len(v)] = v
        valid[i, :len(v)] = True
    return cov, valid


def evaluate_assembly(contigs: dict[str, str],
                      read_records: list[BamRecord],
                      contig_names: list[str],
                      cfg: QCConfig,
                      min_collapsed_windows: int = 2,
                      device=DEFAULT_DEVICE) -> FlaggerResult:
    """Classify every contig window; flag contigs containing collapsed
    blocks (Evaluate_Assembly.py:55-69 'Col' component grep equivalent).
    The HMM runs on `device`.

    read_records: reads aligned TO THE CONTIGS (ref_id indexes
    contig_names)."""
    device = resolve_device(device)
    lens = {c: len(s) for c, s in contigs.items()}
    covs = contig_coverage_windows(read_records, lens, contig_names,
                                   cfg.window)
    names = list(covs)
    cov, valid = coverage_batch(covs)
    if cfg.max_iter > 0:
        hmm = fit_coverage_hmm(cov, valid, cfg, device)
    else:                               # fixed multiples of the λ median
        hmm = CoverageHMM.from_lambda(
            estimate_haploid_coverage(cov[valid]), cfg.n_states)
    states = hmm.viterbi(cov, valid, device)
    collapsed_state = int(np.argmin(
        np.abs(state_mults(cfg.n_states) - 2.0)))
    result: dict[str, np.ndarray] = {}
    collapsed = []
    for i, c in enumerate(names):
        s = states[i, :len(covs[c])]
        result[c] = s
        if int((s == collapsed_state).sum()) >= min_collapsed_windows:
            collapsed.append(c)
    log.info("flagger: λ=%.1f τ=%.2f, %d/%d contigs with collapsed blocks",
             hmm.lam, hmm.tau, len(collapsed), len(names))
    return FlaggerResult(states=result, collapsed=collapsed, lam=hmm.lam,
                         window=cfg.window)
