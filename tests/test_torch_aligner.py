"""The port's Aligner (volcanosv_tpu_torch.aligner, DP on the plain torch
path) against volcanosv_tpu.aligner.Aligner on one small simulated case:
identical Alignment lists — inversion-rescue output included — and
identical BAM records, for contigs (asm5, and dual-affine asm20) and HiFi
reads (map-hifi)."""
import dataclasses

import numpy as np
import pytest

from torch_inputs import ensure_reference_native_lib
from volcanosv_tpu import sim
from volcanosv_tpu.aligner import Aligner as RefAligner
from volcanosv_tpu.config import AlignConfig as RefAlignConfig
from volcanosv_tpu_torch.aligner import Aligner
from volcanosv_tpu_torch.config import from_reference_dict


@pytest.fixture(scope="module", autouse=True)
def _reference_native_lib():
    """The JAX package's native library loaded whole before its first use
    (torch_inputs.ensure_reference_native_lib)."""
    ensure_reference_native_lib()


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    ref = sim.random_genome(rng, 60_000)
    hap1, hap2, _truth = sim.implant_svs(
        rng, ref, n_del=3, n_ins=3, n_inv=1, min_len=50, max_len=400,
        min_gap=3_000)
    contigs = sim.contigs_from_haplotypes(hap1, hap2, block_size=40_000,
                                          overlap=5_000)
    reads = sim.simulate_reads(rng, {1: hap1, 2: hap2}, coverage=8.0,
                               read_len=6_000, read_len_sd=1_000)
    return ref, contigs, {n: s for n, s, *_ in reads}


def _records(recs):
    return [(r.name, r.flag, r.ref_id, r.pos, r.mapq, r.cigar.tolist(),
             r.seq, r.tags) for r in recs]


@pytest.mark.parametrize("preset,which", [("asm5", "contigs"),
                                          ("asm20", "contigs"),
                                          ("map-hifi", "reads")])
def test_aligner_matches_reference(case, preset, which):
    ref, contigs, reads = case
    seqs = contigs if which == "contigs" else reads
    rcfg = RefAlignConfig.preset(preset)
    want_aligner = RefAligner(ref, rcfg)
    want = want_aligner.align(list(seqs.items()))
    aligner = Aligner(ref, from_reference_dict(dataclasses.asdict(rcfg)),
                      device="cpu")
    got = aligner.align(list(seqs.items()))
    assert [dataclasses.asdict(a) for a in got] == \
        [dataclasses.asdict(a) for a in want]
    assert _records(aligner.to_bam_records(got, seqs)) == \
        _records(want_aligner.to_bam_records(want, seqs))


def test_inversion_rescue_output_matches(case):
    """The inversion in the sim is rescued (the rescue adds inverted
    supplementary alignments), identically in both packages."""
    ref, contigs, _reads = case
    rcfg = RefAlignConfig.preset("asm5")
    cfg = from_reference_dict(dataclasses.asdict(rcfg))
    aligner = Aligner(ref, cfg, device="cpu")
    full = aligner.align(list(contigs.items()))
    plain = Aligner(ref, dataclasses.replace(cfg, inv_rescue=False),
                    device="cpu").align(
        list(contigs.items()))
    rescued = full[len(plain):]
    assert rescued and all(a.is_supplementary for a in rescued)
    want = RefAligner(ref, rcfg)._inv_rescue(
        plain, dict(contigs.items()))
    assert [dataclasses.asdict(a) for a in rescued] == \
        [dataclasses.asdict(a) for a in want]
