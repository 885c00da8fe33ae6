"""Host-side pieces of the port against the JAX package: configs carried
across with from_reference_dict, the simulator (byte-identical from one
seed), the file formats, the native C++ helpers, the import isolation of
the port package, and `--device cuda` (the default of every entry point)
refusing a host without CUDA."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_inputs import ensure_reference_native_lib
import volcanosv_tpu.native as ref_native
import volcanosv_tpu_torch.native as port_native
from volcanosv_tpu import config as ref_config
from volcanosv_tpu import io as ref_io
from volcanosv_tpu import sim as ref_sim
from volcanosv_tpu.io.bam import scan_bam as ref_scan_bam
from volcanosv_tpu_torch import config, io, sim
from volcanosv_tpu_torch.io.bam import cigar_from_string, scan_bam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ["asm5", "asm10", "asm20", "map-hifi", "map-pb", "map-ont"]


@pytest.mark.parametrize("preset", PRESETS)
def test_align_presets_carry_across(preset):
    d = dataclasses.asdict(ref_config.AlignConfig.preset(preset))
    got = config.from_reference_dict(d)
    assert got == config.AlignConfig.preset(preset)
    assert dataclasses.asdict(got) == d


@pytest.mark.parametrize("dtype,asm", [("Hifi", "volcano"), ("CLR", "volcano"),
                                       ("ONT", "volcano"), ("Hifi", "other")])
def test_pipeline_configs_carry_across(dtype, asm):
    d = dataclasses.asdict(ref_config.PipelineConfig.for_dtype(dtype, asm))
    got = config.from_reference_dict(d)
    assert got == config.PipelineConfig.for_dtype(dtype, asm)
    assert dataclasses.asdict(got) == d


def test_sim_byte_identical_from_one_seed():
    out = []
    for m in (ref_sim, sim):
        rng = np.random.default_rng(3)
        ref = m.random_genome(rng, 30_000, n_chroms=2)
        ref, feats = m.implant_repeats(rng, ref, n_tandem=1, n_segdup=1,
                                       n_homopoly=1)
        hap1, hap2, truth = m.implant_svs(
            rng, ref, n_del=2, n_ins=2, n_inv=1, n_dup=1, n_clustered=1,
            n_nested=1, n_small=2, min_gap=1_000)
        hap1, hap2, snps = m.implant_snps_ref(rng, ref, hap1, hap2, truth,
                                              rate=1 / 500)
        truth += m.implant_tra(rng, ref, hap1, hap2, truth)
        reads = m.simulate_reads(rng, {1: hap1, 2: hap2}, coverage=4.0,
                                 read_len=3_000)
        contigs = m.contigs_from_haplotypes(hap1, hap2, block_size=12_000,
                                            overlap=2_000)
        out.append((ref, feats, hap1, hap2,
                    [dataclasses.astuple(t) for t in truth],
                    [dataclasses.astuple(s) for s in snps], reads, contigs))
    assert out[0] == out[1]


def _vcf_records(m):
    return [
        m.io.VcfRecord("chr1", 100, "DEL1", "A" * 50, "A",
                       info={"SVTYPE": "DEL", "SVLEN": -49, "END": 149},
                       gt="0/1", ps=7),
        m.io.VcfRecord("chr1", 50, "INS1", "T", "T" + "G" * 40,
                       info={"SVTYPE": "INS", "SVLEN": 40}, gt="1/1"),
    ]


def _bam_records(cigar_fn, rec_cls):
    rng = np.random.default_rng(0)
    recs = []
    for i in range(60):
        L = int(rng.integers(50, 300))
        recs.append(rec_cls(
            name=f"read{i}", flag=(0 if i % 7 else 0x100) | (16 * (i % 2)),
            ref_id=i % 2, pos=int(rng.integers(0, 4000)),
            mapq=int(rng.integers(0, 61)),
            cigar=cigar_fn(f"5S{L - 10}M5S"),
            seq="".join("ACGTN"[j] for j in rng.integers(0, 5, L)),
            qual=np.full(L, 30, np.uint8) if i % 3 else None,
            tags={"HP": 1 + i % 2, "PS": 77, "SA": "chr1,5,+,10M,60,2;"}))
    return recs


def test_io_writes_the_same_bytes(tmp_path):
    """Every writer of the port emits the reference writer's bytes, and
    each package reads the other's files back identically."""
    import volcanosv_tpu
    import volcanosv_tpu_torch
    from volcanosv_tpu.io.bam import cigar_from_string as ref_cigar
    seqs = {"chr1": "ACGT" * 50, "chr2": "GGCCTTAA" * 13}
    fq = [("r1", "ACGT", "IIII"), ("r2", "GGAA", None)]
    blob = bytes(np.random.default_rng(1).integers(0, 256, 100_000,
                                                   dtype=np.uint8))
    files = {}
    for tag, m, cig in (("ref", volcanosv_tpu, ref_cigar),
                        ("port", volcanosv_tpu_torch, cigar_from_string)):
        d = tmp_path / tag
        d.mkdir()
        m.io.write_fasta(str(d / "x.fa"), seqs, width=23)
        m.io.write_fastq(str(d / "x.fq"), fq)
        with m.io.BgzfWriter(str(d / "x.bgzf")) as w:
            for i in range(0, len(blob), 7777):
                w.write(blob[i:i + 7777])
        m.io.write_vcf(str(d / "x.vcf"),
                       m.io.vcf.make_header({"chr1": 1000}), _vcf_records(m))
        with m.io.BamWriter(str(d / "x.bam"), ["chr1", "chr2"],
                            [10_000, 5_000]) as w:
            for r in _bam_records(cig, m.io.BamRecord):
                w.write(r)
        with open(d / "x.bed", "w") as fh:
            fh.write("chr1\t10\t500\nchr2\t0\t90\n")
        files[tag] = d
    for name in ("x.fa", "x.fq", "x.bgzf", "x.vcf", "x.bam"):
        assert (files["port"] / name).read_bytes() == \
            (files["ref"] / name).read_bytes(), name
    p = files["ref"]
    assert io.read_fasta(str(p / "x.fa")) == ref_io.read_fasta(str(p / "x.fa"))
    assert list(io.read_fastq(str(p / "x.fq"))) == \
        list(ref_io.read_fastq(str(p / "x.fq")))
    with io.BgzfReader(str(p / "x.bgzf")) as r:
        assert r.read_all() == blob
    assert io.read_bed(str(p / "x.bed")) == ref_io.read_bed(str(p / "x.bed"))
    h1, v1 = io.read_vcf(str(p / "x.vcf"))
    h2, v2 = ref_io.read_vcf(str(p / "x.vcf"))
    assert h1 == h2 and [vars(a) for a in v1] == [vars(b) for b in v2]
    with io.BamReader(str(p / "x.bam")) as a, \
            ref_io.BamReader(str(p / "x.bam")) as b:
        ra, rb = list(a), list(b)
        assert a.references == b.references and a.lengths == b.lengths
    assert len(ra) == len(rb) == 60
    for x, y in zip(ra, rb):
        assert (x.name, x.flag, x.ref_id, x.pos, x.mapq, x.seq, x.tags,
                x.cigar.tolist()) == (y.name, y.flag, y.ref_id, y.pos,
                                      y.mapq, y.seq, y.tags, y.cigar.tolist())


def test_native_sources_are_copies():
    for src in ("chain.cpp", "bamscan.cpp", "sketch.cpp", "seedchain.cpp",
                "ava.cpp", "soup.cpp"):
        with open(os.path.join(os.path.dirname(port_native.__file__),
                               src), "rb") as a, \
                open(os.path.join(os.path.dirname(ref_native.__file__),
                                  src), "rb") as b:
            assert a.read() == b.read(), src


def test_native_helpers_match_reference(tmp_path):
    """The port's build of the helpers gives the reference build's outputs:
    sketches, fused seed+chain, all-vs-all overlaps and the BAM scan."""
    from volcanosv_tpu.io.bam import BamRecord as RefRec
    from volcanosv_tpu.io.bam import BamWriter as RefWriter
    from volcanosv_tpu.io.bam import cigar_from_string as ref_cigar
    from volcanosv_tpu.ops.chain import seed_chain_batch as ref_scb
    from volcanosv_tpu.ops.minimizer import MinimizerIndex as RefIndex
    from volcanosv_tpu.ops.minimizer import sketch_np as ref_sketch
    from volcanosv_tpu_torch.ops.chain import seed_chain_batch
    from volcanosv_tpu_torch.ops.minimizer import MinimizerIndex, sketch_np
    from volcanosv_tpu_torch.ops.pack import encode_seq
    lib, rlib = port_native.get_lib(), ensure_reference_native_lib()
    assert os.path.dirname(port_native._lib_path()).startswith(
        os.path.join(REPO, "build"))
    rng = np.random.default_rng(4)
    ref = sim.random_genome(rng, 40_000)
    hap1, hap2, _ = sim.implant_svs(rng, ref, n_del=2, n_ins=2, n_inv=1)
    reads = [s for _n, s, *_ in sim.simulate_reads(
        rng, {1: hap1, 2: hap2}, coverage=4.0, read_len=4_000)]
    codes = [encode_seq(s) for s in reads]
    for c in codes[:5]:
        for a, b in zip(sketch_np(c, 19, 10), ref_sketch(c, 19, 10)):
            np.testing.assert_array_equal(a, b)
    acfg = config.AlignConfig.preset("map-hifi")
    racfg = ref_config.AlignConfig.preset("map-hifi")
    got = seed_chain_batch(codes, MinimizerIndex.build(ref, 19, 19), acfg, 16,
                           select=(100, 0.5))
    want = ref_scb(codes, RefIndex.build(ref, 19, 19), racfg, 16,
                   select=(100, 0.5))

    def key(chains):
        return [[(c.strand, c.score, c.anchors_q.tolist(),
                  c.anchors_t.tolist()) for c in cs] for cs in chains]

    assert key(got) == key(want) and sum(map(len, got)) > 0
    ava = config.AlignConfig.preset("ava")
    for a, b in zip(port_native.ava_overlaps_np(lib, codes, ava),
                    ref_native.ava_overlaps_np(rlib, codes, ava)):
        np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "t.bam")
    with RefWriter(path, ["chr1", "chr2"], [10_000, 5_000]) as w:
        for r in _bam_records(ref_cigar, RefRec):
            w.write(r)
    sa, sb = scan_bam(path), ref_scan_bam(path)
    assert len(sa) == len(sb) == 60 and sa.read_seqs() == sb.read_seqs()
    for i in range(len(sa)):
        assert (sa.name(i), sa.seq(i), sa.cigar(i).tolist()) == \
            (sb.name(i), sb.seq(i), sb.cigar(i).tolist())
    np.testing.assert_array_equal(sa.pos, sb.pos)
    np.testing.assert_array_equal(sa.flag, sb.flag)


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """The port's native module with no library loaded and an empty build
    root: the next get_lib() builds."""
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "BUILD_ROOT", str(tmp_path / "build"))
    return tmp_path


def test_native_build_without_compiler_raises(fresh_native, monkeypatch):
    """A missing compiler raises, at every call: no numpy fallback."""
    monkeypatch.setattr(port_native, "CXX",
                        str(fresh_native / "no-such-g++"))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="no-such-g\\+\\+.*not found"):
            port_native.get_lib()
    assert port_native._lib is None
    assert not os.path.exists(port_native._lib_path())


def test_native_build_failure_quotes_compiler(fresh_native, monkeypatch):
    """A compiler that fails: its exit code and stderr are in the error."""
    cxx = fresh_native / "failing-cxx"
    cxx.write_text("#!/bin/sh\necho 'soup.cpp:1: error: boom' >&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(port_native, "CXX", str(cxx))
    with pytest.raises(RuntimeError, match="(?s)exited 3.*error: boom"):
        port_native.get_lib()
    assert not os.path.exists(port_native._lib_path())


def test_port_modules_import_no_jax():
    """Importing every module of the port leaves jax and volcanosv_tpu out
    of sys.modules."""
    code = (
        "import pkgutil, sys, importlib, volcanosv_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'volcanosv_tpu_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'volcanosv_tpu' or m.startswith('volcanosv_tpu.')]\n"
        "assert len(mods) > 25, mods\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _kernel_wrapper_calls():
    """The pair-HMM, coverage-HMM, MEC and canonical-hash kernel wrappers on
    small CPU inputs."""
    import torch

    from volcanosv_tpu_torch.ops import kmer
    from volcanosv_tpu_torch.phasing import phase, realign
    from volcanosv_tpu_torch.qc import flagger
    p = realign.PairHmmParams(0.1)
    segs = torch.zeros((3, 9), dtype=torch.int8)
    haps = torch.zeros((3, 5), dtype=torch.int8)
    lens = torch.tensor([0, 4, 9], dtype=torch.int32)
    cov = np.array([[10.0, 12.0, 0.0], [20.0, 0.0, 0.0]])
    emit = flagger.CoverageHMM.from_lambda(10.0)._emissions(
        cov, cov > 0, torch.device("cpu"))
    obs = [torch.tensor(x, dtype=dt) for x, dt in (
        ([0, 1, 1, 2], torch.int32), ([0, 0, 1, 1], torch.int32),
        ([1, -1, 1, 0], torch.int8))]
    h0 = torch.tensor([[1, 1], [1, -1], [-1, 1]], dtype=torch.int32)
    return {
        "pairhmm_viterbi": (lambda: realign._viterbi_batch(
            segs, lens, haps, W=5, **vars(p)), (3,)),
        "coverage_viterbi": (lambda: flagger.coverage_viterbi(*emit),
                             (2, 3)),
        "coverage_posteriors": (lambda: flagger.coverage_posteriors(*emit),
                                (3, 2, 4)),
        "mec_phase": (lambda: phase._mec_phase(*obs, h0, n_reads=4,
                                               n_iter=2)[1], (4,)),
        "canonical_hashes": (lambda: kmer.canonical_hashes(
            torch.arange(-6, 6, dtype=torch.int32).reshape(3, 4), 16),
            (3, 4)),
    }


@pytest.mark.parametrize("kernel", ["pairhmm_viterbi", "coverage_viterbi",
                                    "coverage_posteriors", "mec_phase",
                                    "canonical_hashes"])
def test_cpu_calls_never_load_kernels(monkeypatch, kernel):
    """A wrapper given CPU tensors runs its plain version: it neither
    builds nor loads a CUDA library."""
    from volcanosv_tpu_torch.ops import cuda_build

    def refuse(*_a):
        raise AssertionError("a CPU call reached cuda_build")
    monkeypatch.setattr(cuda_build, "load_all", refuse)
    monkeypatch.setattr(cuda_build, "lib", refuse)
    call, shape = _kernel_wrapper_calls()[kernel]
    assert tuple(call().shape) == shape


def test_kernel_sources_define_bound_symbols():
    """Every library in cuda_build.SOURCES has its csrc/<name>.cu, and that
    file exports (extern "C") each symbol `_configure` binds, its
    <name>_error_string among them."""
    import re

    from volcanosv_tpu_torch.ops import cuda_build

    class Recorder:
        def __init__(self):
            self.names = set()

        def __getattr__(self, attr):
            self.names.add(attr)
            fn = type("Symbol", (), {})()
            self.__dict__[attr] = fn
            return fn
    bound = set()
    for name in cuda_build.SOURCES:
        path = os.path.join(cuda_build.CSRC, f"{name}.cu")
        assert os.path.exists(path), path
        with open(path) as fh:
            src = fh.read()
        rec = Recorder()
        cuda_build._configure(name, rec)
        assert f"{name}_error_string" in rec.names
        for sym in rec.names:
            assert re.search(r'extern "C"[^;{(]*\b' + sym + r"\s*\(", src), \
                (name, sym)
        bound |= rec.names
    # every kernel wrapper's launch entry point is among them
    assert {"banded_dp_launch", "tb_walk_launch_branch",
            "pairhmm_viterbi_launch", "coverage_viterbi_launch",
            "coverage_posteriors_launch", "kmer_count_launch",
            "unique_mask_launch", "kmer_vote_launch",
            "canonical_hashes_launch", "mec_phase_launch"} <= bound


def _dp_batch():
    q = np.zeros((64, 32), np.int8)
    return q, np.zeros((64, 96), np.int8), np.ones(64, np.int32), \
        np.ones(64, np.int32)


def _entry_point_calls(tmp_path):
    """Public entry point → a call of it on small valid inputs that leaves
    `device` at its default."""
    from volcanosv_tpu_torch import aligner, eval as port_eval
    from volcanosv_tpu_torch.assembly import farm, olc
    from volcanosv_tpu_torch.ops import banded_align as ba
    from volcanosv_tpu_torch.partition import partition
    from volcanosv_tpu_torch.phasing import phase, pileup, realign
    from volcanosv_tpu_torch.parallel import (build_sharded_align_step,
                                              make_mesh, multihost)
    from volcanosv_tpu_torch.pipeline import asm, sd
    from volcanosv_tpu_torch.qc import flagger
    from volcanosv_tpu_torch.vc import complex_sv, large_indel, redundancy
    pcfg = config.PipelineConfig.for_dtype("Hifi")
    pairs = [("ACGTACGT", "ACGTTCGT")]
    one = np.ones(1, np.int64)
    codes = np.zeros(40, np.int8)
    win = np.zeros((1, 3), np.int8)
    polish = config.AlignConfig.preset("polish")
    cov = np.full((1, 3), 10.0)
    hmm = flagger.CoverageHMM.from_lambda(10.0)
    return {
        "CoverageHMM.viterbi": lambda: hmm.viterbi(cov, cov > 0),
        "CoverageHMM.posteriors": lambda: hmm.posteriors(cov, cov > 0),
        "fit_coverage_hmm": lambda: flagger.fit_coverage_hmm(
            cov, cov > 0, pcfg.qc),
        "evaluate_assembly": lambda: flagger.evaluate_assembly(
            {}, [], [], pcfg.qc),
        "sd_recover": lambda: sd.sd_recover({}, {}, [], pcfg),
        "make_mesh": lambda: make_mesh(),
        "build_sharded_align_step": lambda: build_sharded_align_step(),
        "banded_align_auto": lambda: ba.banded_align_auto(*_dp_batch()),
        "multihost.main": lambda: multihost.main(
            ["--work", str(tmp_path / "absent_work")]),
        "eval.main": lambda: port_eval.main(
            ["--base", str(tmp_path / "absent_base.vcf"),
             "--comp", str(tmp_path / "absent_comp.vcf")]),
        "pileup_chromosome": lambda: pileup.pileup_chromosome(
            [], codes, pcfg.phasing),
        "phase_chromosome": lambda: phase.phase_chromosome(
            pileup.pileup_chromosome([], codes, pcfg.phasing, device="cpu"),
            pcfg.phasing),
        "pairhmm_alleles": lambda: realign.pairhmm_alleles(
            np.zeros((1, 4), np.int8), np.ones(1, np.int32), win, win, 0.01),
        "build_hap_tables": lambda: partition.build_hap_tables({}, 8),
        "partition_reads": lambda: partition.partition_reads(
            {}, {}, {}, [], pcfg.partition),
        "consensus_poa_many": lambda: olc.consensus_poa_many([]),
        "polish_many": lambda: olc.polish_many([], [], polish),
        "polish_grouped": lambda: olc.polish_grouped({}, {}, polish),
        "assemble_block": lambda: olc.assemble_block([], pcfg.assembly),
        "run_assembly": lambda: farm.run_assembly({}, pcfg.assembly),
        "assemble_chromosome": lambda: asm.assemble_chromosome(
            [], codes, {}, pcfg),
        "Aligner": lambda: aligner.Aligner(
            {"chr1": "ACGT" * 200}, config.AlignConfig.preset("asm5")),
        "banded_align_cigars_dispatch":
            lambda: ba.banded_align_cigars_dispatch(*_dp_batch()),
        "banded_align_cigars": lambda: ba.banded_align_cigars(*_dp_batch()),
        "banded_row0_auto": lambda: ba.banded_row0_auto(*_dp_batch()),
        "edit_distance_batch_auto":
            lambda: ba.edit_distance_batch_auto(*_dp_batch()),
        "edit_distance_pairs": lambda: redundancy.edit_distance_pairs(pairs),
        "edit_sim_batch": lambda: redundancy.edit_sim_batch(pairs),
        "find_redundant": lambda: redundancy.find_redundant(
            one, one * 50, np.zeros(1, bool), ["A" * 50], pcfg.redundancy),
        "remove_redundancy_records":
            lambda: large_indel.remove_redundancy_records([], pcfg),
        "call_chromosome_raw": lambda: large_indel.call_chromosome_raw(
            "chr1", [], "ACGT" * 50, {}, pcfg),
        "call_chromosome": lambda: large_indel.call_chromosome(
            "chr1", [], "ACGT" * 50, {}, pcfg),
        "pair_candidates_by_sequence":
            lambda: complex_sv.pair_candidates_by_sequence(
                [], {}, pcfg.complex_sv),
        "recover_dups_from_ins": lambda: complex_sv.recover_dups_from_ins(
            [], {}, pcfg.complex_sv),
        "call_inversions": lambda: complex_sv.call_inversions(
            [], pcfg.complex_sv, None, {}),
        "call_complex_svs": lambda: complex_sv.call_complex_svs(
            {}, {}, pcfg),
        "evaluate": lambda: port_eval.evaluate([], []),
        "evaluate_files": lambda: port_eval.evaluate_files(
            str(tmp_path / "absent_base.vcf"),
            str(tmp_path / "absent_comp.vcf")),
    }


@pytest.mark.parametrize("entry", [
    "Aligner", "banded_align_cigars_dispatch", "banded_align_cigars",
    "banded_row0_auto", "edit_distance_batch_auto", "edit_distance_pairs",
    "edit_sim_batch", "find_redundant", "remove_redundancy_records",
    "call_chromosome_raw", "call_chromosome", "evaluate", "evaluate_files",
    "pileup_chromosome", "phase_chromosome", "pairhmm_alleles",
    "build_hap_tables", "partition_reads", "consensus_poa_many",
    "polish_many", "polish_grouped", "assemble_block", "run_assembly",
    "assemble_chromosome", "pair_candidates_by_sequence",
    "recover_dups_from_ins", "call_inversions", "call_complex_svs",
    "CoverageHMM.viterbi", "CoverageHMM.posteriors", "fit_coverage_hmm",
    "evaluate_assembly", "sd_recover", "make_mesh",
    "build_sharded_align_step", "banded_align_auto", "multihost.main",
    "eval.main"])
def test_entry_points_default_to_cuda(tmp_path, entry):
    """Every public entry point runs on the card unless asked for the CPU:
    without `device` on a host with no CUDA it raises before any work (the
    absent VCFs of evaluate_files are never opened)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("CUDA is present on this host")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_point_calls(tmp_path)[entry]()


def test_device_cuda_raises_without_cuda(tmp_path):
    import torch

    from volcanosv_tpu_torch.cli import main
    if torch.cuda.is_available():
        pytest.skip("CUDA is present on this host")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["eval", "--base", str(tmp_path / "a.vcf"),
              "--comp", str(tmp_path / "b.vcf")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["vc-large-indel", "--ref", str(tmp_path / "r.fa"),
              "--contig", str(tmp_path / "c.fa"), "-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["asm", "--ref", str(tmp_path / "r.fa"),
              "--fastq", str(tmp_path / "r.fq"), "-o", str(tmp_path)])
    for cmd in ("vc-small-indel", "vc-complex-sv", "qc"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([cmd, "--ref", str(tmp_path / "r.fa"),
                  "--contig", str(tmp_path / "c.fa"), "-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["run", "--ref", str(tmp_path / "r.fa"),
              "--fastq", str(tmp_path / "r.fq"), "-o", str(tmp_path)])


def test_eval_module_entry_matches_reference(tmp_path):
    """`python -m volcanosv_tpu_torch.eval` takes the JAX package's flags
    and prints its JSON."""
    from volcanosv_tpu_torch.io.vcf import VcfRecord, make_header, write_vcf
    base = [VcfRecord(chrom="chr1", pos=p, id=f"t{i}", ref="N",
                      alt=f"<{k}>", gt="0|1",
                      info={"SVTYPE": k, "SVLEN": n, "END": p + n})
            for i, (p, k, n) in enumerate([(1000, "DEL", 120),
                                           (5000, "INS", 300),
                                           (9000, "DEL", 45)])]
    comp = [dataclasses.replace(base[0], pos=1010, id="c0", gt="1|1"),
            dataclasses.replace(base[1], pos=5200, id="c1"),
            dataclasses.replace(base[2], pos=20000, id="c2")]
    header = make_header({"chr1": 50_000})
    write_vcf(str(tmp_path / "base.vcf"), header, base)
    write_vcf(str(tmp_path / "comp.vcf"), header, comp)
    args = ["--base", str(tmp_path / "base.vcf"),
            "--comp", str(tmp_path / "comp.vcf"), "-r", "300", "-S", "40"]
    outs = [subprocess.run([sys.executable, "-m", mod, *args, *extra],
                           cwd=REPO, capture_output=True, text=True,
                           timeout=120)
            for mod, extra in (("volcanosv_tpu.eval", []),
                               ("volcanosv_tpu_torch.eval",
                                ["--device", "cpu"]))]
    for r in outs:
        assert r.returncode == 0, r.stderr[-2000:]
    got = outs[1].stdout.strip().splitlines()[-1]
    assert got == outs[0].stdout.strip().splitlines()[-1]
    assert '"TP": 2, "FP": 1, "FN": 1' in got


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """`--profile_trace DIR`: a torch.profiler trace of the command."""
    import json

    from volcanosv_tpu_torch.cli import main
    assert main(["sim", "-o", str(tmp_path / "sim"), "--length", "6000",
                 "--n_del", "0", "--n_ins", "0", "--coverage", "6",
                 "--read_len", "2000"]) == 0
    assert main(["qc", "--ref", str(tmp_path / "sim" / "ref.fa"),
                 "--contig", str(tmp_path / "sim" / "true_contigs.fa"),
                 "--fastq", str(tmp_path / "sim" / "reads.fastq"),
                 "-o", str(tmp_path / "qc"), "--device", "cpu",
                 "--profile_trace", str(tmp_path / "trace")]) == 0
    with open(tmp_path / "trace" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    assert (tmp_path / "qc" / "flagger_blocks.bed").exists()
