"""Reads from a BAM (`--bam`): the port's native scan against the JAX
package's, and the port's refusal of a malformed or truncated file.

`BamScan.read_seqs` (the `_load_reads` contract: primary records with a
SEQ, secondary and supplementary skipped, the last record of a repeated
name winning at the name's first place) must give equal dicts in equal
order in both packages, on a BAM with every kind of record.  The port
calls the native scan alone (no pure-Python fallback), so on a file that
is not a whole BAM it must raise ValueError, never go on with fewer
reads or none."""
import argparse

import numpy as np
import pytest

from torch_inputs import ensure_reference_native_lib
from volcanosv_tpu import cli as ref_cli
from volcanosv_tpu.io import bam as ref_bam
from volcanosv_tpu_torch import cli as port_cli
from volcanosv_tpu_torch.io import bam as port_bam


@pytest.fixture(scope="module", autouse=True)
def _reference_native_lib():
    ensure_reference_native_lib()


def _records(bam):
    """Every kind of record, with names repeated across kinds: mapped
    forward and reverse, secondary and supplementary (with and without a
    SEQ), unmapped, a primary with no SEQ, and a name written twice as a
    primary."""
    rng = np.random.default_rng(12)

    def seq(n):
        return "".join("ACGTN"[i] for i in rng.integers(0, 5, n))
    cig = bam.cigar_from_string
    recs = []
    for i in range(40):
        name = f"read{i % 17}"          # names repeat across records
        kind = i % 8
        L = int(rng.integers(40, 300))
        flag = {0: 0, 1: bam.FREVERSE, 2: bam.FSECONDARY,
                3: bam.FSUPPLEMENTARY, 4: bam.FUNMAP,
                5: bam.FSECONDARY | bam.FREVERSE,
                6: bam.FSUPPLEMENTARY | bam.FREVERSE, 7: 0}[kind]
        s = "" if kind in (5, 7) and i % 16 == kind else seq(L)
        mapped = not flag & bam.FUNMAP
        recs.append(bam.BamRecord(
            name=name, flag=flag, ref_id=i % 2 if mapped else -1,
            pos=int(rng.integers(0, 5000)) if mapped else -1,
            mapq=int(rng.integers(0, 61)) if mapped else 0,
            cigar=cig(f"{len(s)}M") if mapped and s else cig(""),
            seq=s, tags={"HP": 1 + i % 2} if kind == 0 else {}))
    return recs


@pytest.fixture(scope="module")
def mixed_bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bam") / "mixed.bam")
    with ref_bam.BamWriter(path, ["chr1", "chr2"], [9000, 7000]) as w:
        for r in _records(ref_bam):
            w.write(r)
    return path


def test_writers_give_the_same_bytes(mixed_bam, tmp_path):
    path = str(tmp_path / "port.bam")
    with port_bam.BamWriter(path, ["chr1", "chr2"], [9000, 7000]) as w:
        for r in _records(port_bam):
            w.write(r)
    with open(path, "rb") as a, open(mixed_bam, "rb") as b:
        assert a.read() == b.read()


def test_read_seqs_equal_in_order(mixed_bam):
    got = port_bam.scan_bam(mixed_bam).read_seqs()
    want = ref_bam.scan_bam(mixed_bam).read_seqs()
    assert list(got.items()) == list(want.items())
    # the recipe's kinds all reached the file: some names kept, some
    # dropped (secondary / supplementary / no SEQ only)
    assert 0 < len(got) < 17


def test_read_seqs_rule(mixed_bam):
    """The rule itself, on the records as written."""
    want = {}
    skip = port_bam.FSECONDARY | port_bam.FSUPPLEMENTARY
    for r in _records(port_bam):
        if not r.flag & skip and r.seq:
            want[r.name] = r.seq
    got = port_bam.scan_bam(mixed_bam).read_seqs()
    assert list(got.items()) == list(want.items())


@pytest.mark.parametrize("sort", ["as_written", "by_name"])
def test_load_reads_equal_in_order(mixed_bam, tmp_path, sort):
    """Both CLIs' `_load_reads` on `--bam`, in the file's order and after
    the records were reordered."""
    path = mixed_bam
    if sort == "by_name":
        path = str(tmp_path / "sorted.bam")
        recs = sorted(_records(ref_bam), key=lambda r: (r.name, -r.flag))
        with ref_bam.BamWriter(path, ["chr1", "chr2"], [9000, 7000]) as w:
            for r in recs:
                w.write(r)
    args = argparse.Namespace(fastq=None, bam=path)
    got = port_cli._load_reads(args)
    assert list(got.items()) == list(ref_cli._load_reads(args).items())
    assert got


def _bad(tmp_path, name: str, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    return path


def _bgzf_blocks(data: bytes) -> list[int]:
    """The offsets of the BGZF blocks of `data`."""
    offs, o = [], 0
    while o < len(data):
        offs.append(o)
        o += int.from_bytes(data[o + 16:o + 18], "little") + 1
    return offs


@pytest.fixture(scope="module")
def long_bam(tmp_path_factory):
    """An unaligned BAM of 300 reads, several BGZF blocks long."""
    path = str(tmp_path_factory.mktemp("long") / "reads.bam")
    rng = np.random.default_rng(2)
    with port_bam.BamWriter(path, [], []) as w:
        for i in range(300):
            s = "".join("ACGT"[j] for j in rng.integers(0, 4, 2000))
            w.write(port_bam.BamRecord(name=f"r{i}", flag=port_bam.FUNMAP,
                                       seq=s))
    with open(path, "rb") as fh:
        data = fh.read()
    assert len(_bgzf_blocks(data)) > 4
    assert len(port_bam.scan_bam(path).read_seqs()) == 300
    return data


@pytest.mark.parametrize("cut", [
    "eof_block", "inside_eof_block", "block_boundary",
    "just_past_boundary", "inside_block", "header_only", "empty"])
def test_truncated_bam_raises(long_bam, tmp_path, cut):
    """A file cut short raises ValueError wherever the cut falls; the
    native scan alone returns the records before a cut at (or just past)
    a block boundary."""
    offs = _bgzf_blocks(long_bam)
    at = {"eof_block": len(long_bam) - 28,
          "inside_eof_block": len(long_bam) - 10,
          "block_boundary": offs[-3],
          "just_past_boundary": offs[-3] + 10,
          "inside_block": offs[-3] + 200,
          "header_only": offs[1],
          "empty": 0}[cut]
    path = _bad(tmp_path, "cut.bam", long_bam[:at])
    with pytest.raises(ValueError):
        port_bam.scan_bam(path)
    with pytest.raises(ValueError):
        port_cli._load_reads(argparse.Namespace(fastq=None, bam=path))


def test_bad_magic_raises(tmp_path):
    """A whole BGZF file whose payload is not a BAM."""
    from volcanosv_tpu_torch.io.bgzf import BgzfWriter
    path = str(tmp_path / "notbam.bam")
    w = BgzfWriter(path)
    w.write(b"SAM\x01" + b"\x00" * 400)
    w.close()
    with pytest.raises(ValueError, match="magic"):
        port_bam.scan_bam(path)


@pytest.mark.parametrize("what", ["gzip_not_bgzf", "plain_text", "missing"])
def test_not_a_bam_raises(tmp_path, what):
    import gzip
    if what == "missing":
        path = str(tmp_path / "absent.bam")
    else:
        data = gzip.compress(b"@r1\nACGT\n+\n!!!!\n" * 50) \
            if what == "gzip_not_bgzf" else b"@r1\nACGT\n+\n!!!!\n" * 50
        path = _bad(tmp_path, f"{what}.bam", data)
    with pytest.raises(ValueError):
        port_bam.scan_bam(path)
