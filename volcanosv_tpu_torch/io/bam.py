"""BAM reader/writer implemented from the SAM spec (no htslib/pysam).

The reference pipeline uses pysam + samtools for all BAM access (e.g.
prepare_info_v1.py:42-63 scans HP/PS tags; write_fastq_asm_general.py
streams read sequences).  We provide the same capabilities: streaming
decode, HP/PS/SA tag access, flag helpers, and BAM writing (for phased-BAM
output).  SAM text I/O is included for debuggability.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from .bgzf import _BGZF_EOF, BgzfReader, BgzfWriter

CIGAR_OPS = "MIDNSHP=X"
_CIGAR_CONSUMES_QUERY = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=np.int8)
_CIGAR_CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.int8)
_SEQ_NT = "=ACMGRSVTWYHKDBN"
_NT_TO_4BIT = {c: i for i, c in enumerate(_SEQ_NT)}
_NT_TO_4BIT.update({"a": 1, "c": 2, "g": 4, "t": 8, "n": 15})

# flags
FUNMAP = 0x4
FREVERSE = 0x10
FSECONDARY = 0x100
FSUPPLEMENTARY = 0x800
FDUP = 0x400
FQCFAIL = 0x200


@dataclass
class BamRecord:
    name: str
    flag: int = 0
    ref_id: int = -1
    pos: int = -1                      # 0-based leftmost
    mapq: int = 0
    cigar: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int64))
    # cigar is (n_ops, 2): [:,0]=op code (MIDNSHP=X), [:,1]=length
    seq: str = ""
    qual: np.ndarray | None = None
    tags: dict = field(default_factory=dict)
    next_ref_id: int = -1
    next_pos: int = -1
    tlen: int = 0

    # --- flag helpers -----------------------------------------------------
    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FSECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FSUPPLEMENTARY)

    @property
    def is_primary(self) -> bool:
        return not (self.flag & (FUNMAP | FSECONDARY | FSUPPLEMENTARY))

    # --- coordinate helpers ----------------------------------------------
    def reference_length(self) -> int:
        if len(self.cigar) == 0:
            return 0
        ops, lens = self.cigar[:, 0], self.cigar[:, 1]
        return int(lens[_CIGAR_CONSUMES_REF[ops] > 0].sum())

    @property
    def reference_end(self) -> int:
        return self.pos + self.reference_length()

    def query_length(self) -> int:
        if len(self.cigar) == 0:
            return len(self.seq)
        ops, lens = self.cigar[:, 0], self.cigar[:, 1]
        return int(lens[_CIGAR_CONSUMES_QUERY[ops] > 0].sum())

    def query_clips(self) -> tuple[int, int]:
        """(left, right) soft+hard clip lengths in *query orientation*."""
        left = right = 0
        for op, ln in self.cigar:
            if op in (4, 5):
                left += int(ln)
            else:
                break
        for op, ln in self.cigar[::-1]:
            if op in (4, 5):
                right += int(ln)
            else:
                break
        return left, right

    def cigar_string(self) -> str:
        return "".join(f"{int(l)}{CIGAR_OPS[int(o)]}" for o, l in self.cigar)


def cigar_from_string(s: str) -> np.ndarray:
    ops = []
    n = 0
    for ch in s:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            ops.append((CIGAR_OPS.index(ch), n))
            n = 0
    return np.array(ops, dtype=np.int64).reshape(-1, 2)


def _parse_tags(data: bytes) -> dict:
    tags = {}
    i = 0
    n = len(data)
    while i + 3 <= n:
        key = data[i : i + 2].decode()
        typ = chr(data[i + 2])
        i += 3
        if typ == "A":
            tags[key] = chr(data[i]); i += 1
        elif typ == "c":
            tags[key] = struct.unpack_from("<b", data, i)[0]; i += 1
        elif typ == "C":
            tags[key] = struct.unpack_from("<B", data, i)[0]; i += 1
        elif typ == "s":
            tags[key] = struct.unpack_from("<h", data, i)[0]; i += 2
        elif typ == "S":
            tags[key] = struct.unpack_from("<H", data, i)[0]; i += 2
        elif typ == "i":
            tags[key] = struct.unpack_from("<i", data, i)[0]; i += 4
        elif typ == "I":
            tags[key] = struct.unpack_from("<I", data, i)[0]; i += 4
        elif typ == "f":
            tags[key] = struct.unpack_from("<f", data, i)[0]; i += 4
        elif typ in "ZH":
            j = data.index(b"\x00", i)
            tags[key] = data[i:j].decode(); i = j + 1
        elif typ == "B":
            sub = chr(data[i]); cnt = struct.unpack_from("<I", data, i + 1)[0]
            i += 5
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
            sz = struct.calcsize(fmt)
            tags[key] = list(struct.unpack_from(f"<{cnt}{fmt}", data, i))
            i += cnt * sz
        else:
            break
    return tags


def _encode_tags(tags: dict) -> bytes:
    out = bytearray()
    for key, val in tags.items():
        kb = key.encode()
        if isinstance(val, int):
            out += kb + b"i" + struct.pack("<i", val)
        elif isinstance(val, float):
            out += kb + b"f" + struct.pack("<f", val)
        elif isinstance(val, str) and len(val) == 1 and key in ("XT",):
            out += kb + b"A" + val.encode()
        elif isinstance(val, str):
            out += kb + b"Z" + val.encode() + b"\x00"
        elif isinstance(val, (list, np.ndarray)):
            arr = np.asarray(val, dtype=np.int32)
            out += kb + b"B" + b"i" + struct.pack("<I", len(arr)) + arr.astype("<i4").tobytes()
    return bytes(out)


_SEQ_DECODE = np.array(list(_SEQ_NT.encode()), dtype=np.uint8)


def _decode_seq(raw: bytes, l_seq: int) -> str:
    b = np.frombuffer(raw, dtype=np.uint8)
    hi = b >> 4
    lo = b & 0xF
    codes = np.empty(len(b) * 2, dtype=np.uint8)
    codes[0::2] = _SEQ_DECODE[hi]
    codes[1::2] = _SEQ_DECODE[lo]
    return codes[:l_seq].tobytes().decode()


def _encode_seq(seq: str) -> bytes:
    codes = np.array([_NT_TO_4BIT.get(c, 15) for c in seq], dtype=np.uint8)
    if len(codes) % 2:
        codes = np.append(codes, 0)
    return ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()


class BamReader:
    def __init__(self, path: str):
        self._r = BgzfReader(path)
        magic = self._r.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", self._r.read(4))
        self.header_text = self._r.read(l_text).decode(errors="replace")
        (n_ref,) = struct.unpack("<i", self._r.read(4))
        self.references: list[str] = []
        self.lengths: list[int] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._r.read(4))
            self.references.append(self._r.read(l_name)[:-1].decode())
            (l_ref,) = struct.unpack("<i", self._r.read(4))
            self.lengths.append(l_ref)

    def __iter__(self):
        while True:
            raw = self._r.read(4)
            if len(raw) < 4:
                return
            (block_size,) = struct.unpack("<i", raw)
            data = self._r.read(block_size)
            if len(data) < block_size:
                return
            yield self._parse(data)

    def _parse(self, d: bytes) -> BamRecord:
        (ref_id, pos, l_rn, mapq, _bin, n_cig, flag, l_seq,
         nref, npos, tlen) = struct.unpack_from("<iiBBHHHiiii", d, 0)
        o = 32
        name = d[o : o + l_rn - 1].decode()
        o += l_rn
        cig_raw = np.frombuffer(d, dtype="<u4", count=n_cig, offset=o)
        cigar = np.stack([(cig_raw & 0xF).astype(np.int64),
                          (cig_raw >> 4).astype(np.int64)], axis=1) if n_cig else np.zeros((0, 2), np.int64)
        o += 4 * n_cig
        nbytes = (l_seq + 1) // 2
        seq = _decode_seq(d[o : o + nbytes], l_seq) if l_seq else ""
        o += nbytes
        qual = np.frombuffer(d, dtype=np.uint8, count=l_seq, offset=o).copy() if l_seq else None
        if qual is not None and len(qual) and qual[0] == 0xFF:
            qual = None
        o += l_seq
        tags = _parse_tags(d[o:])
        return BamRecord(name, flag, ref_id, pos, mapq, cigar, seq, qual, tags, nref, npos, tlen)

    def close(self):
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ---------------------------------------------------------------------------
# native columnar scanner (parallel BGZF inflate, bamscan.cpp)
# ---------------------------------------------------------------------------

@dataclass
class BamScan:
    """Columnar BAM scan from the native loader — numpy views per field.

    Tags and qual are not decoded (use BamReader when you need them)."""
    references: list[str]
    lengths: list[int]
    header_text: str
    flag: np.ndarray         # (n,) int32
    ref_id: np.ndarray       # (n,) int32
    pos: np.ndarray          # (n,) int64
    mapq: np.ndarray         # (n,) int32
    next_ref_id: np.ndarray
    next_pos: np.ndarray
    name_off: np.ndarray     # (n+1,) int64
    names: bytes
    cig_off: np.ndarray      # (n+1,) int64 (uint32-word offsets)
    cigs: np.ndarray         # uint32 raw BAM cigar words
    seq_off: np.ndarray      # (n+1,) int64
    seqs: bytes              # ASCII

    def __len__(self) -> int:
        return len(self.flag)

    def name(self, i: int) -> str:
        return self.names[self.name_off[i]:self.name_off[i + 1]].decode()

    def seq(self, i: int) -> str:
        return self.seqs[self.seq_off[i]:self.seq_off[i + 1]].decode()

    def cigar(self, i: int) -> np.ndarray:
        w = self.cigs[self.cig_off[i]:self.cig_off[i + 1]]
        return np.stack([(w & 0xF).astype(np.int64),
                         (w >> 4).astype(np.int64)], axis=1) \
            if len(w) else np.zeros((0, 2), np.int64)

    def records(self):
        """Materialize BamRecord objects (no tags/qual)."""
        for i in range(len(self)):
            yield BamRecord(
                self.name(i), int(self.flag[i]), int(self.ref_id[i]),
                int(self.pos[i]), int(self.mapq[i]), self.cigar(i),
                self.seq(i), None, {}, int(self.next_ref_id[i]),
                int(self.next_pos[i]), 0)

    def read_seqs(self) -> dict[str, str]:
        """name → seq over primary mapped-or-unmapped reads (the
        _load_reads contract: skip secondary/supplementary, need seq)."""
        skip = FSECONDARY | FSUPPLEMENTARY
        out: dict[str, str] = {}
        for i in np.nonzero((self.flag & skip) == 0)[0]:
            if self.seq_off[i + 1] > self.seq_off[i]:
                out[self.name(int(i))] = self.seq(int(i))
        return out


def scan_bam(path: str, n_threads: int = 0) -> BamScan:
    """Native columnar scan (native/bamscan.cpp, parallel inflate); raises
    ValueError on a malformed file, and on one that does not end with the
    BGZF EOF block: the native scan stops quietly where a file was cut
    short of a block (or at a block's end), and would return only the
    records before the cut."""
    from ..native import get_lib
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            if fh.tell() >= len(_BGZF_EOF):
                fh.seek(-len(_BGZF_EOF), os.SEEK_END)
            tail = fh.read()
    except OSError as e:
        raise ValueError(f"{path}: {e}") from e
    if tail != _BGZF_EOF:
        raise ValueError(f"{path}: no BGZF EOF block at the end (truncated)")
    lib = get_lib()
    import ctypes
    res = lib.bam_scan(path.encode(), n_threads)
    try:
        c = res.contents
        if c.error:
            raise ValueError(f"{path}: {c.error.decode()}")
        n = int(c.n_records)

        def arr(p, cnt, dtype):
            if cnt == 0:
                return np.zeros(0, dtype)
            return np.ctypeslib.as_array(p, shape=(cnt,)).astype(dtype,
                                                                 copy=True)

        name_off = arr(c.name_off, n + 1, np.int64)
        cig_off = arr(c.cig_off, n + 1, np.int64)
        seq_off = arr(c.seq_off, n + 1, np.int64)
        rno = arr(c.ref_name_off, c.n_refs + 1, np.int64)
        rnames_blob = ctypes.string_at(c.ref_names, int(rno[-1])) \
            if c.n_refs else b""
        refs = [rnames_blob[rno[i]:rno[i + 1]].decode()
                for i in range(c.n_refs)]
        return BamScan(
            references=refs,
            lengths=list(arr(c.ref_len, c.n_refs, np.int64)),
            header_text=ctypes.string_at(c.header_text,
                                         int(c.header_len)).decode(
                                             errors="replace"),
            flag=arr(c.flag, n, np.int32),
            ref_id=arr(c.ref_id, n, np.int32),
            pos=arr(c.pos, n, np.int64),
            mapq=arr(c.mapq, n, np.int32),
            next_ref_id=arr(c.next_ref_id, n, np.int32),
            next_pos=arr(c.next_pos, n, np.int64),
            name_off=name_off,
            names=ctypes.string_at(c.names, int(name_off[-1])) if n else b"",
            cig_off=cig_off,
            cigs=arr(c.cigs, int(cig_off[-1]), np.uint32),
            seq_off=seq_off,
            seqs=ctypes.string_at(c.seqs, int(seq_off[-1])) if n else b"")
    finally:
        lib.bam_scan_free(res)


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class BamWriter:
    def __init__(self, path: str, references: list[str], lengths: list[int],
                 header_text: str | None = None):
        self._w = BgzfWriter(path)
        self.references = list(references)
        self._ref_index = {r: i for i, r in enumerate(references)}
        if header_text is None:
            header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
                f"@SQ\tSN:{r}\tLN:{l}\n" for r, l in zip(references, lengths)
            )
        ht = header_text.encode()
        self._w.write(b"BAM\x01" + struct.pack("<i", len(ht)) + ht)
        self._w.write(struct.pack("<i", len(references)))
        for r, l in zip(references, lengths):
            rb = r.encode() + b"\x00"
            self._w.write(struct.pack("<i", len(rb)) + rb + struct.pack("<i", l))

    def write(self, rec: BamRecord) -> None:
        name = rec.name.encode() + b"\x00"
        cig = ((rec.cigar[:, 1].astype(np.uint64) << 4)
               | rec.cigar[:, 0].astype(np.uint64)).astype("<u4").tobytes()
        seq = _encode_seq(rec.seq)
        l_seq = len(rec.seq)
        qual = (rec.qual.astype(np.uint8).tobytes() if rec.qual is not None
                else b"\xff" * l_seq)
        tags = _encode_tags(rec.tags)
        end = rec.pos + max(1, rec.reference_length())
        body = (
            struct.pack(
                "<iiBBHHHiiii", rec.ref_id, rec.pos, len(name), rec.mapq,
                _reg2bin(max(rec.pos, 0), end), len(rec.cigar), rec.flag,
                l_seq, rec.next_ref_id, rec.next_pos, rec.tlen,
            )
            + name + cig + seq + qual + tags
        )
        self._w.write(struct.pack("<i", len(body)) + body)

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
