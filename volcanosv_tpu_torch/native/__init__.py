"""Native (C++) host helpers, built on demand with g++.

Six sources are byte-for-byte copies of the reference package's
`native/` helpers (anchor chaining, minimizer sketching, fused seed+chain,
all-vs-all overlaps, BAM scanning, inversion-soup scanning).  The seventh,
`ava_index.cpp`, is the port's own: the host half of the card's overlap
pass (`ops/overlap.py`), which repeats `ava.cpp`'s sketch and index.  They
are host code: every device kernel of the port lives under `csrc/`.

The library is built at first use into `<checkout>/build/native/`, never
into the package directory.  A failed build raises `RuntimeError` with the
compiler's message.  The port carries no numpy stand-in for a helper: the
reference's do not give the helpers' outputs (its Python soup scan has no
cap on its runs, for one), so a missing library would change the calls.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ["chain.cpp", "bamscan.cpp", "sketch.cpp", "seedchain.cpp",
            "ava.cpp", "soup.cpp", "ava_index.cpp"]
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")
CXX = "g++"


def _lib_path() -> str:
    src = b"".join(open(os.path.join(_HERE, s), "rb").read() for s in _SOURCES)
    tag = hashlib.sha256(src).hexdigest()[:12]
    return os.path.join(BUILD_ROOT, "native", f"libvolcano_native_{tag}.so")


def build_native(force: bool = False) -> str:
    """Compile the native lib if needed; returns its path, or raises
    RuntimeError with the compiler's message.  The library is written under
    a temporary name and renamed into place, so concurrent processes never
    load a half-written file."""
    out = _lib_path()
    if os.path.exists(out) and not force:
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    cmd = [CXX, "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           *srcs, "-o", tmp, "-lz", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native helpers: compiler {CXX!r} not found "
                           f"({e})") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"native helpers: {CXX} exited {e.returncode}:\n"
                           f"{e.stderr}") from e
    os.replace(tmp, out)
    return out


_lib = None


def get_lib():
    """ctypes handle to the native lib, built at the first call; raises
    RuntimeError when the build fails."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_native())
        _configure(lib)
        _lib = lib
    return _lib


def _configure(lib) -> None:
    import numpy.ctypeslib as npc
    import numpy as np

    i64p = npc.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = npc.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = npc.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i8p = npc.ndpointer(np.int8, flags="C_CONTIGUOUS")
    lib.chain_dp.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_float, f32p, i32p]
    lib.chain_dp.restype = None
    lib.chain_backtrack.argtypes = [
        f32p, i32p, ctypes.c_int64, ctypes.c_float, ctypes.c_int32,
        i8p, i32p, f32p, ctypes.c_int64]
    lib.chain_backtrack.restype = ctypes.c_int64

    u32p = npc.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.chain_segments.argtypes = [
        i64p, i64p, i64p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int32,
        f32p, i64p, i64p, i64p, i64p, i32p]
    lib.chain_segments.restype = None

    lib.sketch_dna.argtypes = [
        i8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        i64p, u32p, i8p]
    lib.sketch_dna.restype = ctypes.c_int64

    lib.bam_scan.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.bam_scan.restype = ctypes.POINTER(BamScanStruct)
    lib.bam_scan_free.argtypes = [ctypes.POINTER(BamScanStruct)]
    lib.bam_scan_free.restype = None

    lib.seed_chain_batch.argtypes = [
        i8p, i64p, ctypes.c_int64,                      # codes, q_off, n
        ctypes.c_int32, ctypes.c_int32,                 # k, w
        u32p, i64p, i8p, ctypes.c_int64, ctypes.c_int32,  # index, max_hits
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.c_float, ctypes.c_int32, ctypes.c_int32,  # chain params
        ctypes.c_int32,                                  # n_threads
        ctypes.c_int64, ctypes.c_float]                  # sel_hole, sel_frac
    lib.seed_chain_batch.restype = ctypes.POINTER(SeedChainStruct)
    lib.seed_chain_free.argtypes = [ctypes.POINTER(SeedChainStruct)]
    lib.seed_chain_free.restype = None

    lib.ava_overlaps.argtypes = [
        i8p, i64p, ctypes.c_int64,                      # codes, q_off, n
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # k, w, max_hits
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.c_float, ctypes.c_int32,                 # chain params
        ctypes.c_int32]                                  # n_threads
    lib.ava_overlaps.restype = ctypes.POINTER(AvaStruct)
    lib.ava_free.argtypes = [ctypes.POINTER(AvaStruct)]
    lib.ava_free.restype = None

    lib.ava_index.argtypes = [
        i8p, i64p, ctypes.c_int64,                      # codes, q_off, n
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]  # k, w, n_threads
    lib.ava_index.restype = ctypes.POINTER(AvaIndexStruct)
    lib.ava_index_free.argtypes = [ctypes.POINTER(AvaIndexStruct)]
    lib.ava_index_free.restype = None
    lib.ava_gap_costs.argtypes = [ctypes.c_float, ctypes.c_int64, f32p]
    lib.ava_gap_costs.restype = None

    lib.soup_runs.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int64,           # cigar, n_ops, pos
        i8p, ctypes.c_int64, i8p, ctypes.c_int64,       # qc, qlen, tc, tlen
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # params
        i64p, i64p, ctypes.c_int64]                      # out_r0/r1, max_out
    lib.soup_runs.restype = ctypes.c_int64


def ava_overlaps_np(lib, codes, acfg):
    """Call ava_overlaps on a list of 2-bit code arrays → numpy columns
    (a, b, strand, score, q_start, q_end, t_start, t_end)."""
    import numpy as np
    q_off = np.zeros(len(codes) + 1, np.int64)
    np.cumsum([len(c) for c in codes], out=q_off[1:])
    flat = np.concatenate(codes) if codes else np.zeros(0, np.int8)
    flat = np.ascontiguousarray(flat, np.int8)
    res = lib.ava_overlaps(flat, q_off, len(codes),
                           acfg.k, acfg.w, 64,
                           16, acfg.max_anchor_gap, acfg.chain_bandwidth,
                           0.05, float(acfg.min_chain_score),
                           acfg.min_chain_anchors, 0)
    try:
        r = res.contents
        n = int(r.n)
        cols = tuple(np.ctypeslib.as_array(p, shape=(n,)).copy()
                     for p in (r.a, r.b, r.strand, r.score,
                               r.q_start, r.q_end, r.t_start, r.t_end))
    finally:
        lib.ava_free(res)
    return cols


@contextlib.contextmanager
def ava_index_views(lib, codes, k: int, w: int):
    """ava_index on a list of 2-bit code arrays, as numpy views of the
    library's buffers, freed when the block ends: the per-read minimizers
    (`min_off` (n + 1,) int64, `min_hash` uint32, `min_pos` int32,
    `min_strand` int8) and the filtered index (`idx_hash` ascending uint32,
    `idx_read`, `idx_pos` int32, `idx_strand` int8), as ava_overlaps
    builds them."""
    import numpy as np
    q_off = np.zeros(len(codes) + 1, np.int64)
    np.cumsum([len(c) for c in codes], out=q_off[1:])
    flat = np.concatenate(codes) if codes else np.zeros(0, np.int8)
    flat = np.ascontiguousarray(flat, np.int8)
    res = lib.ava_index(flat, q_off, len(codes), k, w, 0)
    try:
        r = res.contents
        n_min, n_idx = int(r.n_min), int(r.n_idx)

        def view(p, n):
            return np.ctypeslib.as_array(p, shape=(n,)) if n else \
                np.zeros(0, np.dtype(p._type_))

        yield dict(min_off=view(r.min_off, len(codes) + 1),
                   min_hash=view(r.min_hash, n_min),
                   min_pos=view(r.min_pos, n_min),
                   min_strand=view(r.min_strand, n_min),
                   idx_hash=view(r.idx_hash, n_idx),
                   idx_read=view(r.idx_read, n_idx),
                   idx_pos=view(r.idx_pos, n_idx),
                   idx_strand=view(r.idx_strand, n_idx))
    finally:
        lib.ava_index_free(res)


def ava_gap_costs_np(lib, gap_scale: float, bandwidth: int):
    """chain_dp's gap cost for gaps 0..bandwidth, (bandwidth + 1,) float32,
    from the same expression in the same compiled library."""
    import numpy as np
    out = np.zeros(bandwidth + 1, np.float32)
    lib.ava_gap_costs(gap_scale, bandwidth, out)
    return out


class AvaIndexStruct(ctypes.Structure):
    """Mirror of AvaIndexResult in ava_index.cpp (field order must match)."""
    _fields_ = [
        ("n_min", ctypes.c_int64),
        ("min_off", ctypes.POINTER(ctypes.c_int64)),
        ("min_hash", ctypes.POINTER(ctypes.c_uint32)),
        ("min_pos", ctypes.POINTER(ctypes.c_int32)),
        ("min_strand", ctypes.POINTER(ctypes.c_int8)),
        ("n_idx", ctypes.c_int64),
        ("idx_hash", ctypes.POINTER(ctypes.c_uint32)),
        ("idx_read", ctypes.POINTER(ctypes.c_int32)),
        ("idx_pos", ctypes.POINTER(ctypes.c_int32)),
        ("idx_strand", ctypes.POINTER(ctypes.c_int8)),
        ("work", ctypes.c_void_p),
    ]


class AvaStruct(ctypes.Structure):
    """Mirror of AvaResult in ava.cpp (field order must match)."""
    _fields_ = [
        ("n", ctypes.c_int64),
        ("a", ctypes.POINTER(ctypes.c_int32)),
        ("b", ctypes.POINTER(ctypes.c_int32)),
        ("strand", ctypes.POINTER(ctypes.c_int8)),
        ("score", ctypes.POINTER(ctypes.c_float)),
        ("q_start", ctypes.POINTER(ctypes.c_int64)),
        ("q_end", ctypes.POINTER(ctypes.c_int64)),
        ("t_start", ctypes.POINTER(ctypes.c_int64)),
        ("t_end", ctypes.POINTER(ctypes.c_int64)),
    ]


class SeedChainStruct(ctypes.Structure):
    """Mirror of SeedChainResult in seedchain.cpp (field order must match)."""
    _fields_ = [
        ("n_chains", ctypes.c_int64),
        ("n_anchors", ctypes.c_int64),
        ("chain_query", ctypes.POINTER(ctypes.c_int32)),
        ("chain_strand", ctypes.POINTER(ctypes.c_int8)),
        ("chain_score", ctypes.POINTER(ctypes.c_float)),
        ("anchor_off", ctypes.POINTER(ctypes.c_int64)),
        ("aq", ctypes.POINTER(ctypes.c_int64)),
        ("at", ctypes.POINTER(ctypes.c_int64)),
    ]


class BamScanStruct(ctypes.Structure):
    """Mirror of BamScanResult in bamscan.cpp (field order must match)."""
    _fields_ = [
        ("n_records", ctypes.c_int64),
        ("flag", ctypes.POINTER(ctypes.c_int32)),
        ("ref_id", ctypes.POINTER(ctypes.c_int32)),
        ("pos", ctypes.POINTER(ctypes.c_int64)),
        ("mapq", ctypes.POINTER(ctypes.c_int32)),
        ("next_ref_id", ctypes.POINTER(ctypes.c_int32)),
        ("next_pos", ctypes.POINTER(ctypes.c_int64)),
        ("name_off", ctypes.POINTER(ctypes.c_int64)),
        ("names", ctypes.POINTER(ctypes.c_char)),
        ("cig_off", ctypes.POINTER(ctypes.c_int64)),
        ("cigs", ctypes.POINTER(ctypes.c_uint32)),
        ("seq_off", ctypes.POINTER(ctypes.c_int64)),
        ("seqs", ctypes.POINTER(ctypes.c_char)),
        ("n_refs", ctypes.c_int32),
        ("ref_name_off", ctypes.POINTER(ctypes.c_int64)),
        ("ref_names", ctypes.POINTER(ctypes.c_char)),
        ("ref_len", ctypes.POINTER(ctypes.c_int64)),
        ("header_text", ctypes.POINTER(ctypes.c_char)),
        ("header_len", ctypes.c_int64),
        ("error", ctypes.c_char_p),
    ]
