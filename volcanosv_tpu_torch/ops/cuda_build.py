"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface, loaded with ctypes.  The build runs
at first use, never at import, into a content-hashed directory under
`<checkout>/build/`; all sources compile in parallel, one `nvcc` each.  A
missing compiler or a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build")
SOURCES = ("banded_dp", "tb_walk", "pairhmm", "coverage_hmm", "kmer", "mec",
           "ava")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, f"{name}.cu"), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_ROOT, f"cuda-{h.hexdigest()[:12]}")


def _configure(name: str, lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # every library exports <name>_error_string, which check() reads
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    if name == "banded_dp":
        lib.banded_dp_launch.argtypes = [vp, vp, vp, vp] + [ci] * 16 + [vp] * 5
        lib.banded_dp_launch.restype = ci
        lib.banded_dp_launch_branch.argtypes = \
            [ci] + lib.banded_dp_launch.argtypes
        lib.banded_dp_launch_branch.restype = ci
        lib.banded_dp_branch.argtypes = [ci]
        lib.banded_dp_branch.restype = ci
    elif name == "tb_walk":
        lib.tb_walk_launch_branch.argtypes = \
            [ci, vp, vp, vp] + [ci] * 5 + [vp] * 3
        lib.tb_walk_launch_branch.restype = ci
        lib.smem_chase.argtypes = [ci, vp, vp]
        lib.smem_chase.restype = ci
    elif name == "pairhmm":
        lib.pairhmm_scratch_bytes.argtypes = [ci, ci]
        lib.pairhmm_scratch_bytes.restype = ctypes.c_longlong
        lib.pairhmm_viterbi_launch.argtypes = \
            [ci] * 2 + [vp] * 3 + [ci] * 3 + [cf] * 8 + [vp] * 3
        lib.pairhmm_viterbi_launch.restype = ci
    elif name == "coverage_hmm":
        lib.coverage_viterbi_launch.argtypes = [vp] * 3 + [ci] * 6 + [vp] * 3
        lib.coverage_viterbi_launch.restype = ci
        lib.coverage_posteriors_launch.argtypes = \
            [vp] * 3 + [ci] * 6 + [vp] * 2
        lib.coverage_posteriors_launch.restype = ci
        lib.viterbi_step_chase.argtypes = [vp, ci, ci, vp, vp]
        lib.viterbi_step_chase.restype = ci
    elif name == "kmer":
        cl = ctypes.c_longlong
        lib.kmer_count_launch.argtypes = [vp, vp] + [ci] * 3 + [vp, vp]
        lib.kmer_count_launch.restype = ci
        lib.kmer_count_probe_launch.argtypes = \
            [vp, vp] + [ci] * 3 + [vp, ci, vp]
        lib.kmer_count_probe_launch.restype = ci
        lib.unique_mask_launch.argtypes = [vp, ci, cl, vp, vp]
        lib.unique_mask_launch.restype = ci
        lib.kmer_vote_scratch_ints.argtypes = [ci] * 4
        lib.kmer_vote_scratch_ints.restype = cl
        lib.kmer_vote_launch.argtypes = \
            [vp, vp] + [ci] * 3 + [vp, vp, ci, vp, cl, vp, vp]
        lib.kmer_vote_launch.restype = ci
        lib.canonical_hashes_launch.argtypes = [vp, cl, ci, vp, vp]
        lib.canonical_hashes_launch.restype = ci
    elif name == "mec":
        cl = ctypes.c_longlong
        lib.mec_smem_bytes.argtypes = []
        lib.mec_smem_bytes.restype = ci
        lib.mec_sync_chase.argtypes = [ci, ci, vp, vp]
        lib.mec_sync_chase.restype = ci
        lib.mec_scratch_bytes.argtypes = [ci] * 3 + [cl]
        lib.mec_scratch_bytes.restype = cl
        lib.mec_phase_launch.argtypes = \
            [vp, ci, vp, ci, vp, cl, vp] + [ci] * 6 + [vp, cl] + [vp] * 4
        lib.mec_phase_launch.restype = ci
    elif name == "ava":
        lib.ava_hits_launch.argtypes = [vp, vp, ci, vp, vp, ci, ci] + [vp] * 4
        lib.ava_hits_launch.restype = ci
        lib.ava_read_sums_launch.argtypes = [vp, vp, ci, vp, vp]
        lib.ava_read_sums_launch.restype = ci
        lib.ava_count_launch.argtypes = [ci] * 4 + [vp] * 8
        lib.ava_count_launch.restype = ci
        lib.ava_scatter_launch.argtypes = [ci] * 4 + [vp] * 9 + [ci] + [vp] * 3
        lib.ava_scatter_launch.restype = ci
        lib.ava_sort_launch.argtypes = [vp, ci, vp, vp, vp, ci, vp]
        lib.ava_sort_launch.restype = ci
        lib.ava_dp_launch.argtypes = \
            [vp, ci] + [vp] * 4 + [ci] * 4 + [cf, ci] + [vp] * 7
        lib.ava_dp_launch.restype = ci


def load_all() -> dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library; returns name → CDLL.
    Compiler output (register and shared-memory use, from -Xptxas -v) is
    kept beside each library as `<name>.log`."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        todo = [n for n in SOURCES
                if not os.path.exists(os.path.join(out_dir, f"lib{n}.so"))]
        procs = []
        for name in todo:
            tmp = os.path.join(out_dir, f"lib{name}.so.tmp{os.getpid()}")
            log = open(os.path.join(out_dir, f"{name}.log"), "w")
            procs.append((name, tmp, log, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC, f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for name, tmp, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(name)
            else:
                os.replace(tmp, os.path.join(out_dir, f"lib{name}.so"))
        if failed:
            logs = {n: open(os.path.join(out_dir, f"{n}.log")).read()[-4000:]
                    for n in failed}
            raise RuntimeError(f"nvcc failed for {failed}: {logs}")
        for name in SOURCES:
            lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
            _configure(name, lib)
            _libs[name] = lib
        return _libs


def lib(name: str) -> ctypes.CDLL:
    return load_all()[name]


def check(rc: int, what: str, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch entry point of
    library `name`."""
    if rc != 0:
        msg = getattr(lib(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
