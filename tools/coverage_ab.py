"""Time variants of csrc/coverage_hmm.cu against the checkout's, in turns.

Each `--other` file is a variant of `volcanosv_tpu_torch/csrc/coverage_hmm.cu`
with the same C interface.  The checkout's source and every variant are built
with the port's nvcc flags into `build/coverage_ab/`.  Both coverage kernels
of each build are then launched at the splits of `qc/flagger.py`'s plans on
four batches:
- chip_smoke.py's chromosome-scale batch, (B, T, S) = (190, 4970, 4);
- qc's launch shape (28, 877, 4), on tie-rich inputs;
- (9, 4915, S) at S 2 and 8, on random emissions.

The labels of every build must equal the checkout's; the posteriors' largest
difference from the checkout's is printed.  One JSON line a batch gives the
device ms a call of each build's Viterbi and forward-backward, timed in turns
(chip_smoke.py::_time_turns), twice.  Needs one card and nvcc.

Usage: python3 tools/coverage_ab.py --other variant.cu [--other ...]
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _build(paths: dict) -> dict:
    """name -> source path, built in parallel: name -> configured CDLL."""
    from volcanosv_tpu_torch.ops import cuda_build
    out = os.path.join(REPO, "build", "coverage_ab")
    os.makedirs(out, exist_ok=True)
    procs = {n: subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
         os.path.join(out, f"lib{n}.so"), p], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n, p in paths.items()}
    libs = {}
    for n, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {paths[n]}: {log[-4000:]}")
        libs[n] = ctypes.CDLL(os.path.join(out, f"lib{n}.so"))
        cuda_build._configure("coverage_hmm", libs[n])
    return libs


def _batches() -> dict:
    """name -> (emit, logA, logpi) on the card."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from volcanosv_tpu_torch.config import PipelineConfig
    from volcanosv_tpu_torch.qc import flagger
    cov, valid, _lens = cs._coverage_case(0)
    hmm = flagger.CoverageHMM.from_lambda(
        cs.HMM_LAM, PipelineConfig.for_dtype("Hifi").qc.n_states)
    out = {"chromosome": hmm._emissions(cov, valid, torch.device("cuda"))}
    means, tau, cov, valid = cs._hmm_tie_case(np.random.default_rng(26), 4,
                                              28, 877)
    out["qc"] = flagger.CoverageHMM(means=means, tau=tau)._emissions(
        cov, valid, torch.device("cuda"))
    for S in (2, 8):
        rng = np.random.default_rng(S)
        emit = (rng.standard_normal((4915, 9, S)) * 4).astype(np.float32)
        logA = np.log(rng.dirichlet(np.ones(S), S)).astype(np.float32)
        logpi = np.full(S, np.log(1.0 / S), np.float32)
        out[f"S{S}"] = tuple(torch.tensor(x, device="cuda")
                             for x in (emit, logA, logpi))
    return out


def _launchers(libs: dict, emit: tuple):
    """Per build, a Viterbi and a forward-backward launch at the plans'
    splits, and the outputs they write."""
    import torch

    from volcanosv_tpu_torch.ops import cuda_build
    from volcanosv_tpu_torch.qc import flagger
    T, B, S = emit[0].shape
    vp, pp = flagger.viterbi_plan(B, T, S), flagger.coverage_plan(B, T, S)
    scratch = torch.empty(vp.scratch, dtype=torch.uint8, device="cuda") \
        if vp.scratch else None
    ptrs = [x.data_ptr() for x in emit]
    outs, vit, post = {}, {}, {}
    for n, lib in libs.items():
        lab = torch.empty((B, T), dtype=torch.int8, device="cuda")
        out = torch.empty((T, B, S), dtype=torch.float32, device="cuda")
        outs[n] = (lab, out)

        def v(lib=lib, lab=lab):
            cuda_build.check(lib.coverage_viterbi_launch(
                *ptrs, B, T, S, vp.seg, vp.segs, vp.contigs,
                scratch.data_ptr() if scratch is not None else None,
                lab.data_ptr(), torch.cuda.current_stream().cuda_stream),
                "coverage_viterbi launch", "coverage_hmm")

        def p(lib=lib, out=out):
            cuda_build.check(lib.coverage_posteriors_launch(
                *ptrs, B, T, S, pp.seg, pp.segs, pp.contigs, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream),
                "coverage_posteriors launch", "coverage_hmm")
        vit[n], post[n] = v, p
    return vit, post, outs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", action="append", required=True,
                    help="a variant of coverage_hmm.cu (repeatable)")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from volcanosv_tpu_torch.ops import cuda_build
    if not torch.cuda.is_available():
        print("coverage_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    paths = {"checkout": os.path.join(cuda_build.CSRC, "coverage_hmm.cu")}
    paths.update({os.path.basename(p): os.path.abspath(p)
                  for p in args.other})
    libs = _build(paths)
    for name, emit in _batches().items():
        vit, post, outs = _launchers(libs, emit)
        for fn in list(vit.values()) + list(post.values()):
            fn()
        torch.cuda.synchronize()
        lab0, out0 = outs["checkout"]
        if not all(torch.equal(lab0, lab) for lab, _ in outs.values()):
            raise AssertionError(f"coverage_ab: labels differ at {name}")
        row = dict(batch=name, shape=list(emit[0].shape),
                   posteriors_max_diff=max(float((out - out0).abs().max())
                                           for _, out in outs.values()))
        for rep in range(2):
            row[f"viterbi_ms_{rep}"] = cs._time_turns(vit)
            row[f"posteriors_ms_{rep}"] = cs._time_turns(post)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
