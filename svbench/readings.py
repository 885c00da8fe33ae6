"""The control's readings: the numbers the judge gives the control's answers
(svbench/reference/control.py) on a cell's own jobs, pooled over as many
jobs as a run completes, one line a seed.  The benchmark's own runs do not
run it.

    python3 svbench/readings.py --workload <cell> --seeds 1,2,3 --jobs 5

The jobs are those a run with the same seed makes (indices 1..jobs, by the
harness's own pool).  It uses no card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    from svbench import harness
    from svbench.reference import control, judge
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--jobs", type=int, required=True)
    args = ap.parse_args(argv)
    spec = harness.load_cell(args.workload)
    answers = spec["traffic"]["answers"]
    for seed in (int(s) for s in args.seeds.split(",")):
        root = tempfile.mkdtemp(prefix="svbench-readings-")
        pool = harness.Pool(spec, seed, args.jobs + 1, root)
        try:
            counts = []
            for i in range(1, args.jobs + 1):
                job = pool.get(i)
                out = os.path.join(root, f"ctl{i}")
                control.control_outputs(job, spec["config"], [seed, i, 1],
                                        out, answers)
                counts.append(judge.judge_job(job, out, answers))
        finally:
            pool.close()
            shutil.rmtree(root, ignore_errors=True)
        numbers = judge.pool(counts)
        ok, _checks = judge.verdict(numbers, spec["limits"])
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              control=True, numbers=numbers, correct=ok)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
