"""One job of the pool, in a process of its own:

    python3 -m svbench.gen.worker <spec.json> <seed> <index> <job_dir>

reads the configuration and traffic from spec.json, writes the job's
inputs under job_dir (recipe.make_job) and its truth as job_dir/truth.json.
"""
import json
import os
import sys

from . import recipe


def main(argv) -> int:
    spec_path, seed, index, job_dir = argv
    with open(spec_path) as fh:
        spec = json.load(fh)
    job = recipe.make_job(spec["config"], spec["traffic"], int(seed),
                          int(index), job_dir)
    tmp = os.path.join(job_dir, "truth.json.part")
    with open(tmp, "w") as fh:
        json.dump(job, fh)
    os.replace(tmp, os.path.join(job_dir, "truth.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
