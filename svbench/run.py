"""Entry point of the benchmark of volcanosv_tpu_torch.

    python3 svbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; see svbench/harness.py.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    from svbench.harness import main
    sys.exit(main())
