"""CPU tests of the benchmark harness (run from the repository's root:
`python -m pytest -q svbench/tests`).  None needs a card."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
