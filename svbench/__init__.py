"""The benchmark of volcanosv_tpu_torch (see harness.py)."""
