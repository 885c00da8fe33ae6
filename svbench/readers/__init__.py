"""Per-layer metric readers, one module a kind, found by the `reader` name
in `svbench/metrics/<metric>.json`.

A reader module has `read(spec, ctx) -> float | None` and may have
`install(spec, ctx) -> undo`, which the harness calls before the traced
window.  `ctx` is a `harness.Window`: the window's jobs (each with its
stage seconds), the reference Mb they covered, the device trace's summary
and a `recorded` dict for what an installed reader records.  A reader that
finds nothing to read returns None, and the metric is left out.
"""
