from .flagger import (CoverageHMM, FlaggerResult, contig_coverage_windows,
                      evaluate_assembly)

__all__ = ["CoverageHMM", "FlaggerResult", "contig_coverage_windows",
           "evaluate_assembly"]
