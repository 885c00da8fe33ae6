from .pileup import PileupResult, pileup_chromosome
from .phase import PhaseResult, phase_chromosome
from .snp_vcf import snp_vcf_records
