from .pack import (
    encode_seq, decode_codes, revcomp_codes, pad_codes, CODE_A, CODE_C,
    CODE_G, CODE_T, CODE_N,
)
from .kmer import kmer_hashes_np, kmer_hashes, count_kmers_dense, canonical_hashes
from .minimizer import MinimizerIndex, sketch_np, mix32_np
