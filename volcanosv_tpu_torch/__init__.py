"""volcanosv_tpu_torch — the PyTorch/CUDA port of volcanosv_tpu.

Same configs, CLI flags and output files as the JAX package it sits beside
(`volcanosv_tpu/`, the reference it is tested against), with the device
compute in torch: hand-written CUDA kernels for Hopper under `csrc/` on a
GPU, their plain PyTorch versions on the CPU.  The package never imports
jax or volcanosv_tpu.

Every module of the JAX package has its counterpart here: the `sim`,
`asm` (with `--sd`), `qc`, `vc-large-indel`, `vc-small-indel`,
`vc-complex-sv`, `eval`, `merge-vcf` and `run` subcommands, and the
multi-process drivers over `torch.distributed` (`parallel/`).
"""

__version__ = "0.1.0"
