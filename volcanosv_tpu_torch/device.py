"""The torch device the port's entry points run on.

Every public entry point takes `device` (a name or a `torch.device`) with
default `"cuda"` and passes it through `resolve_device` before it does any
work: asking for CUDA on a host without it raises, there is no quiet move
to the CPU.  CPU runs (the tests, `--device cpu`) ask for it by name."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """`device` → torch.device; raises RuntimeError when CUDA is asked for
    and absent, ValueError for a device type other than cuda or cpu."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: CUDA is not available")
    elif dev.type != "cpu":
        raise ValueError(f"device {device}: only cuda and cpu are supported")
    return dev
