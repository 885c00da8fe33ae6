from .olc import assemble_block, AssemblyResult
from .farm import run_assembly
