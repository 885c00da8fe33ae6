from .asm import assemble_chromosome
