from .mesh import (make_mesh, MeshAxes, init_multihost,
                   host_chromosome_shard)
from .step import sharded_align_step, build_sharded_align_step
