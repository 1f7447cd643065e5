from instruct_tpu_torch.parallel.distributed import (global_chain_mesh,
                                                     initialize_multihost)
from instruct_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "global_chain_mesh", "initialize_multihost"]
