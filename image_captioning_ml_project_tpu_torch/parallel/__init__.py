from .mesh import (Mesh, batch_rows, create_mesh, gather_rows_host,
                   init_distributed, mesh_shape, replicate)
from .sharding import (GPT2_TP_RULES, gather_params, infer_param_shardings,
                       shard_params, tensor_parallel)
