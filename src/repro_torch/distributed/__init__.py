"""Multi-device serving and training over ``torch.distributed``: the serve
and training meshes and the process-wide mesh context (context.py), where
a training tree's leaves live on a training mesh (placement.py), the
serve engine's command channel from rank 0 to the other ranks
(serve_worker.py) and the EF-SignSGD vote all-reduce (compression.py)."""
from .context import (ServeMesh, TrainMesh, active_mesh, fsdp_gather,
                      gather_heads, get_mesh, reduce_from_group, serving,
                      set_mesh, vocab_embed)
