"""Tensor-parallel serving over ``torch.distributed``: the serve mesh and
its process-wide context (context.py) and the engine's command channel
from rank 0 to the other ranks (serve_worker.py). The training half of the
JAX package's ``distributed/`` (1-bit EF-SignSGD compression) comes with
the multi-device training slice."""
from .context import (ServeMesh, active_mesh, get_mesh, serving, set_mesh)
