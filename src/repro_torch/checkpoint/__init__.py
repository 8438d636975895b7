from .manager import (CheckpointCorruption, CheckpointManager, restore_pytree,
                      save_pytree)
