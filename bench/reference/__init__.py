"""Plain PyTorch references that decide ``correct``: written from the
models' equations (the JAX package's ``models/`` read as the
specification), importing neither ``jax``, the JAX package nor anything
of the port, and taking nothing the port made: they remake the weights
from the seed (``bench.weights``) and work out again whatever the port
derives from them."""
