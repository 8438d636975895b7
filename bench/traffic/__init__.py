"""Traffic generators, one module a kind, found by the cell's
``traffic`` key; the mix's parameters are data in the cell's file. Every
seed gets the same multiset of sizes and gaps (drawn once from the
mix's own ``size_seed`` or spread evenly) in another order, and token ids of its own."""
import numpy as np


def shuffled(values, seed: int, salt: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 salt])
    return np.asarray(values)[rng.permutation(len(values))]


def tokens(seed: int, rid: int, n: int, vocab: int) -> np.ndarray:
    """Request ``rid``'s prompt: ``n`` token ids drawn from the seed."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 7, rid])
    return rng.integers(0, vocab, size=n, dtype=np.int32)
