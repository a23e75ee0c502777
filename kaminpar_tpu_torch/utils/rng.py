"""Host randomness (own copy of the host half of kaminpar_tpu/utils/rng.py).

The JAX package derives host numpy Generators from a process-global seed
and a caller salt.  Here the seed is passed explicitly, so the same
(seed, salt) gives the same Generator as the JAX package after its
``set_seed(seed)``.  Device-side randomness is never drawn from a
generator: it is hashed from salts (ops/segments.hash_u32).
"""

from __future__ import annotations

import numpy as np


def host_rng(seed: int, salt: int = 0) -> np.random.Generator:
    """A numpy Generator derived from a seed and a caller salt."""
    return np.random.default_rng(np.uint64((int(seed) << 20) ^ salt))


#: The run's seed, set by the facade (the JAX package's global seed): the
#: seeded fault draws and the sampled audits key their hashes on it.
_SEED: int = 0


def set_seed(seed: int) -> None:
    global _SEED
    _SEED = int(seed)


def get_seed() -> int:
    return _SEED
