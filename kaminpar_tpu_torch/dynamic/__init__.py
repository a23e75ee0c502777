"""Dynamic repartitioning (own copy of kaminpar_tpu/dynamic/): graph
sessions, delta ingestion and warm-started v-cycle repartitions.

  * :mod:`.session`: :class:`GraphSession` (a mutable host graph, its
    last gate-valid partition and its delta-chain identity) and
    :class:`DeltaBatch` (validated edge, vertex and weight mutations,
    applied by a CSR patch);
  * :mod:`.repartition`: the warm/cold/replica policy, neighbour-majority
    seeding of new vertices, the drift estimate and the diff cut gate;
  * :mod:`.driver`: the ``--delta-batch`` chain driver with
    kill-and-resume chain state, synthetic churn batches and the
    ``dynamic`` report section.

Every partition comes from the facade on the card unless the caller
passes ``device="cpu"``; for the same graph, context, seed and chain it
is the JAX package's partition, bitwise.
"""

from .repartition import (  # noqa: F401
    RepartitionOutcome,
    repartition,
    seed_new_vertices,
)
from .session import DeltaBatch, GraphSession, chain_digest  # noqa: F401
from .driver import (  # noqa: F401
    load_delta_file,
    random_delta_batch,
    run_chain,
    summarize,
    synth_chain,
)
