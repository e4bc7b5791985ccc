"""Multi-device distribution layer (mesh, shardings, collectives).

The reference has no parallel backend at all (OpenMP is stubbed out,
reference: src_cpp/bp.hpp:136-140; no MPI/NCCL anywhere) — every decode is
one syndrome on one core. Here the syndrome batch is the first-class
data-parallel axis: decode programs are pure jitted functions of
``(B, m)`` syndrome arrays, so distribution is expressed entirely through
``jax.sharding`` — place the batch axis over the mesh and XLA inserts the
(tiny) collectives for global convergence flags and statistics.
"""

from ldpc_tpu.parallel.sharding import (  # noqa: F401
    BATCH_AXIS,
    make_mesh,
    shard_batch,
    replicate,
    unshard,
    psum_tally,
)
from ldpc_tpu.parallel.distributed import (  # noqa: F401
    global_device_count,
    initialize as initialize_distributed,
    is_distributed,
    local_device_count,
    process_count,
)
from ldpc_tpu.parallel.window import (  # noqa: F401
    ROUNDS_AXIS,
    WindowDecodeResult,
    make_rounds_sharded_window_decoder,
    make_window_decoder,
)
from ldpc_tpu.parallel.tensor_parallel import (  # noqa: F401
    CODE_AXIS,
    TpBpDecoder,
    make_tp_bp_decoder,
)
from ldpc_tpu.parallel.pipeline import (  # noqa: F401
    STAGE_AXIS,
    make_pipeline_mesh,
    make_pipelined_decoder,
)

__all__ = [
    "BATCH_AXIS",
    "ROUNDS_AXIS",
    "WindowDecodeResult",
    "make_mesh",
    "shard_batch",
    "replicate",
    "unshard",
    "psum_tally",
    "make_window_decoder",
    "make_rounds_sharded_window_decoder",
    "CODE_AXIS",
    "TpBpDecoder",
    "make_tp_bp_decoder",
    "STAGE_AXIS",
    "make_pipeline_mesh",
    "make_pipelined_decoder",
    "initialize_distributed",
    "is_distributed",
    "process_count",
    "local_device_count",
    "global_device_count",
]
