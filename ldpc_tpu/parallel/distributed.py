"""Multi-host initialization harness.

The reference has no distributed backend at all (SURVEY.md §2.4: OpenMP
stubbed out, no MPI/NCCL). Across hosts, execution is one SPMD program
per host process over a global device set; the only
host-side plumbing needed is `jax.distributed.initialize` with a
coordinator rendezvous. This module wraps that with environment
autodetection so the same Monte-Carlo / decode scripts run unchanged on:

- one host, N local devices (no-op),
- a cluster whose scheduler JAX auto-detects (coordinator found by
  ``jax.distributed.initialize``),
- a generic cluster via explicit ``LDPC_TPU_COORDINATOR`` /
  ``LDPC_TPU_NUM_PROCESSES`` / ``LDPC_TPU_PROCESS_ID`` env vars.

After :func:`initialize`, ``jax.devices()`` spans every host and the
meshes built by :func:`ldpc_tpu.parallel.make_mesh` (and the sharded MC
/ QSS / window steps) place data over every host: the collectives are
inserted by XLA from the sharding annotations (NCCL on GPUs), never
hand-rolled transport.
"""

import os
from typing import Optional

import jax

_ENV_COORD = "LDPC_TPU_COORDINATOR"
_ENV_NPROC = "LDPC_TPU_NUM_PROCESSES"
_ENV_PID = "LDPC_TPU_PROCESS_ID"

_initialized = False


def is_distributed() -> bool:
    """True once :func:`initialize` has set up multi-process JAX."""
    return _initialized


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> int:
    """Idempotently initialize multi-host JAX; returns the process id.

    Resolution order for each parameter: explicit argument ->
    ``LDPC_TPU_*`` environment variable -> runtime autodetection
    (`jax.distributed.initialize` with no args, which understands
    common cluster schedulers). On a single
    host with no coordinator configured this is a no-op returning 0.
    """
    global _initialized
    if _initialized:
        return jax.process_index()

    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if num_processes is None and _ENV_NPROC in os.environ:
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and _ENV_PID in os.environ:
        process_id = int(os.environ[_ENV_PID])

    if coordinator_address is None and num_processes is None:
        # single host: nothing to rendezvous
        return jax.process_index()

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    _initialized = True
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()


def local_device_count() -> int:
    return jax.local_device_count()


def global_device_count() -> int:
    return jax.device_count()
