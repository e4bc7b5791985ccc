"""Mesh construction and batch-axis sharding helpers.

Decode programs in this framework are pure functions of a ``(B, ...)``
batch of syndromes; all distribution is data-parallel over the batch
(SURVEY.md §2.4). These helpers build the mesh, pad + place the batch on
it, and let XLA's computation-follows-data propagation shard the whole
decode — the convergence ``all`` inside the BP while_loop and any batch
statistics become all-reduces automatically, with no hand-written
communication.

The same helpers drive single-host multi-device (one jax process, N local
devices) and multi-host pods (``jax.distributed.initialize`` +
``jax.devices()`` spanning hosts); nothing here is host-count-aware.
"""

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = BATCH_AXIS,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 1-D device mesh over the syndrome-batch axis.

    Uses all visible devices by default. A 1-D mesh is the right topology
    for this workload: the PCM and channel are tiny and replicated, the
    batch is the only large axis, and the only cross-device traffic is
    scalar convergence/statistics reductions.
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def shard_batch(
    array, mesh: Mesh, axis_name: str = BATCH_AXIS, pad_to_multiple: bool = True
):
    """Place a batch-major array on the mesh, batch axis sharded.

    Pads the batch (with zero rows — the zero syndrome decodes trivially)
    up to a multiple of the mesh size so the shard shapes are equal.
    Returns ``(sharded_array, original_batch_size)``.
    """
    arr = np.asarray(array)
    B = arr.shape[0]
    size = mesh.shape[axis_name]
    if pad_to_multiple and B % size:
        pad = size - B % size
        arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
    spec = P(axis_name, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec)), B


def replicate(array, mesh: Mesh):
    """Replicate a (small) array — PCM layout, channel LLRs — on every device."""
    return jax.device_put(jnp.asarray(array), NamedSharding(mesh, P()))


def unshard(array, batch_size: int) -> np.ndarray:
    """Gather a sharded batch result to host and strip the padding rows."""
    return np.asarray(array)[:batch_size]


def psum_tally(values, mesh: Mesh, axis_name: str = BATCH_AXIS):
    """Sum per-element tallies (fail counts, iteration counts) across the
    mesh — the distributed Monte-Carlo statistics reduction.

    ``values`` is a batch-sharded array; the result is a replicated scalar
    (XLA lowers the sum of a sharded axis to a psum).
    """
    with mesh:
        return jax.jit(
            lambda v: jnp.sum(v),
            in_shardings=NamedSharding(mesh, P(axis_name)),
            out_shardings=NamedSharding(mesh, P()),
        )(values)
