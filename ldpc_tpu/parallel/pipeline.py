"""Pipeline parallelism: BP stage and OSD stage on disjoint device groups.

SURVEY.md §2.4 lists pipeline parallelism as the one optional distribution
axis: "BP stage -> postprocess (OSD/LSD) stage on disjoint device groups".
The default framework configuration keeps both stages on every device with
a compaction step between them (``device_mc.make_mc_decoder_step``,
``BpOsdDecoder.decode_batch``) — that is usually the right call because BP
and OSD-0 have comparable per-batch cost and splitting them idles half the
machine during ramp-up. This module provides the true pipelined variant
for deployments where the two stages run on *heterogeneous* device pools
(e.g. BP on most devices, the control-flow-heavy GF(2) elimination on a
smaller pool) or where per-stage working sets individually exceed one
device's memory.

Design (GPipe-style, SPMD over a ``stage`` mesh axis of size 2):

- Microbatches of syndromes stream through a ``lax.scan``. At step ``t``
  stage-0 devices run batched BP on microbatch ``t`` while stage-1
  devices run OSD + merge on microbatch ``t-1`` — both under
  ``lax.cond`` on ``lax.axis_index("stage")``, so each device executes
  only its stage's work.
- The inter-stage payload (syndrome, BP posterior LLRs, BP decoding,
  convergence flag — one packed f32 buffer) moves stage 0 -> stage 1 via
  one ``lax.ppermute`` per step.
- A ``batch`` mesh axis can be combined with ``stage``: microbatches are
  data-parallel within each stage group, and the ppermute pairs devices
  with equal batch coordinates.
- The final decodings are valid on stage-1 devices; one masked ``psum``
  over the stage axis replicates them for collection (a real deployment
  would DMA from the stage-1 hosts instead).

Results are element-for-element identical to the unpipelined decode: the
stages are pure functions and the pipeline only reorders *when* each
microbatch is processed, never what is computed (no reference analogue —
the reference is single-threaded end to end, SURVEY.md §2.4).
"""

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ldpc_tpu.helpers import convert_to_binary_sparse
from ldpc_tpu.ops import bp as bp_ops
from ldpc_tpu.ops import osd as osd_ops
from ldpc_tpu.ops.pcm import compile_pcm

STAGE_AXIS = "stage"


def make_pipeline_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A ``(stage=2, batch=D/2)`` mesh over the visible devices."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    devices = np.asarray(devices)
    if devices.size % 2:
        devices = devices[: devices.size - devices.size % 2]
    if devices.size < 2:
        raise ValueError("pipeline parallelism needs at least 2 devices")
    return Mesh(devices.reshape(2, -1), (STAGE_AXIS, "batch"))


def make_pipelined_decoder(
    pcm,
    error_rate: float,
    *,
    mesh: Optional[Mesh] = None,
    microbatch_size: int = 256,
    max_iter: int = 30,
    bp_method: str = "minimum_sum",
    ms_scaling_factor: float = 0.625,
    run_osd: bool = True,
):
    """Build ``decode(syndromes: (B, m) uint8) -> (B, n) uint8`` where BP
    and OSD-0 run as a two-stage device pipeline over ``mesh``.

    ``mesh`` must have a ``stage`` axis of size 2 (see
    :func:`make_pipeline_mesh`); an optional ``batch`` axis adds data
    parallelism within each stage group. ``microbatch_size`` is the
    global per-step batch (must divide by the batch-axis size).
    """
    if mesh is None:
        mesh = make_pipeline_mesh()
    if STAGE_AXIS not in mesh.axis_names or mesh.shape[STAGE_AXIS] != 2:
        raise ValueError("mesh must have a 'stage' axis of size 2")
    batch_axes = tuple(a for a in mesh.axis_names if a != STAGE_AXIS)
    nbatch = int(np.prod([mesh.shape[a] for a in batch_axes])) if batch_axes else 1
    if microbatch_size % nbatch:
        raise ValueError(
            f"microbatch_size {microbatch_size} must divide by the "
            f"batch-axis size {nbatch}"
        )

    pcm = convert_to_binary_sparse(pcm)
    graph = compile_pcm(pcm)
    m, n = graph.m, graph.n
    channel = np.full(n, error_rate)
    init_llr = jnp.asarray(
        bp_ops.channel_llr(channel), jnp.float32
    )
    method = bp_ops.MINIMUM_SUM if str(bp_method).lower() in (
        "ms", "min_sum", "minimum_sum", "1",
    ) else bp_ops.PRODUCT_SUM

    bp_fn = bp_ops.make_parallel_decoder(
        graph, method, max_iter, ms_scaling_factor
    )
    if run_osd:
        _osd = osd_ops.make_osd_decoder(graph, channel, osd_ops.OSD_0, 0)
    W = m + 2 * n + 1  # payload: syn | llr | bp decoding | conv

    def bp_stage(syn_t):
        r = bp_fn(syn_t, init_llr)
        return jnp.concatenate(
            [
                syn_t.astype(jnp.float32),
                r.llr_posterior.astype(jnp.float32),
                r.decoding.astype(jnp.float32),
                r.converged.astype(jnp.float32)[:, None],
            ],
            axis=1,
        )

    def osd_stage(buf):
        syn_p = jnp.round(buf[:, :m]).astype(jnp.uint8)
        llr_p = buf[:, m : m + n]
        dec_p = jnp.round(buf[:, m + n : m + 2 * n]).astype(jnp.uint8)
        conv_p = buf[:, m + 2 * n] > 0.5
        if run_osd:
            x0, _, _ = _osd(syn_p, llr_p)
            out = jnp.where(conv_p[:, None], dec_p, x0.astype(jnp.uint8))
        else:
            out = dec_p
        return out * syn_p.any(axis=1)[:, None].astype(jnp.uint8)

    def spmd(syn_mb):  # (T, mb_local, m) on each device
        stage = jax.lax.axis_index(STAGE_AXIS)
        mb_local = syn_mb.shape[1]

        def scan_step(buf, syn_t):
            payload = jax.lax.cond(
                stage == 0,
                lambda: bp_stage(syn_t),
                lambda: jnp.zeros((mb_local, W), jnp.float32),
            )
            result = jax.lax.cond(
                stage == 1,
                lambda: osd_stage(buf),
                lambda: jnp.zeros((mb_local, n), jnp.uint8),
            )
            buf_next = jax.lax.ppermute(
                payload, STAGE_AXIS, perm=[(0, 1)]
            )
            return buf_next, result

        buf0 = jnp.zeros((mb_local, W), jnp.float32)
        _, ys = jax.lax.scan(scan_step, buf0, syn_mb)
        # ys[t] is microbatch t-1's result, valid on stage-1 devices only;
        # one masked psum replicates it so every device returns the answer
        mask = (stage == 1).astype(jnp.int32)
        out = jax.lax.psum(ys.astype(jnp.int32) * mask, STAGE_AXIS)
        return out[1:].astype(jnp.uint8)  # drop the ramp-up step

    batch_spec = batch_axes[0] if batch_axes else None
    shard = jax.jit(
        jax.shard_map(
            spmd,
            mesh=mesh,
            in_specs=P(None, batch_spec, None),
            out_specs=P(None, batch_spec, None),
            check_vma=False,
        )
    )

    def decode(syndromes: np.ndarray) -> np.ndarray:
        syndromes = np.atleast_2d(np.asarray(syndromes, np.uint8))
        B0 = syndromes.shape[0]
        if syndromes.shape[1] != m:
            raise ValueError(
                f"syndromes must have shape (batch, {m}), "
                f"not {syndromes.shape}"
            )
        mb = microbatch_size
        T = -(-B0 // mb)
        pad = T * mb - B0
        if pad:
            syndromes = np.concatenate(
                [syndromes, np.zeros((pad, m), np.uint8)]
            )
        syn_mb = syndromes.reshape(T, mb, m)
        # trailing zero microbatch flushes the last payload through stage 1
        syn_mb = np.concatenate(
            [syn_mb, np.zeros((1, mb, m), np.uint8)]
        )
        dev = jax.device_put(
            jnp.asarray(syn_mb),
            NamedSharding(mesh, P(None, batch_spec, None)),
        )
        out = np.asarray(shard(dev)).reshape(T * mb, n)
        return out[:B0]

    return decode
