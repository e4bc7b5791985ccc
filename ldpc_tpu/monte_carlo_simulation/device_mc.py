"""Device-resident Monte-Carlo decoding pipeline.

The reference's central workload is Monte-Carlo logical-error-rate
estimation: sample a BSC error, compute its syndrome, decode, compare
(reference: src_python/ldpc/monte_carlo_simulation/mcs.py:106-149 and
python_test/test_qcodes.py:33-92). Its loop runs one syndrome at a time
through C++. Here the WHOLE pipeline lives on the accelerator:

    keys -> bernoulli errors -> syndromes (0/1 matmul) -> phase-1 BP
         -> top-K compaction -> full-depth BP -> OSD-0 -> logical check
         -> counter psum

Several rounds run inside one jitted call (``lax.fori_loop``), so a
single scalar-sized host pull amortises over millions of syndromes —
the benchmark headline.

Multi-chip: the per-round batch is sharded over the mesh ``batch`` axis
by ``shard_map`` in :mod:`ldpc_tpu.parallel` users; counters are plain
sums so they psum cleanly.
"""

from typing import Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ldpc_tpu.helpers import convert_to_binary_sparse
from ldpc_tpu.ops import bp as bp_ops
from ldpc_tpu.ops.pcm import compile_pcm


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def make_mc_decoder_step(
    pcm,
    error_rate: float,
    *,
    logicals=None,
    batch_size: int = 16384,
    rounds_per_call: int = 8,
    max_iter: int = 30,
    bp_method: str = "minimum_sum",
    ms_scaling_factor: float = 0.625,
    osd_method: str = "osd_0",
    bucket_fraction: int = 8,
    phase1_iters: Optional[int] = None,
):
    """Build a jitted Monte-Carlo step ``fn(key) -> counters``.

    Per call: ``rounds_per_call`` rounds of ``batch_size`` samples each.
    Counters (int32): [runs, decode_fails, bp_converged, bp_iters_total,
    osd_used, bucket_overflow]. ``decode_fails`` is logical failures when
    ``logicals`` is given (quantum LER, lx @ residual != 0), else
    word-error failures (decoding != error, the classical criterion of
    mcs.py:137-141). ``bucket_overflow`` counts BP-failed samples that
    did not fit the OSD bucket (kept their BP output — conservatively
    counted in the failure statistics); a non-zero value means
    ``bucket_fraction`` should be lowered.

    Two-phase BP: a short full-batch pass (``phase1_iters``, default
    ``min(max_iter, 6)``) filters the easy lanes, then the compacted
    non-converged bucket re-runs BP from scratch at full ``max_iter``
    before OSD. Per-lane BP trajectories are deterministic, so bucket
    lanes reproduce exactly what one full-depth run would give them and
    converged lanes already hold their final (frozen) output — results
    are identical to single-phase except for bucket overflow, which the
    overflow counter reports. With most lanes converging in a few
    iterations this removes the straggler-serialised tail that otherwise
    forces every batch tile to run all ``max_iter`` iterations.
    Set ``phase1_iters=max_iter`` (or ``>=``) to disable.
    """
    pcm = convert_to_binary_sparse(pcm)
    graph = compile_pcm(pcm)
    m, n = graph.m, graph.n
    B = _round_up(batch_size, 512)
    K = min(B, max(128, _round_up(B // bucket_fraction, 128)))
    channel = np.full(n, error_rate)
    init_llr = jnp.asarray(bp_ops.channel_llr(channel))
    H = jnp.asarray(graph.dense.astype(np.float32))  # (m, n) 0/1 syndrome map
    p = jnp.asarray(channel, jnp.float32)
    L = (
        jnp.asarray(
            np.asarray(
                convert_to_binary_sparse(logicals).todense(), np.float32
            )
        )
        if logicals is not None
        else None
    )

    method = bp_ops.MINIMUM_SUM if str(bp_method).lower() in (
        "ms",
        "min_sum",
        "minimum_sum",
        "1",
    ) else bp_ops.PRODUCT_SUM
    run_osd = str(osd_method).lower() not in ("off", "osd_off", "-1")
    if phase1_iters is None:
        phase1_iters = min(max_iter, 6)
    two_phase = phase1_iters < max_iter

    from ldpc_tpu.ops import osd as osd_ops

    bp_fn = bp_ops.make_parallel_decoder(
        graph, method, phase1_iters if two_phase else max_iter,
        ms_scaling_factor
    )
    bp2_fn = (
        bp_ops.make_parallel_decoder(graph, method, max_iter, ms_scaling_factor)
        if two_phase
        else None
    )
    osd_fn = (
        osd_ops.make_osd_decoder(graph, channel, osd_ops.OSD_0, 0)
        if run_osd
        else None
    )

    # named scopes label each stage's device kernels in a profiler trace
    def one_round(key):
        with jax.named_scope("sample"):
            u = jax.random.uniform(key, (B, n), jnp.float32)
            errors = (u < p[None, :]).astype(jnp.uint8)
            syn_f32 = jnp.dot(
                errors.astype(jnp.float32), H.T,
                preferred_element_type=jnp.float32,
            )
            syn = (syn_f32 - 2.0 * jnp.floor(syn_f32 * 0.5)).astype(jnp.uint8)
        with jax.named_scope("phase1_bp"):
            bp = bp_fn(syn, init_llr)
        conv = bp.converged
        iters = bp.iterations
        nfail_p1 = (~conv).sum().astype(jnp.int32)
        if two_phase or osd_fn is not None:
            with jax.named_scope("compact"):
                order = jnp.argsort(conv, stable=True)  # failed first
                idx = order[:K]
                syn_sub = jnp.take(syn, idx, axis=0)
            if two_phase:
                with jax.named_scope("bucket_bp"):
                    bp2 = bp2_fn(syn_sub, init_llr)
                sub_dec, sub_conv = bp2.decoding, bp2.converged
                sub_llr, sub_iters = bp2.llr_posterior, bp2.iterations
            else:
                sub_dec = jnp.take(bp.decoding, idx, axis=0)
                sub_conv = jnp.take(conv, idx)
                sub_llr = jnp.take(bp.llr_posterior, idx, axis=0)
                sub_iters = jnp.take(iters, idx)
            if osd_fn is not None:
                with jax.named_scope("osd0"):
                    x0, _, _ = osd_fn(syn_sub, sub_llr)
                merged = jnp.where(sub_conv[:, None], sub_dec, x0)
            else:
                merged = sub_dec
            with jax.named_scope("merge"):
                decoding = bp.decoding.at[idx].set(merged)
                conv = conv.at[idx].set(sub_conv)
                iters = iters.at[idx].set(sub_iters)
        else:
            decoding = bp.decoding
        residual = errors ^ decoding
        if L is not None:  # logical check: 0/1 matmul, exact at any precision
            lf32 = jnp.dot(
                residual.astype(jnp.float32),
                L.T,
                preferred_element_type=jnp.float32,
            )
            lpar = lf32 - 2.0 * jnp.floor(lf32 * 0.5)
            fail = (lpar > 0.5).any(axis=1)
        else:
            fail = residual.any(axis=1)
        nfail_bp = (~conv).sum().astype(jnp.int32)
        return jnp.stack(
            [
                jnp.int32(B),
                fail.sum().astype(jnp.int32),
                conv.sum().astype(jnp.int32),
                iters.sum().astype(jnp.int32),
                nfail_bp,
                jnp.maximum(nfail_p1 - K, 0),
            ]
        )

    def step(key):
        def body(i, acc):
            counters = one_round(jax.random.fold_in(key, i))
            return acc + counters

        return jax.lax.fori_loop(
            0, rounds_per_call, body, jnp.zeros(6, jnp.int32)
        )

    return jax.jit(step), B * rounds_per_call


def make_sharded_mc_step(
    pcm,
    error_rate: float,
    *,
    mesh=None,
    batch_size_per_device: int = 16384,
    **kwargs,
):
    """Multi-device Monte-Carlo step: data-parallel over the mesh
    ``batch`` axis via ``jax.shard_map``; every device runs the full
    pipeline on its own PRNG stream and the counters ride one psum.

    Returns ``(step, runs_per_call)`` where ``step(key)`` -> replicated
    (6,) int32 counters. Scaling is embarrassingly parallel — the PCM
    and channel are replicated, no per-sample communication exists
    (SURVEY.md §2.4's data-parallel plan).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ldpc_tpu.parallel import BATCH_AXIS, make_mesh

    if mesh is None:
        mesh = make_mesh()
    axis = BATCH_AXIS if BATCH_AXIS in mesh.axis_names else mesh.axis_names[0]
    ndev = mesh.shape[axis]
    local_step, runs_local = make_mc_decoder_step(
        pcm, error_rate, batch_size=batch_size_per_device, **kwargs
    )

    def sharded(keydata):  # (ndev, key_words) uint32, sharded over mesh
        counters = local_step(jax.random.wrap_key_data(keydata[0]))
        return jax.lax.psum(counters, axis)

    fn = jax.jit(
        jax.shard_map(
            sharded,
            mesh=mesh,
            in_specs=P(axis),
            out_specs=P(),
            check_vma=False,
        )
    )

    def step(key):
        # raw uint32 key words (typed key arrays can't cross
        # make_array_from_callback); every process computes the same
        # global split, each materialising only its addressable shards
        kd = np.asarray(jax.random.key_data(jax.random.split(key, ndev)))
        sh = NamedSharding(mesh, P(axis))
        if jax.process_count() > 1:
            keys = jax.make_array_from_callback(
                kd.shape, sh, lambda idx: kd[idx]
            )
        else:
            keys = jax.device_put(kd, sh)
        return fn(keys)

    return step, runs_local * ndev


class DeviceMonteCarlo:
    """Accelerator-resident Monte-Carlo LER estimator with checkpointing.

    ``run(target_runs)`` decodes at least ``target_runs`` samples and
    returns the tallies; ``checkpoint()``/``restore()`` serialise the
    counters + PRNG position for exact resume (the fault-tolerance
    contract the reference defers to sinter, SURVEY.md §5).
    """

    def __init__(self, pcm, error_rate: float, seed: int = 0, **kwargs):
        self._step, self.runs_per_call = make_mc_decoder_step(
            pcm, error_rate, **kwargs
        )
        self.seed = seed
        self.calls = 0
        self.counters = np.zeros(6, np.int64)

    def run(self, target_runs: int) -> Dict:
        while self.counters[0] < target_runs:
            out = self._step(jax.random.fold_in(jax.random.key(self.seed), self.calls))
            self.calls += 1
            self.counters += np.asarray(out, np.int64)
        runs, fails, conv, iters, osd_used, overflow = map(int, self.counters)
        return {
            "run_count": runs,
            "fail_count": fails,
            "logical_error_rate": fails / runs if runs else 0.0,
            "bp_converged": conv,
            "bp_iters_total": iters,
            "osd_used": osd_used,
            "bucket_overflow": overflow,
        }

    def checkpoint(self) -> Dict:
        return {
            "seed": self.seed,
            "calls": self.calls,
            "counters": self.counters.tolist(),
        }

    def restore(self, state: Dict) -> None:
        self.seed = int(state["seed"])
        self.calls = int(state["calls"])
        self.counters = np.asarray(state["counters"], np.int64)
        if self.counters.size == 5:  # pre-overflow-counter checkpoints
            self.counters = np.concatenate([self.counters, [0]])
