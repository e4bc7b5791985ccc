"""Pipeline-parallel (stage-axis) decoding tests on the virtual CPU mesh.

SURVEY.md §2.4's optional axis: BP stage -> OSD stage on disjoint device
groups, microbatches streaming through a scan with ppermute handoff.
The pipeline must be a pure reordering of work: outputs identical to the
unpipelined BP+OSD composition.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ldpc_tpu.codes import surface_code
from ldpc_tpu.ops import bp as bp_ops
from ldpc_tpu.ops import osd as osd_ops
from ldpc_tpu.ops.pcm import compile_pcm
from ldpc_tpu.parallel.pipeline import (
    make_pipeline_mesh,
    make_pipelined_decoder,
)

@pytest.fixture(scope="module")
def workload():
    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    code = surface_code(5)
    H = np.asarray(code.hx.todense(), np.uint8)
    rng = np.random.default_rng(17)
    B = 600
    errors = (rng.random((B, H.shape[1])) < 0.08).astype(np.uint8)
    syn = (errors @ H.T % 2).astype(np.uint8)
    return code, H, syn


def _reference_decode(code, syn, max_iter=12):
    """Unpipelined composition of the same stage functions."""
    graph = compile_pcm(code.hx)
    channel = np.full(graph.n, 0.08)
    bp_fn = bp_ops.make_parallel_decoder(
        graph, bp_ops.MINIMUM_SUM, max_iter, 0.625
    )
    osd_fn = osd_ops.make_osd_decoder(
        graph, channel, osd_ops.OSD_0, 0
    )
    r = bp_fn(jnp.asarray(syn), jnp.asarray(
        bp_ops.channel_llr(channel), jnp.float32))
    x0, _, _ = osd_fn(jnp.asarray(syn), r.llr_posterior)
    out = np.where(
        np.asarray(r.converged)[:, None],
        np.asarray(r.decoding),
        np.asarray(x0, np.uint8),
    )
    out[~syn.any(axis=1)] = 0
    return out


def test_pipeline_matches_unpipelined(workload):
    code, H, syn = workload
    mesh = make_pipeline_mesh()
    dec = make_pipelined_decoder(
        code.hx, 0.08, mesh=mesh, microbatch_size=128, max_iter=12
    )
    out = dec(syn)
    expected = _reference_decode(code, syn)
    assert out.shape == (syn.shape[0], H.shape[1])
    assert (out == expected).all()
    # and every row solves its syndrome
    assert ((out @ H.T) % 2 == syn).all()


def test_pipeline_stage_only_mesh(workload):
    """A bare 2-device ('stage',) mesh (no batch axis) also works."""
    from jax.sharding import Mesh

    code, H, syn = workload
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("stage",))
    dec = make_pipelined_decoder(
        code.hx, 0.08, mesh=mesh, microbatch_size=100, max_iter=12
    )
    out = dec(syn[:250])  # non-multiple of microbatch: exercises padding
    expected = _reference_decode(code, syn[:250])
    assert (out == expected).all()


def test_pipeline_rejects_bad_mesh(workload):
    from jax.sharding import Mesh

    code, _, _ = workload
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1), ("stage",))
    with pytest.raises(ValueError, match="stage"):
        make_pipelined_decoder(code.hx, 0.08, mesh=mesh)


def test_pipeline_bp_only(workload):
    """run_osd=False: stage 1 is a pass-through merge."""
    code, H, syn = workload
    mesh = make_pipeline_mesh()
    dec = make_pipelined_decoder(
        code.hx, 0.08, mesh=mesh, microbatch_size=128, max_iter=12,
        run_osd=False,
    )
    out = dec(syn)
    graph = compile_pcm(code.hx)
    bp_fn = bp_ops.make_parallel_decoder(
        graph, bp_ops.MINIMUM_SUM, 12, 0.625
    )
    r = bp_fn(jnp.asarray(syn), jnp.asarray(
        bp_ops.channel_llr(np.full(graph.n, 0.08)), jnp.float32))
    expected = np.asarray(r.decoding).copy()
    expected[~syn.any(axis=1)] = 0
    assert (out == expected).all()
