"""Benchmark: batched BP+OSD syndromes/s on a d=13 surface code vs the
reference C++ decoder (BASELINE.md north-star workload).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "syndromes/s", "vs_baseline": N}

Headline = the device-resident Monte-Carlo pipeline
(`monte_carlo_simulation.DeviceMonteCarlo`): sample -> syndrome -> BP ->
OSD-0 -> logical check, all on the GPU — the reference's central workload
(its MC/sinter loops also decode memory-resident syndromes; neither side
pays host-link costs). The host-boundary `BpOsdDecoder.decode_batch` rate
(host<->device transfers included) is reported as a secondary field. The
baseline is the reference C++ BP+OSD measured on this machine via
``native/bench_baseline.cpp`` compiled against the reference headers; if
the reference tree or toolchain is absent, a recorded fallback baseline
is used and flagged in the JSON. The JSON names the device (platform,
device kind and count) and the card's name and power limit; without a
GPU the script fails.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

DISTANCE = 13
ERROR_RATE = 0.01
MAX_ITER = 30
MS_FACTOR = 0.625
BATCH = 65536
TIMED_ROUNDS = 7  # median of rounds
BASELINE_SYNDROMES = 3000
# recorded single-core reference rate on this machine class (c.f. commit log)
FALLBACK_BASELINE_RATE = 9000.0

REF = "/root/reference"


def build_workload():
    from ldpc_tpu.codes import surface_code

    code = surface_code(DISTANCE)
    H = np.asarray(code.hx.todense(), dtype=np.uint8)
    rng = np.random.default_rng(7)
    errors = (rng.random((BATCH, H.shape[1])) < ERROR_RATE).astype(np.uint8)
    syndromes = (errors @ H.T % 2).astype(np.uint8)
    return code, H, errors, syndromes


def measure_host_boundary(code, H, syndromes):
    from ldpc_tpu import BpOsdDecoder

    dec = BpOsdDecoder(
        code.hx,
        error_rate=ERROR_RATE,
        max_iter=MAX_ITER,
        bp_method="minimum_sum",
        ms_scaling_factor=MS_FACTOR,
        schedule="parallel",
        osd_method="osd_0",
        osd_order=0,
    )
    out = dec.decode_batch(syndromes)  # warmup + compile
    assert ((out @ H.T) % 2 == syndromes).all(), "decode invalid"
    dec.decode_batch(syndromes)  # settle: absorb the one adaptive-bucket
    # recompile the warmup's learned failure-fraction hints can trigger
    times = []
    for _ in range(TIMED_ROUNDS):
        t0 = time.perf_counter()
        dec.decode_batch(syndromes)
        times.append(time.perf_counter() - t0)
    times.sort()
    dt = times[len(times) // 2]  # median round
    return syndromes.shape[0] / dt, syndromes.shape[0] / times[0]


def measure_baseline(H, syndromes, error_rate=ERROR_RATE):
    """Best-of-5 reference C++ BP+OSD-0 rate via the shared driver
    (ldpc_tpu.utils.reference_baseline — the single build path that also
    carries the mbp.hpp compile shim)."""
    from ldpc_tpu.utils import reference_baseline as rb

    if rb.build_binary() is None:
        return FALLBACK_BASELINE_RATE, "fallback(reference unavailable)"
    syn = syndromes[:BASELINE_SYNDROMES]
    try:
        stdin = rb.make_input(H, [error_rate] * H.shape[1], syn)
        # best-of-5: the single-core C++ rate dips up to 3x under
        # concurrent host load; the fastest run is the honest baseline
        rate = rb.best_rate(
            stdin, len(syn), reps=5, max_iter=MAX_ITER,
            ms_factor=MS_FACTOR, osd_method=0, osd_order=0, timeout=600,
        )
        return rate, "measured"
    except Exception as exc:
        return FALLBACK_BASELINE_RATE, f"fallback(run failed: {exc})"


# min-sum edge update cost: check->bit two-pass min/sign + bit->check
# accumulate + LLR/harddec, ~14 fused flop-equivalents per edge per iter
FLOPS_PER_EDGE_ITER = 14.0


def measure_device_mc():
    """The device-resident MC pipeline (sample+decode+check on chip)."""
    import jax
    from ldpc_tpu.codes import surface_code
    from ldpc_tpu.monte_carlo_simulation import make_mc_decoder_step

    code = surface_code(DISTANCE, compute_logicals=True)
    step, runs_per_call = make_mc_decoder_step(
        code.hx,
        ERROR_RATE,
        logicals=code.lx,
        batch_size=16384,
        rounds_per_call=64,
        max_iter=MAX_ITER,
        ms_scaling_factor=MS_FACTOR,
        # 3 cheap full-batch iterations before straggler compaction: at this
        # workload the counters (fails/converged/iters/osd_used, overflow 0)
        # are bit-identical to single-phase max_iter=30 — measured, see
        # tests/test_device_mc.py two-phase equality — while cutting wall
        # time ~15% vs the default 6 (phase-1 trips dominate).
        phase1_iters=3,
    )
    out = step(jax.random.key(0))  # warmup + compile
    counters = list(map(int, out))
    assert counters[0] == runs_per_call and counters[5] == 0, counters
    times = []
    for i in range(TIMED_ROUNDS):
        t0 = time.perf_counter()
        jax.block_until_ready(step(jax.random.key(i + 1)))
        times.append(time.perf_counter() - t0)
    times.sort()
    dt = times[len(times) // 2]
    # achieved BP edge-message flops: an absolute rate, independent of
    # the C++ baseline's host-load noise (counters[3] = total BP
    # iterations actually run; phase-1 iterations run for the whole
    # batch each call)
    nnz = int(code.hx.nnz)
    total_edge_iters = (counters[3] + 3 * runs_per_call) * nnz
    flops = total_edge_iters * FLOPS_PER_EDGE_ITER
    tflops = flops / dt / 1e12
    return runs_per_call / dt, {
        "bp_tflops": round(tflops, 2),
        "bp_edge_iters_per_call": total_edge_iters,
    }


def measure_hgp400():
    """Second headline workload: device-MC + host-boundary decode on the
    reference's flagship [[400,16,6]] HGP code
    (python_test/test_qcodes.py:95-160) with its own matched C++
    baseline, so throughput evidence is not d=13-only. Returns {} when
    the reference PCM fixture (data, not code) is unavailable."""
    try:
        import scipy.sparse

        pcms = os.path.join(REF, "python_test", "pcms")
        hx = scipy.sparse.load_npz(
            os.path.join(pcms, "hx_400_16_6.npz")
        ).tocsr()
        lx = scipy.sparse.load_npz(
            os.path.join(pcms, "lx_400_16_6.npz")
        ).tocsr()
    except Exception:
        return {}
    try:
        import jax

        from ldpc_tpu import BpOsdDecoder
        from ldpc_tpu.monte_carlo_simulation import make_mc_decoder_step

        step, runs_per_call = make_mc_decoder_step(
            hx,
            ERROR_RATE,
            logicals=lx,
            batch_size=16384,
            rounds_per_call=32,
            max_iter=MAX_ITER,
            ms_scaling_factor=MS_FACTOR,
            phase1_iters=3,
        )
        out = step(jax.random.key(0))  # warmup + compile
        counters = list(map(int, out))
        assert counters[0] == runs_per_call and counters[5] == 0, counters
        times = []
        for i in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(step(jax.random.key(i + 1)))
            times.append(time.perf_counter() - t0)
        times.sort()
        mc_rate = runs_per_call / times[len(times) // 2]

        H = np.asarray(hx.todense(), dtype=np.uint8)
        rng = np.random.default_rng(3)
        errors = (rng.random((BATCH, H.shape[1])) < ERROR_RATE).astype(
            np.uint8
        )
        syn = (errors @ H.T % 2).astype(np.uint8)
        dec = BpOsdDecoder(
            hx,
            error_rate=ERROR_RATE,
            max_iter=MAX_ITER,
            bp_method="minimum_sum",
            ms_scaling_factor=MS_FACTOR,
            osd_method="osd_0",
        )
        outb = dec.decode_batch(syn)
        assert ((outb @ H.T) % 2 == syn).all(), "hgp decode invalid"
        dec.decode_batch(syn)  # settle (see measure_host_boundary)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            dec.decode_batch(syn)
            times.append(time.perf_counter() - t0)
        times.sort()
        host_rate = BATCH / times[len(times) // 2]
        base_rate, base_src = measure_baseline(H, syn)
        return {
            "hgp400_mc_rate": round(mc_rate, 1),
            "hgp400_vs_baseline": round(mc_rate / base_rate, 2),
            "hgp400_host_rate": round(host_rate, 1),
            "hgp400_host_vs_baseline": round(host_rate / base_rate, 2),
            "hgp400_baseline": round(base_rate, 1),
            "hgp400_baseline_source": base_src,
        }
    except Exception as exc:
        return {"hgp400_error": str(exc)[:200]}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def main():
    import jax

    from ldpc_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev.platform}")
    enable_compile_cache()
    code, H, errors, syndromes = build_workload()
    mc_rate, roofline = measure_device_mc()
    host_rate, host_best = measure_host_boundary(code, H, syndromes)
    base_rate, base_src = measure_baseline(H, syndromes)
    hgp = measure_hgp400()
    print(json.dumps({
        "metric": "syndromes_per_sec_bposd0_surface_d13_device_mc",
        "value": round(mc_rate, 1),
        "unit": "syndromes/s",
        "vs_baseline": round(mc_rate / base_rate, 2),
        "baseline": round(base_rate, 1),
        "baseline_source": base_src,
        "pipeline": "device_monte_carlo",
        "host_boundary_rate": round(host_rate, 1),
        "host_boundary_vs_baseline": round(host_rate / base_rate, 2),
        "host_boundary_rate_best": round(host_best, 1),
        "host_boundary_vs_baseline_best": round(host_best / base_rate, 2),
        "batch": BATCH,
        "backend": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card_line(),
        **hgp,
        **roofline,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
