"""Device-resident multi-round (sliding-window) decode throughput.

The sequence-scaling workload: R rounds of noisy syndrome measurement on
a surface-code memory, decoded with overlapping windows of the
space-time PCM — the reference runs this as a host loop one window and
one shot at a time (reference: memory_experiment_v2.py:72-160); here the
whole window scan is one jitted device program batched over shots
(ldpc_tpu/parallel/window.py). Prints one JSON line:

    {"metric": "round_syndromes_per_sec_window", "value": N, ...}

Usage: python tools/window_bench.py [distance] [rounds] [batch] [reps]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main():
    d = int(sys.argv[1]) if len(sys.argv) > 1 else 9
    R = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    B = int(sys.argv[3]) if len(sys.argv) > 3 else 512
    reps = int(sys.argv[4]) if len(sys.argv) > 4 else 5
    W = 4  # window span (rounds), slide W//2

    import jax

    from ldpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from ldpc_tpu.codes import surface_code
    from ldpc_tpu.parallel.window import make_window_decoder

    p = 0.003
    code = surface_code(d)
    m, n = code.hx.shape
    decode = make_window_decoder(
        code.hx,
        W,
        np.full(n, p),
        np.full(m, p),
        max_iter=20,
        ms_scaling_factor=0.625,
    )

    # recorded cumulative syndromes of a phenomenological-noise memory run
    rng = np.random.default_rng(3)
    H = np.asarray(code.hx.todense(), np.uint8)
    err = np.zeros((B, n), np.uint8)
    syn = np.zeros((B, m, R), np.uint8)
    for r in range(R):
        err ^= (rng.random((B, n)) < p).astype(np.uint8)
        s = (err @ H.T) % 2
        flips = (rng.random((B, m)) < p).astype(np.uint8)
        syn[:, :, r] = s ^ flips

    out = decode(syn)  # warmup + compile
    corr = np.asarray(out.correction)
    assert corr.shape == (B, n)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(decode(syn).correction)
        times.append(time.perf_counter() - t0)
    times.sort()
    rate = B * R / times[len(times) // 2]
    print(
        json.dumps(
            {
                "metric": "round_syndromes_per_sec_window",
                "value": round(rate, 1),
                "unit": "round-syndromes/s",
                "distance": d,
                "rounds": R,
                "window": W,
                "batch": B,
                "shots_per_sec": round(rate / R, 1),
                "backend": jax.default_backend(),
            }
        )
    )

    # LSD-0 window engine (device-scan counterpart of the reference's
    # LSD overlapping-window decoder)
    decode_lsd = make_window_decoder(
        code.hx, W, np.full(n, p), np.full(m, p),
        max_iter=20, ms_scaling_factor=0.625, postprocess="lsd0",
    )
    jax.block_until_ready(decode_lsd(syn).correction)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(decode_lsd(syn).correction)
        times.append(time.perf_counter() - t0)
    times.sort()
    rate = B * R / times[len(times) // 2]
    print(
        json.dumps(
            {
                "metric": "round_syndromes_per_sec_window_lsd0",
                "value": round(rate, 1),
                "unit": "round-syndromes/s",
                "shots_per_sec": round(rate / R, 1),
                "backend": jax.default_backend(),
            }
        )
    )

    # DEM-based overlapping-window family through the device scan
    # (ckt_noise/device_scan.py): phenomenological rep-code DEM where the
    # middle windows are time-translation invariant
    bench_dem_owd(B, reps)


def bench_dem_owd(B, reps):
    import jax
    import time as _t

    from ldpc_tpu.ckt_noise import BpOsdOverlappingWindowDecoder
    from ldpc_tpu.ckt_noise.dem_matrices import (
        detector_error_model_to_check_matrices,
    )

    # stim-free phenomenological rep-code memory DEM (same construction
    # as tests/test_ckt_noise.py's fixture)
    class _T:
        def __init__(self, t, v=0):
            self.t, self.val = t, v

        def is_relative_detector_id(self):
            return self.t == "det"

        def is_logical_observable_id(self):
            return self.t == "obs"

        def is_separator(self):
            return self.t == "sep"

    class _I:
        def __init__(self, p, targets):
            self.type = "error"
            self._p, self._targets = p, targets

        def args_copy(self):
            return [self._p]

        def targets_copy(self):
            return self._targets

    class _Dem:
        def __init__(self, instructions, nd, no):
            self._i = instructions
            self.num_detectors = nd
            self.num_observables = no

        def flattened(self):
            return self._i

    from ldpc_tpu.codes import rep_code

    n_checks, rounds = 6, 22
    H = np.asarray(rep_code(n_checks + 1).todense(), np.uint8)
    ins = []
    det = lambda r, c: r * n_checks + c
    for r in range(rounds):
        for j in range(n_checks + 1):
            t = [_T("det", det(r, c)) for c in np.flatnonzero(H[:, j])]
            if j == 0:
                t.append(_T("obs", 0))
            ins.append(_I(0.01, t))
        if r < rounds - 1:
            for c in range(n_checks):
                ins.append(_I(0.02, [_T("det", det(r, c)), _T("det", det(r + 1, c))]))
    dem = _Dem(ins, n_checks * rounds, 1)
    dec = BpOsdOverlappingWindowDecoder(
        dem, decodings=10, window=4, commit=2, num_checks=n_checks,
        decoder_config={"max_iter": 20},
    )
    scan_on = dec._maybe_device_scan() is not None
    m = detector_error_model_to_check_matrices(
        dem, allow_undecomposed_hyperedges=True
    )
    Hd = np.asarray(m.check_matrix.todense(), np.uint8)
    rng = np.random.default_rng(5)
    errs = (rng.random((B, Hd.shape[1])) < 0.02).astype(np.uint8)
    shots = ((errs @ Hd.T) % 2).astype(np.uint8)
    dec.decode_batch(shots)  # warmup + compile
    times = []
    for _ in range(reps):
        t0 = _t.perf_counter()
        dec.decode_batch(shots)
        times.append(_t.perf_counter() - t0)
    times.sort()
    rate = B / times[len(times) // 2]
    print(
        json.dumps(
            {
                "metric": "owd_dem_shots_per_sec",
                "value": round(rate, 1),
                "unit": "shots/s",
                "rounds": rounds,
                "windows": 10,
                "device_scan": bool(scan_on),
                "batch": B,
                "backend": jax.default_backend(),
            }
        )
    )


if __name__ == "__main__":
    main()
