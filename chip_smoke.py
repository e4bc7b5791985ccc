"""Smoke test of ldpc_tpu on one NVIDIA GPU, in one process.

    python chip_smoke.py          # one GPU: the phases below
    python chip_smoke.py --four   # four GPUs: sharded device MC only

Workload: the unrotated surface code d=13 (n=313, m=156), BSC p=0.01,
min-sum BP (alpha=0.625, at most 30 iterations), seeded random errors.

1. device: a GPU must be JAX's default device; print the card's name
   and power limit and the compile-cache directory.
2. host boundary: ``BpOsdDecoder(osd_method="osd_0").decode_batch`` on
   65,536 syndromes; every row must satisfy H x = s. The first 4,096
   rows are decoded again by the same decoder on the CPU in this process
   (the float32 XLA engines the CPU tests pin); convergence flags and
   decisions must agree on at least 99.9% of rows (the rest are float
   ties from summation order). Also prints the time per batch through
   the host cascade (``decode_batch``'s path) and through the fused
   chunk loop.
3. device-resident MC: ``make_mc_decoder_step`` at batch 16,384; the
   counters must be consistent and the LER within 3 sigma of phase 2's.
4. every decoder family on the public surface: the GPU test lane
   (``pytest -m gpu tests/test_gpu_hardware.py``), run in this process.

``--four`` runs ``make_sharded_mc_step`` on a 4-GPU mesh (16,384 per
device, one key) and compares its counters with the same four per-device
keys run one after another through ``make_mc_decoder_step`` on one GPU:
the integer counters must be identical.

The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``, printed only if every phase passed.
"""

import argparse
import json
import os
import subprocess
import sys
import time

# the CPU reference of phase 2 needs the CPU backend beside the GPU
_plats = os.environ.get("JAX_PLATFORMS", "")
if _plats and "cpu" not in _plats.split(",") and _plats != "cpu":
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
P = 0.01
BP_KW = dict(
    error_rate=P, max_iter=30, bp_method="minimum_sum",
    ms_scaling_factor=0.625,
)


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out


def phase_device(jax, n_devices: int):
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {devs[0].platform}"
        )
    if len(devs) < n_devices:
        raise SystemExit(f"needs {n_devices} GPUs, found {len(devs)}")
    from ldpc_tpu.utils.compile_cache import enable_compile_cache

    log(f"[device] card: {card_line()}")
    log(f"[device] jax {jax.__version__}: {devs[0].device_kind} x{len(devs)}")
    log(f"[device] compile cache: {enable_compile_cache()}")


def _ler(fails: int, runs: int):
    p = fails / runs
    sigma = np.sqrt(max(p, 1.0 / runs) * (1 - p) / runs)
    return p, sigma


def phase_host_boundary(jax, code, H):
    from ldpc_tpu import BpOsdDecoder

    B = 65536
    rng = np.random.default_rng(2026)
    errors = (rng.random((B, H.shape[1])) < P).astype(np.uint8)
    syn = (errors @ H.T % 2).astype(np.uint8)
    dec = BpOsdDecoder(code.hx, osd_method="osd_0", **BP_KW)
    t0 = time.perf_counter()
    out = dec.decode_batch(syn)
    log(f"[host] first decode_batch (compile included): "
        f"{time.perf_counter() - t0:.3f} s")
    valid = ((out @ H.T) % 2 == syn).all(axis=1)
    if not valid.all():
        raise AssertionError(f"{int((~valid).sum())} rows violate H x = s")
    conv = np.asarray(dec.converge_batch)

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref = BpOsdDecoder(code.hx, osd_method="osd_0", **BP_KW)
        out_ref = ref.decode_batch(syn[:4096])
        conv_ref = np.asarray(ref.converge_batch)
    agree = (conv[:4096] == conv_ref) & (out[:4096] == out_ref).all(axis=1)
    n_dis = int((~agree).sum())
    log(f"[host] CPU-reference disagreements: {n_dis} of 4096 rows")
    if n_dis > 4:  # 0.1% of 4,096
        raise AssertionError(f"{n_dis} rows disagree with the CPU reference")

    # the two decode_batch paths, each warmed twice, timed in turns
    def run(fused: bool):
        dec._USE_FUSED = fused
        t0 = time.perf_counter()
        dec.decode_batch(syn)
        return time.perf_counter() - t0

    for fused in (True, True, False, False):
        run(fused)
    times = {True: [], False: []}
    for fused in (True, False, False, True, True, False):
        times[fused].append(run(fused))
    del dec._USE_FUSED
    log(f"[host] decode_batch d=13 x{B}: fused chunk loop "
        f"{np.median(times[True]) * 1e3:.2f} ms, host cascade "
        f"{np.median(times[False]) * 1e3:.2f} ms (median of 3 each; "
        f"decode_batch takes the "
        f"{'fused loop' if dec._fused_ok() else 'host cascade'})")

    lx = np.asarray(code.lx.todense(), np.uint8)
    fails = int((((errors ^ out) @ lx.T) % 2).any(axis=1).sum())
    log(f"[host] LER {fails}/{B}; converged {int(conv.sum())}/{B}; ok")
    return fails, B


def phase_device_mc(jax, code, host_fails, host_runs):
    from ldpc_tpu.monte_carlo_simulation import make_mc_decoder_step

    rounds, calls = 4, 4
    step, runs_per_call = make_mc_decoder_step(
        code.hx, P, logicals=code.lx, batch_size=16384,
        rounds_per_call=rounds, max_iter=30, ms_scaling_factor=0.625,
    )
    acc = np.zeros(6, np.int64)
    t0 = time.perf_counter()
    for i in range(calls):
        acc += np.asarray(step(jax.random.key(i)), np.int64)
    dt = time.perf_counter() - t0
    runs, fails, conv, iters, osd_used, overflow = map(int, acc)
    log(f"[mc] counters runs={runs} fails={fails} bp_converged={conv} "
        f"bp_iters={iters} osd_used={osd_used} overflow={overflow} "
        f"({dt:.3f} s for {calls} calls, compile included)")
    if runs != 16384 * rounds * calls or runs_per_call * calls != runs:
        raise AssertionError(f"runs {runs} != B * rounds * calls")
    if overflow != 0:
        raise AssertionError(f"bucket_overflow = {overflow}")
    if osd_used != runs - conv or iters <= 0:
        raise AssertionError("inconsistent convergence counters")
    p_mc, s_mc = _ler(fails, runs)
    p_host, s_host = _ler(host_fails, host_runs)
    bound = 3 * np.hypot(s_mc, s_host)
    log(f"[mc] LER {p_mc:.3e} vs host {p_host:.3e}, 3 sigma {bound:.3e}")
    if abs(p_mc - p_host) > bound:
        raise AssertionError("device-MC LER outside 3 sigma of host LER")


def phase_families():
    import pytest

    class Tally:
        def __init__(self):
            self.outcomes = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.outcomes[report.nodeid] = report.outcome

    tally = Tally()
    rc = pytest.main(
        [
            "-m", "gpu", "-v", "-s", "-p", "no:cacheprovider",
            "--rootdir", ROOT,
            os.path.join(ROOT, "tests", "test_gpu_hardware.py"),
        ],
        plugins=[tally],
    )
    bad = {k: v for k, v in tally.outcomes.items() if v != "passed"}
    log(f"[families] {len(tally.outcomes) - len(bad)} passed, "
        f"not passed: {bad or 'none'} (pytest exit {int(rc)})")
    if rc != 0 or bad or not tally.outcomes:
        raise AssertionError("GPU test lane failed")


def phase_four(jax, code):
    from jax.sharding import Mesh

    from ldpc_tpu.monte_carlo_simulation import (
        make_mc_decoder_step,
        make_sharded_mc_step,
    )

    kw = dict(
        logicals=code.lx, rounds_per_call=4, max_iter=30,
        ms_scaling_factor=0.625,
    )
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("batch",))
    key = jax.random.key(7)
    sharded, runs = make_sharded_mc_step(
        code.hx, P, mesh=mesh, batch_size_per_device=16384, **kw
    )
    t0 = time.perf_counter()
    got = np.asarray(sharded(key), np.int64)
    log(f"[four] sharded counters {got.tolist()} "
        f"({time.perf_counter() - t0:.3f} s, compile included)")
    local, _ = make_mc_decoder_step(code.hx, P, batch_size=16384, **kw)
    want = np.zeros(6, np.int64)
    with jax.default_device(jax.devices()[0]):
        for k in jax.random.split(key, 4):
            want += np.asarray(local(k), np.int64)
    log(f"[four] one-GPU sum of the four device keys {want.tolist()}")
    if got[0] != runs or not np.array_equal(got, want):
        raise AssertionError("sharded counters differ from the one-GPU sum")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--four", action="store_true",
        help="run only the 4-GPU sharded device-MC phase",
    )
    args = ap.parse_args()

    import jax

    n_devices = 4 if args.four else 1
    phase_device(jax, n_devices)
    from ldpc_tpu.codes import surface_code

    code = surface_code(13)
    H = np.asarray(code.hx.todense(), np.uint8)
    if args.four:
        phase_four(jax, code)
    else:
        fails, runs = phase_host_boundary(jax, code, H)
        phase_device_mc(jax, code, fails, runs)
        phase_families()
    dev = jax.devices()[0]
    log(f"card: {card_line()}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
