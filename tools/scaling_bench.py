"""Scaling measurement: sharded Monte-Carlo throughput at 1..N devices,
and (``--multiproc-sweep``) at 1..N actual ``jax.distributed`` processes.

Runs the on-chip MC pipeline (surface d=13, p=0.01, BP30+OSD0) over
meshes of increasing size and prints one JSON line per mesh. On several
GPUs this measures multi-device scaling; on a CPU host with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` it validates the
sharded program end to end (BASELINE.md's 1 chip / 1 host / N hosts
scaling requirement).

Modes:
- (default)              in-process virtual-device sweep
- ``--multiproc N``      run as/spawn N real OS processes with a
                         localhost ``jax.distributed`` coordinator, a
                         GLOBAL mesh spanning every process's devices,
                         and one psum'd MC step — the closest honest
                         substitute for BASELINE.md's "N>=2 hosts" this
                         single-host sandbox permits
- ``--multiproc-sweep``  spawn the N=1,2 (and 4 when cores allow)
                         multi-process runs and print their JSON lines
"""

import json
import os
import socket
import subprocess
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

DEVICES_PER_PROC = 1


def _multiproc_worker(nproc: int):
    """Body of one distributed process (spawned with rendezvous env)."""
    import jax

    # N processes must not fight over one accelerator: the flat
    # multi-process run measures host-side scaling on the CPU backend
    jax.config.update("jax_platforms", "cpu")

    from ldpc_tpu.codes import surface_code
    from ldpc_tpu.monte_carlo_simulation import make_sharded_mc_step
    from ldpc_tpu.parallel import initialize_distributed

    initialize_distributed()
    assert jax.process_count() == nproc, jax.process_count()
    import numpy as np
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()), ("batch",))
    code = surface_code(13, compute_logicals=True)
    step, runs = make_sharded_mc_step(
        code.hx,
        0.01,
        mesh=mesh,
        logicals=code.lx,
        batch_size_per_device=4096,
        rounds_per_call=2,
        max_iter=30,
        ms_scaling_factor=0.625,
    )
    jax.block_until_ready(step(jax.random.key(0)))  # compile
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(step(jax.random.key(i + 1)))
        times.append(time.perf_counter() - t0)
    times.sort()
    rate = runs / times[len(times) // 2]
    if jax.process_index() == 0:
        print(
            json.dumps(
                {
                    "mode": "multiprocess",
                    "processes": nproc,
                    "devices": jax.device_count(),
                    "syndromes_per_sec": round(rate, 1),
                    "runs_per_call": runs,
                    "backend": jax.devices()[0].platform,
                }
            ),
            flush=True,
        )
    jax.distributed.shutdown()


def _spawn_multiproc(nproc: int) -> str:
    """Parent: spawn nproc rendezvous'd copies of this script."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(nproc):
        env = dict(
            os.environ,
            LDPC_TPU_COORDINATOR=f"127.0.0.1:{port}",
            LDPC_TPU_NUM_PROCESSES=str(nproc),
            LDPC_TPU_PROCESS_ID=str(pid),
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=f"--xla_force_host_platform_device_count={DEVICES_PER_PROC}",
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--multiproc-child", str(nproc)],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    line = ""
    last_err = ""
    for p in procs:
        out, err = p.communicate(timeout=900)
        if p.returncode != 0:
            last_err = (err or out)[-300:]
        for ln in out.splitlines():
            if ln.startswith("{"):
                line = ln
    if not line:  # only an error when no process produced the result
        return json.dumps(
            {"mode": "multiprocess", "processes": nproc, "error": last_err}
        )
    return line


def main():
    if "--multiproc-child" in sys.argv:
        return _multiproc_worker(
            int(sys.argv[sys.argv.index("--multiproc-child") + 1])
        )
    if "--multiproc" in sys.argv:
        n = int(sys.argv[sys.argv.index("--multiproc") + 1])
        print(_spawn_multiproc(n), flush=True)
        return
    if "--multiproc-sweep" in sys.argv:
        cores = os.cpu_count() or 2
        for n in [1, 2, 4]:
            if n > max(2, cores):
                break
            print(_spawn_multiproc(n), flush=True)
        return

    import jax

    from ldpc_tpu.codes import surface_code
    from ldpc_tpu.monte_carlo_simulation import make_sharded_mc_step
    from ldpc_tpu.parallel import make_mesh
    from ldpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    code = surface_code(13, compute_logicals=True)
    n_avail = len(jax.devices())
    sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= n_avail]
    for nd in sizes:
        mesh = make_mesh(nd)
        step, runs = make_sharded_mc_step(
            code.hx,
            0.01,
            mesh=mesh,
            logicals=code.lx,
            batch_size_per_device=16384,
            rounds_per_call=4,
            max_iter=30,
            ms_scaling_factor=0.625,
        )
        jax.block_until_ready(step(jax.random.key(0)))  # compile
        times = []
        for i in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(step(jax.random.key(i + 1)))
            times.append(time.perf_counter() - t0)
        times.sort()
        rate = runs / times[len(times) // 2]
        print(
            json.dumps(
                {
                    "devices": nd,
                    "syndromes_per_sec": round(rate, 1),
                    "runs_per_call": runs,
                    "backend": jax.devices()[0].platform,
                }
            )
        )


if __name__ == "__main__":
    main()
