"""Quantum LER estimation with the device-resident Monte-Carlo pipeline.

The whole loop (error sampling, syndrome extraction, BP+OSD decoding,
logical-failure tallies) runs on the accelerator; only counters return
to the host.
"""

from ldpc_tpu.codes import surface_code
from ldpc_tpu.monte_carlo_simulation import DeviceMonteCarlo

code = surface_code(13, compute_logicals=True)
mc = DeviceMonteCarlo(
    code.hx,
    error_rate=0.03,
    seed=0,
    logicals=code.lx,
    batch_size=16384,
    rounds_per_call=8,
    max_iter=30,
    ms_scaling_factor=0.625,
)
print(mc.run(target_runs=1_000_000))

# exact checkpoint/resume:
state = mc.checkpoint()
mc2 = DeviceMonteCarlo(
    code.hx, error_rate=0.03, seed=0, logicals=code.lx,
    batch_size=16384, rounds_per_call=8, max_iter=30,
    ms_scaling_factor=0.625,
)
mc2.restore(state)
