"""Device-resident QSS pipeline tests.

The host :class:`QssSimulator` is the parity oracle (itself pinned to
reference quasi_single_shot_v2.py semantics); the device pipeline must
reproduce its logical-error statistics — same channels, window
schedule, feedback semantics — under an independent (device) RNG.
"""

import numpy as np
import pytest

import jax

from ldpc_tpu.codes import rep_code, ring_code
from ldpc_tpu.monte_carlo_simulation import (
    BpParams,
    DeviceQss,
    QssSimulator,
    make_qss_step,
    make_sharded_qss_step,
)


def toric1d(n=8):
    H = np.asarray(ring_code(n).todense(), np.int32)
    L = np.ones((1, n), np.int32)
    return H, L


def test_qss_step_low_noise_no_failures():
    H, L = toric1d()
    step, runs = make_qss_step(
        H, 0.002, 0.002, L,
        repetitions=4, rounds=8, batch_size=64, max_iter=12,
    )
    out = np.asarray(step(jax.random.key(0)))
    assert out[0] == runs == 64
    assert out[1] <= 1  # ~never a logical failure at p=0.002 on d=8
    assert out[3] == 64 * 3  # 3 windows per shot (rounds/T - 1)


def test_qss_step_deterministic():
    H, L = toric1d()
    step, _ = make_qss_step(
        H, 0.05, 0.05, L,
        repetitions=4, rounds=8, batch_size=32, max_iter=8,
    )
    a = np.asarray(step(jax.random.key(3)))
    b = np.asarray(step(jax.random.key(3)))
    assert np.array_equal(a, b)


def test_qss_step_analog_mode():
    H, L = toric1d()
    step, runs = make_qss_step(
        H, 0.01, 0.01, L,
        repetitions=4, rounds=8, batch_size=32, max_iter=8,
        analog_tg=True,
    )
    out = np.asarray(step(jax.random.key(1)))
    assert out[0] == runs
    assert 0 <= out[1] <= runs


def test_qss_step_validation():
    H, L = toric1d()
    with pytest.raises(ValueError, match="even"):
        make_qss_step(H, 0.01, 0.01, L, repetitions=3, rounds=6)
    with pytest.raises(ValueError, match="rounds"):
        make_qss_step(H, 0.01, 0.01, L, repetitions=4, rounds=7)
    with pytest.raises(ValueError, match="check_side"):
        make_qss_step(
            H, 0.01, 0.01, L, repetitions=4, rounds=8, check_side="Y"
        )


def test_device_qss_matches_host_simulator_ler():
    """Same physical model, independent RNGs: the device LER must fall
    within combined binomial error bars of the host QssSimulator."""
    H, L = toric1d(6)
    per = ser = 0.04
    kw = dict(repetitions=4, rounds=8)
    host = QssSimulator(
        H=H, L=L, per=per, ser=ser, bias=[1.0, 0.0, 0.0],
        decoding_method="bposd", check_side="X",
        bp_params=BpParams(max_bp_iter=16, osd_method="osd_0", osd_order=0),
        seed=11, **kw,
    )
    host.eb_precission = 0.0  # disable early stopping
    n_host = 400
    host_out = host.run(samples=n_host)
    host_fail = n_host - host_out["z_success_cnt"]

    dev = DeviceQss(
        H, per, ser, L, seed=5, batch_size=512, max_iter=16,
        xyz_error_bias=(1.0, 0.0, 0.0), **kw,
    )
    dev_out = dev.run(samples=2048)
    n_dev = dev_out["nr_runs"]
    dev_fail = n_dev - dev_out["z_success_cnt"]

    p_h, p_d = host_fail / n_host, dev_fail / n_dev
    eb = np.sqrt(
        p_h * (1 - p_h) / n_host + p_d * (1 - p_d) / n_dev
    )
    assert abs(p_h - p_d) <= max(4 * eb, 0.02), (p_h, p_d, eb)
    assert dev_out["windows_decoded"] == n_dev * 3


def test_device_qss_checkpoint_resume():
    H, L = toric1d()
    a = DeviceQss(
        H, 0.03, 0.03, L, seed=2, batch_size=64,
        repetitions=4, rounds=8, max_iter=8,
    )
    a.run(samples=128)
    state = a.checkpoint()
    a.run(samples=256)

    b = DeviceQss(
        H, 0.03, 0.03, L, seed=2, batch_size=64,
        repetitions=4, rounds=8, max_iter=8,
    )
    b.restore(state)
    b.run(samples=256)
    assert np.array_equal(a.counters, b.counters)


def test_sharded_qss_step_runs_and_tallies():
    from ldpc_tpu.parallel import make_mesh

    H, L = toric1d()
    mesh = make_mesh(len(jax.devices()))
    step, runs = make_sharded_qss_step(
        H, 0.03, 0.03, L, mesh=mesh, batch_size_per_device=16,
        repetitions=4, rounds=8, max_iter=8,
    )
    out = np.asarray(step(jax.random.key(0)))
    assert out[0] == runs == 16 * len(jax.devices())
    assert 0 <= out[1] <= out[0]


def test_qss_step_rep_code_z_side():
    """check_side='Z' tracks X errors (rep code, X-bias noise)."""
    H = np.asarray(rep_code(7).todense(), np.int32)
    L = np.ones((1, 7), np.int32)
    step, runs = make_qss_step(
        H, 0.01, 0.01, L,
        repetitions=4, rounds=8, batch_size=32, max_iter=8,
        check_side="Z", xyz_error_bias=(1.0, 0.0, 0.0),
    )
    out = np.asarray(step(jax.random.key(2)))
    assert out[0] == runs
