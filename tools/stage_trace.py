"""Per-stage device time from one profiler trace, on the GPU.

    python tools/stage_trace.py --out chiprun_out/stage_trace

Traces, each in a window of its own after warm-up, the d=13 device-MC
step (``make_mc_decoder_step``, batch 16,384, one round per call) and
``BpOsdDecoder(osd_0).decode_batch`` on 65,536 syndromes through the
fused chunk loop and through the host cascade. Kernels are attributed to
the stage names the programs give with ``jax.named_scope``: each trace
event's ``hlo_op`` is looked up in XLA's optimized-HLO dump of its
module (``program_id``), whose ``op_name`` carries the scope path.

XLA's command buffers (CUDA graphs) are turned off for the traced
process, so that every kernel carries its HLO op; traced times are
therefore a little above production times.

Prints one JSON object: per window its length, the device busy time
(union of kernel intervals) and idle share, and per stage the device
time, the idle time just before the stage's kernels, the kernel count,
the most launches of any one HLO op, and per ``while_loop`` of the stage
its trip count over the window (XLA:GPU copies a data-dependent loop
predicate to the host once per trip).
"""

import argparse
import collections
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# first matching scope names the stage
STAGES = (
    "sample", "gf2_elim", "phase1_bp", "bucket_bp", "osd0", "osd",
    "post", "compact", "merge", "bp",
)
_META = re.compile(r'^\s*(?:ROOT )?%?([\w.\-]+) = .*?op_name="([^"]*)"')
_CALLS = re.compile(r'^\s*(?:ROOT )?%?([\w.\-]+) = .*?calls=%?([\w.\-]+)')
_COMP = re.compile(r'^(?:ENTRY )?%?([\w.\-]+) ')


def hlo_op_names(dump_dir):
    """{(program_id, hlo_op): op_name} from the after-optimizations dump;
    an instruction without metadata takes the first op_name found in the
    computation it calls (fusions)."""
    table = {}
    for path in glob.glob(os.path.join(dump_dir, "module_*after_optimizations.txt")):
        pid = int(os.path.basename(path).split(".")[0].split("_")[1])
        own, calls, comp_first, comp = {}, {}, {}, None
        with open(path) as fh:
            for line in fh:
                if line and not line[0].isspace() and "{" in line:
                    m = _COMP.match(line)
                    comp = m.group(1) if m else None
                    continue
                m = _META.match(line)
                if m:
                    own[m.group(1)] = m.group(2)
                    if comp and comp not in comp_first:
                        comp_first[comp] = m.group(2)
                m = _CALLS.match(line)
                if m:
                    calls[m.group(1)] = m.group(2)
        for name, op in own.items():
            table[(pid, name)] = op
        for name, callee in calls.items():
            if (pid, name) not in table and callee in comp_first:
                table[(pid, name)] = comp_first[callee]
    return table


def stage_of(op_name):
    parts = set(op_name.split("/"))
    for s in STAGES:
        if s in parts:
            return s
    return "other"


def reduce_trace(xplane_path, names, window_name):
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    kern, win = [], None
    for plane in pd.planes:
        for line in plane.lines:
            for ev in line.events:
                if plane.name.startswith("/device:GPU"):
                    st = dict(ev.stats)
                    kern.append(
                        (ev.start_ns, ev.duration_ns, st.get("program_id"),
                         st.get("hlo_op"), ev.name)
                    )
                elif ev.name == window_name and win is None:
                    win = (ev.start_ns, ev.start_ns + ev.duration_ns)
    kern.sort()
    lo = kern[0][0] if kern else 0.0
    hi = max((s + d for s, d, *_ in kern), default=0.0)
    if win is not None:
        lo, hi = win
    busy, cur_s, cur_e = 0.0, None, None
    # stage -> [device ns, kernels, launches per op, idle ns before its
    # kernels, predicate copies per while op]
    per = collections.defaultdict(
        lambda: [0.0, 0, collections.Counter(), 0.0, collections.Counter()]
    )
    other_ops = collections.Counter()
    for s, d, pid, op, name in kern:
        if s + d < lo or s > hi:
            continue
        gap = max(0.0, s - (lo if cur_e is None else cur_e))
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
        op_name = names.get((pid, op), "") if op else ""
        st = stage_of(op_name) if op_name else (
            "transfer" if "emcpy" in name or "emset" in name else "other"
        )
        per[st][0] += d
        per[st][1] += 1
        per[st][3] += gap
        if st == "other":
            other_ops[f"{op or name} {op_name}"] += d
        per[st][2][op or name] += 1
        if "MemcpyD2H" in name and op and op.startswith("while"):
            per[st][4][op] += 1
    if cur_e is not None:
        busy += cur_e - cur_s
    span = hi - lo
    return {
        "window_ms": span / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": (1.0 - busy / span) if span else None,
        "window_from": "host annotation" if win else "kernel span",
        "stages": {
            k: {
                "device_ms": v[0] / 1e6,
                "idle_before_ms": v[3] / 1e6,
                "kernels": v[1],
                "max_launches_per_op": max(v[2].values()),
                "while_trips": dict(v[4]),
            }
            for k, v in sorted(per.items(), key=lambda kv: -kv[1][0])
        },
        "top_other_ops_ms": {
            k: v / 1e6 for k, v in other_ops.most_common(6)
        },
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    dump = os.path.join(out, "hlo_dump")
    os.makedirs(out, exist_ok=True)
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_dump_to={dump} --xla_dump_hlo_as_text"
        + " --xla_gpu_enable_command_buffer="
    ).strip()

    import jax
    import numpy as np

    from ldpc_tpu import BpOsdDecoder
    from ldpc_tpu.codes import surface_code
    from ldpc_tpu.monte_carlo_simulation import make_mc_decoder_step
    from ldpc_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev.platform}")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    code = surface_code(13)
    H = np.asarray(code.hx.todense(), np.uint8)
    step, _ = make_mc_decoder_step(
        code.hx, 0.01, logicals=code.lx, batch_size=16384,
        rounds_per_call=1, max_iter=30, ms_scaling_factor=0.625,
    )
    rng = np.random.default_rng(7)
    errors = (rng.random((65536, H.shape[1])) < 0.01).astype(np.uint8)
    syn = (errors @ H.T % 2).astype(np.uint8)
    dec = BpOsdDecoder(
        code.hx, error_rate=0.01, max_iter=30, bp_method="minimum_sum",
        ms_scaling_factor=0.625, osd_method="osd_0",
    )
    gpu_path_fused = dec._fused_ok()

    def decode(fused):
        dec._USE_FUSED = fused
        return dec.decode_batch(syn)

    for _ in range(2):  # compile, then settle the adaptive buckets
        jax.block_until_ready(step(jax.random.key(0)))
        decode(True)
        decode(False)

    windows = {}
    for label, fn in (
        ("device_mc_step", lambda: jax.block_until_ready(
            step(jax.random.key(1)))),
        ("decode_batch_fused", lambda: decode(True)),
        ("decode_batch_cascade", lambda: decode(False)),
    ):
        tdir = os.path.join(out, label)
        shutil.rmtree(tdir, ignore_errors=True)
        t0 = time.perf_counter()
        with jax.profiler.trace(tdir):
            with jax.profiler.TraceAnnotation(label):
                fn()
        windows[label] = (tdir, time.perf_counter() - t0)

    names = hlo_op_names(dump)
    with open(os.path.join(out, "hlo_op_names.json"), "w") as fh:
        json.dump([[pid, op, name] for (pid, op), name in names.items()], fh)
    result = {
        "card": card,
        "device_kind": dev.device_kind,
        "gpu_path": "fused" if gpu_path_fused else "cascade",
        "hlo_ops_mapped": len(names),
    }
    for label, (tdir, wall) in windows.items():
        path = sorted(glob.glob(f"{tdir}/plugins/profile/*/*.xplane.pb"))[-1]
        result[label] = reduce_trace(path, names, label)
        result[label]["traced_wall_ms"] = wall * 1e3
    shutil.rmtree(dump, ignore_errors=True)
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
