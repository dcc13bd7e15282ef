"""chip_smoke.py's phases 12-15 for the tree in the current directory, on
a CUDA card, with their numbers as one JSON line.

Run from the root of a checkout, this one or another (an earlier commit
unpacked with ``git archive`` into a directory ``.gitignore`` lists):

    cd OTHER_TREE && python3 /path/to/tests/chip_phases_12_15.py

It imports that tree's ``chip_smoke.py`` and ``mirbft_tpu_torch`` and
calls only helpers this tree's chip_smoke.py shares with its parent's:
the ack plane's kernels == plain on three seeded cases, the device-plane anchor
(events, wall, steps, chain), the ack-plane rung (``bench.ackplane_run``)
and the step's device time on the rung's three batches and at the
anchor's shape, the host's cost of one step call (its launch, at the
anchor's shape), the sweep's device time on the rung's final state beside
its launch floor (``ack_plane.empty_sweep``) and the host's cost of one
sweep call, then ``bls_phases`` (the BLS kernel == plain, timed, and
rung 4; ``--ack-only`` leaves them out).  Run in two trees in turns (one,
the other, the other, one, ...) in one call, it compares their kernels and
end-to-end numbers on one card.  The last line starts ``RESULT``.
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mirbft_tpu_torch import _build  # noqa: E402
from mirbft_tpu_torch import bench as port_bench  # noqa: E402
from mirbft_tpu_torch.obsv.metrics import Registry  # noqa: E402
from mirbft_tpu_torch.ops import ack_plane  # noqa: E402
from mirbft_tpu_torch.testengine.crypto_plane import (  # noqa: E402
    AsyncKernelHashPlane,
)


def host_call_us(call, reps=400) -> float:
    """Host microseconds from ``call()`` (a wrapper call: its checks,
    allocations and launches; the kernel runs behind) to its return: the
    median of ``reps`` calls, in batches of 40 with the card drained
    between them so the launch queue never fills."""
    times = []
    for _ in range(reps // 40):
        torch.cuda.synchronize()
        for _ in range(40):
            t = time.perf_counter()
            call()
            times.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ack-only", action="store_true",
                        help="phases 12-13 only (no BLS kernel, no rung 4)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(cs.nvidia_smi("name,power.limit,clocks.max.sm"))
    t0 = time.perf_counter()
    libs = _build.build_all(["sha256", "ack_plane", "bls_g1"])
    for name in ("ack_plane", "bls_g1"):
        print(libs[name].with_suffix(".ptxas.txt").read_text())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}
    for rows, limbs in ((1024, 1), (4096, 3), (65536, 2)):
        cs.compare_ack(rows, limbs)
    ack_plane.ack_step.launches = 0
    events, wall, _cpu, chains, _, _counts = cs.run_engine(
        cs.ANCHOR_REQS, AsyncKernelHashPlane(), ack_plane="device",
        ack_device="cuda")
    res["anchor"] = dict(events=events, wall_s=wall,
                         steps=ack_plane.ack_step.launches,
                         chain=next(iter(chains.values())).hex()[:16])
    print("phase 12", res["anchor"], f"at {time.perf_counter() - t0:.1f} s",
          flush=True)
    rung = port_bench.ackplane_run(Registry(), device="cuda")
    res["rung"] = {k: rung[k] for k in (
        "host_events_per_sec", "device_events_per_sec",
        "committed_reqs_per_sec", "drain_seconds", "sweep_seconds",
        "fallback_rows", "divergences", "step_launches")}
    c_pad, w_pad = rung["plane"]["c_pad"], rung["plane"]["w_pad"]
    kw = dict(weak_q=2, strong_q=3)
    times = {}
    for source in port_bench.ACKPLANE_SOURCES:
        state0, batch = cs.rung_step_inputs(rung["clients"], source, c_pad,
                                            w_pad)
        cs.compare_step(f"source {source}", state0, batch, kw)
        first = ack_plane.new_first(c_pad * w_pad, "cuda")
        times[f"rung source {source}"] = cs.time_events(
            lambda state0=state0, batch=batch: (
                [t.clone() for t in state0] + [batch]),
            lambda *a, first=first: ack_plane.ack_step(*a, first=first, **kw))
    cases = cs.ack_plane_cases()
    case = cases.make_case(cs.SEED, 2048, 1, c_pad=cs.CLIENTS,
                           w_pad=cs.ANCHOR_W_PAD)
    state, batch = cases.torch_state(case, "cuda"), cases.torch_batch(
        case, "cuda")
    akw = dict(weak_q=case["weak_q"], strong_q=case["strong_q"])
    cs.compare_step("anchor shape", state, batch, akw)
    first = ack_plane.new_first(cs.CLIENTS * cs.ANCHOR_W_PAD, "cuda")
    times["anchor shape 2048"] = cs.time_events(
        lambda: [t.clone() for t in state] + [batch],
        lambda *a: ack_plane.ack_step(*a, first=first, **akw))
    res["step_ms"] = times
    res["step_host_call_us"] = host_call_us(
        lambda: ack_plane.ack_step(*state, batch, first=first, **akw))
    # The sweep on the rung's final state (every live slot certified),
    # held against its plain version there, then timed beside its launch
    # floor, with the host's cost of one sweep call.
    sweep_state, _ = cs.rung_step_inputs(rung["clients"], 3, c_pad, w_pad)
    sweep_state[0][:] = 0b1110
    cs.compare_sweep("sweep, the rung's final state",
                     [t.clone() for t in sweep_state],
                     [t.clone() for t in sweep_state], kw)
    sweep_args = [sweep_state[i] for i in (0, 3, 4, 5, 6)]
    res["sweep_ms"] = cs.time_events(
        lambda: [t.clone() for t in sweep_args],
        lambda *a: ack_plane.quorum_sweep(*a, **kw))
    res["sweep_floor_ms"] = cs.time_events(
        lambda: [], lambda: ack_plane.empty_sweep(c_pad * w_pad))
    res["sweep_host_call_us"] = host_call_us(
        lambda: ack_plane.quorum_sweep(*sweep_args, **kw))
    print("phase 13", json.dumps(res["rung"]), json.dumps(times),
          f"sweep {res['sweep_ms']:.6f} ms, floor "
          f"{res['sweep_floor_ms']:.6f} ms",
          f"at {time.perf_counter() - t0:.1f} s", flush=True)
    if args.ack_only:
        print("RESULT", json.dumps(res))
        return 0
    bls = cs.bls_phases(sms, t0)
    res["bls"] = {"shapes": [{k: e[k] for k in ("shape", "ms",
                                               "chain_floor_ms", "bound_ms")}
                             for e in bls["shapes"]],
                  "rung4_ms": bls["rung4_ms"]}
    print("RESULT", json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
