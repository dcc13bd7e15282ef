"""Whether the KV app rung's workers converge after its step, probed on
either package, several runs in a row.

    python3 tests/app_converge_probe.py --package port --device cuda --runs 4
    JAX_PLATFORMS=cpu python3 tests/app_converge_probe.py --package jax --runs 6

``port`` runs ``mirbft_tpu_torch.bench.app_run(device=...)`` whole (the
step, the convergence wait, the stopped and restarted replica) and
reports its ``converged`` and ``stall``.  ``jax`` runs the JAX bench's
app rung (``bench.app_run``: APP_NODES workers on the ``pipelined``
processor, APP_SESSIONS ``KvClient`` sessions x APP_OPS_PER_SESSION ops)
on the CPU and then waits, as the port's rung does, up to the port's
APP_CONVERGE_S for every worker to report one app chain and one applied
index (the JAX worker's ``app.json`` carries no store digest).
``--test-size`` runs the port at tests/test_torch_app_mp.py's cut.  Run
from the repo root.  Prints one JSON line a run: the step's ops and
timeouts (the port's: each write not seen committed, with its outcome),
whether the workers converged and after how many seconds, and, when they
did not, each worker's (low watermark, high watermark, epoch, epoch
state, applied seq, applied index); then a ``SUMMARY`` line.
"""

import argparse
import json
import os
import sys
import time
import urllib.request

sys.path.insert(0, os.getcwd())


def failed_writes(history) -> list:
    """Each write the step did not see committed: its session, key,
    outcome and seconds from the step's first op to its invoke and
    return."""
    if not history:
        return []
    t0 = min(e["invoke_ns"] for e in history)
    return [
        (e["client_id"], e["key"], e["outcome"],
         round((e["invoke_ns"] - t0) / 1e9, 3),
         round((e["return_ns"] - t0) / 1e9, 3))
        for e in history
        if e["op"] == "put"
        and e["outcome"] not in ("ok", "not_found", "cas_conflict")
    ]


def port_run(device: str, test_size: bool = False) -> dict:
    from mirbft_tpu_torch import bench

    start = time.perf_counter()
    # The CPU test's cut (tests/test_torch_app_mp.py): 4 workers, 32 ops a
    # session, tick 0.05 s.
    kw = dict(nodes=4, ops_per_session=32, tick_s=0.05) if test_size else {}
    out = bench.app_run(device=device, **kw)
    step = out["step"]
    return {
        "ops": step.submitted,
        "timed_out": step.timed_out,
        "failed_writes": failed_writes(out["history"]),
        "homes": out["homes"],
        "converged": out["converged"],
        "stall": out["stall"],
        "applied": out["applied"],
        "step_installs": out["step_installs"],
        "lag_caught_up": out["lag"]["caught_up"],
        "exit_codes": out["exit_codes"],
        "wall_s": time.perf_counter() - start,
    }


def _jax_status(handle) -> dict:
    try:
        url = f"http://127.0.0.1:{handle.metrics_port}/status"
        with urllib.request.urlopen(url, timeout=5.0) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except (OSError, ValueError):
        return {}


def jax_run(converge_s: float) -> dict:
    import bench as ref_bench
    from mirbft_tpu import loadgen
    from mirbft_tpu.app.service import KvClient
    from mirbft_tpu.cluster import ClusterSupervisor
    from mirbft_tpu.cluster.worker import read_json

    start = time.perf_counter()
    client_ids = list(range(1, ref_bench.APP_SESSIONS + 1))
    supervisor = ClusterSupervisor(
        node_count=ref_bench.APP_NODES,
        client_ids=client_ids,
        batch_size=ref_bench.APP_BATCH_SIZE,
        processor="pipelined",
        tick_seconds=ref_bench.APP_TICK_S,
        app="kv",
    )
    sessions = {}
    try:
        supervisor.start()
        deadline = time.monotonic() + 30.0
        addresses = supervisor.app_addresses()
        while (len(addresses) < ref_bench.APP_NODES
               and time.monotonic() < deadline):
            time.sleep(0.1)
            addresses = supervisor.app_addresses()
        homes = sorted(addresses)
        sessions = {
            cid: KvClient(addresses, cid, home=homes[i % len(homes)])
            for i, cid in enumerate(client_ids)
        }
        workload = loadgen.KvWorkload(
            sessions,
            loadgen.kv_client_models(client_ids,
                                     read_ratio=ref_bench.APP_READ_RATIO),
            seed=7,
        )
        step = workload.run_step(
            "app-kv-mixed",
            ops_per_session=ref_bench.APP_OPS_PER_SESSION,
            op_timeout_s=ref_bench.APP_OP_TIMEOUT_S,
        )
        step_end = time.monotonic()
        converged = False
        while time.monotonic() < step_end + converge_s:
            docs = {h.node_id: read_json(os.path.join(h.dir, "app.json"))
                    for h in supervisor.nodes}
            chains = set(supervisor.chains())
            if (all(docs.values()) and len(chains) == 1 and "" not in chains
                    and len({d["applied_index"] for d in docs.values()}) == 1):
                converged = True
                break
            time.sleep(0.1)
        converge_wait = time.monotonic() - step_end
        stall = None
        if not converged:
            stall = {}
            for h in supervisor.nodes:
                doc = _jax_status(h)
                epoch = doc.get("epoch_tracker") or {}
                app = read_json(os.path.join(h.dir, "app.json")) or {}
                stall[h.node_id] = (
                    doc.get("low_watermark"), doc.get("high_watermark"),
                    epoch.get("number"), epoch.get("state"),
                    app.get("applied_seq"), app.get("applied_index"))
    finally:
        for session in sessions.values():
            session.close()
        supervisor.teardown()
    return {
        "ops": step.submitted,
        "timed_out": step.timed_out,
        "converged": converged,
        "converge_wait_s": converge_wait,
        "stall": stall,
        "wall_s": time.perf_counter() - start,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--package", choices=("port", "jax"), required=True)
    parser.add_argument("--device", default="cuda",
                        help="the port's device (cuda or cpu)")
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--test-size", action="store_true",
                        help="the port at the CPU test's cut (4 workers, "
                        "32 ops a session, tick 0.05 s)")
    args = parser.parse_args()
    converge_s = 60.0
    stalls = timeouts = 0
    for i in range(args.runs):
        if args.package == "port":
            out = port_run(args.device, args.test_size)
        else:
            out = jax_run(converge_s)
        stalls += not out["converged"]
        timeouts += out["timed_out"]
        print(json.dumps({"run": i, "package": args.package, **out},
                         default=str), flush=True)
    print(f"SUMMARY {args.package}: {stalls} of {args.runs} runs did not "
          f"converge; {timeouts} ops timed out", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
