"""The multi-process rungs on a CUDA card, one worker process a node.

Run from the root of a checkout on a machine with a card and the CUDA
toolkit:

    python3 tests/cluster_rungs.py [--out PATH] [--skip-knee]

It builds the SHA-256 and Ed25519 kernels into ``build/kernels/`` (the
workers load them from there), then runs on ``cuda`` workers:

1. ``bench.knee_run()``: the capacity knee of each ``KNEE_CONFIGS`` row
   on 8 workers, the traced row's critical-path attribution at the knee;
2. the rest of ``cluster.chaos_mp.mp_matrix()``: its four
   reconfiguration scenarios (join and removal under a partition, a
   committed reconfiguration adding node 4 across a partition, one
   removing a crashed leader), each on ``cuda`` workers;
3. ``mp_adversary_matrix()`` (the request-duplication flood);
4. ``kv_mp_matrix()`` (crash-restart and partition-minority with the KV
   service and the linearizable-read audit).

Each scenario's verdict and counters and every worker's kernel evidence
(device hash flushes, digest launches, exit codes) are printed and
written with the knee's artifact to ``--out`` (default
``chiprun_out/cluster_rungs.json``), beside the card's name and power
limit.  Exits 1 when a scenario fails (``run_mp_scenario`` fails one
whose worker exited with a code the supervisor did not cause, logged a
fault or made a digest on the host) or a knee worker did not exit 0;
prints nothing and exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def scenario_doc(result) -> dict:
    doc = result.to_dict()
    print(f"  {result.line()}", flush=True)
    return doc


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=str(REPO / "chiprun_out"
                                             / "cluster_rungs.json"))
    parser.add_argument("--skip-knee", action="store_true",
                        help="run the scenario matrices only")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("cluster_rungs: no CUDA card is present", file=sys.stderr)
        return 1

    from mirbft_tpu_torch import _build
    from mirbft_tpu_torch import bench
    from mirbft_tpu_torch.cluster.chaos_mp import (
        MP_RECONFIG_NAMES,
        kv_mp_matrix,
        mp_adversary_matrix,
        mp_matrix,
        run_mp_scenario,
    )

    name = card()
    print(name, flush=True)
    t0 = time.perf_counter()
    _build.build_all(["sha256", "ed25519"])
    print(f"kernels built in {time.perf_counter() - t0:.3f} s", flush=True)
    out = {"card": name, "knee": None, "scenarios": {}}
    failed = []

    if not args.skip_knee:
        start = time.perf_counter()
        knee = bench.knee_run(device="cuda")
        out["knee"] = knee
        for config in knee["configs"]:
            evidence = config["evidence"]
            host = sum(e["host_digests"] for e in evidence.values())
            flushes = [e.get("flushes", {}).get("hash/device", 0)
                       for e in evidence.values()]
            print(f"knee {config['config']}: knee "
                  f"{config['knee_rate_per_sec']} req/s, steps (rate, p95 ms, "
                  f"goodput, ok) "
                  f"{[(s['rate_per_sec'], s['p95_ms'], s['goodput_per_sec'], s['ok']) for s in config['steps']]}"
                  f"; exit codes {config['exit_codes']}; device hash "
                  f"flushes {flushes}; host digests {host}", flush=True)
            clean = all(codes == [0]
                        for codes in config["exit_codes"].values())
            if host or not all(flushes) or not clean:
                failed.append(f"knee {config['config']}")
        print(f"knee_run: {time.perf_counter() - start:.1f} s", flush=True)

    reconfig = [s for s in mp_matrix() if s.name in MP_RECONFIG_NAMES]
    for label, scenarios in (
        ("mp_matrix (reconfiguration)", reconfig),
        ("mp_adversary_matrix", mp_adversary_matrix()),
        ("kv_mp_matrix", kv_mp_matrix()),
    ):
        start = time.perf_counter()
        print(f"{label}:", flush=True)
        for index, scenario in enumerate(scenarios):
            result = run_mp_scenario(scenario, seed=index, budget_s=300.0,
                                     device="cuda")
            out["scenarios"][scenario.name] = scenario_doc(result)
            c = result.counters
            # run_mp_scenario fails a scenario on a worker fault, a log
            # fault or a host digest; the exit codes are gated here too.
            exits = [code for codes in c["exit_codes"] for code in codes]
            if (not result.passed or c["worker_faults"]
                    or not c["launches_sha256"]
                    or any(code not in (0, -9) for code in exits)):
                failed.append(scenario.name)
        print(f"{label}: {time.perf_counter() - start:.1f} s", flush=True)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    print(name)
    print(json.dumps({"ok": not failed, "failed": failed,
                      "seconds": round(time.perf_counter() - t0, 3)}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
