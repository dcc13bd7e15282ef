"""The bench's ``app_kv`` stage function (``bench.app_run`` on the card),
timed as ``StageRunner`` times a stage, from the tree named as the first
argument.  Each tree runs in a process of its own, so two trees (the
parent's ``git archive`` and this one) can be compared on one card, in
turns::

    python3 tests/app_kv_stage.py build/parent
    python3 tests/app_kv_stage.py .

Prints one ``APP_KV`` JSON line: seconds, ops timed out, convergence,
goodput, read and write latency, the restarted replica's catch-up and,
on workers, their exit codes.
"""

import json
import os
import sys
import time

if __name__ == "__main__":
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    from mirbft_tpu_torch import _build, bench

    _build.build_all(["sha256"])
    start = time.perf_counter()
    out = bench.app_run(device="cuda")
    seconds = time.perf_counter() - start
    step = out["step"]
    print("APP_KV", json.dumps({
        "tree": root, "seconds": round(seconds, 3),
        "timed_out": step.timed_out, "converged": out["converged"],
        "goodput": step.goodput_per_sec, "write_p50_ms": step.write_p50_ms,
        "write_p99_ms": step.write_p99_ms, "read_p50_ms": step.read_p50_ms,
        "caught_up": out["lag"]["caught_up"],
        "exit_codes": out.get("exit_codes"),
    }), flush=True)
