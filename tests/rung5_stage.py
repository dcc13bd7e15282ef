"""Rung 5 alone, with a progress line every 50,000 engine events.

On a card (the bench's stage, the SHA-256 kernel built first)::

    python3 tests/rung5_stage.py
    python3 tests/rung5_stage.py --nodes 256 --clients 64

On the CPU, the sizing runs: the port on the host plane and the JAX
recipe with the late-digest advance (``tests/rung5_cases.py``)::

    python3 tests/rung5_stage.py --device cpu --plane coalescing
    JAX_PLATFORMS=cpu python3 tests/rung5_stage.py --package jax

Each progress line is ``RUNG5 {json}`` (``bench.Rung5Watch.line``, plus
the SHA-256 digest kernel's launches so far, counted by its wrapper: 0
off the card); the last is ``RUNG5_DONE {json}`` with the run's events,
simulated ms, chain, commits, wall, events/s, the hash plane's counters,
the wrapper's launches and the crashed node's record, and whether it
equals the pin of the full shape (``PIN``).
``--out FILE`` also appends every line to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

#: The full shape's run (one ``drain_clients(max_steps=50_000_000)``):
#: the port and the JAX recipe with the late-digest advance agree.
PIN = {
    "events": 5_442_215,
    "sim_ms": 40_901,
    "chain": "cac6d20e7467db452e93898947b66a91"
             "ce0609e76140cb759ac83c3da519ee0e",
}


def main(argv=None) -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    from mirbft_tpu_torch import bench
    from mirbft_tpu_torch.ops.sha256 import sha256_digest_words

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--package", choices=("port", "jax"), default="port")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--plane", choices=("kernel", "coalescing"),
                        default="kernel")
    parser.add_argument("--nodes", type=int, default=bench.RUNG5_NODES)
    parser.add_argument("--clients", type=int, default=bench.RUNG5_CLIENTS)
    parser.add_argument("--crash-node", type=int,
                        default=bench.RUNG5_CRASH_NODE)
    parser.add_argument("--crash-after", type=int,
                        default=bench.RUNG5_CRASH_AFTER)
    parser.add_argument("--down-for", type=int, default=bench.RUNG5_DOWN_FOR)
    parser.add_argument("--every", type=int, default=50_000)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    shape = dict(nodes=args.nodes, clients=args.clients,
                 crash_node=args.crash_node, crash_after=args.crash_after,
                 down_for=args.down_for)
    full = shape == dict(
        nodes=bench.RUNG5_NODES, clients=bench.RUNG5_CLIENTS,
        crash_node=bench.RUNG5_CRASH_NODE,
        crash_after=bench.RUNG5_CRASH_AFTER, down_for=bench.RUNG5_DOWN_FOR,
    )
    def emit(tag, record):
        line = f"{tag} {json.dumps(record)}"
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as out:
                out.write(line + "\n")

    def progress(record):
        record["launches"] = sha256_digest_words.launches
        emit("RUNG5", record)

    start = time.perf_counter()
    if args.package == "jax":
        from rung5_cases import jax_rung5

        out = jax_rung5(progress=progress, every=args.every, **shape)
        out["chain"] = out.pop("chains")[0]
    else:
        from mirbft_tpu_torch.testengine.crypto_plane import (
            AsyncKernelHashPlane,
            CoalescingHashPlane,
        )

        if args.device == "cuda":
            import subprocess

            from mirbft_tpu_torch import _build

            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, check=True).stdout.strip()
            _build.build_all(["sha256"])
            emit("RUNG5_BUILT", {"card": card,
                                 "s": round(time.perf_counter() - start, 3)})
        plane = (AsyncKernelHashPlane(device=args.device)
                 if args.plane == "kernel" else CoalescingHashPlane())
        sha256_digest_words.launches = 0
        out = bench.rung5_run(device=args.device, hash_plane=plane,
                              progress=progress, every=args.every, **shape)
    if args.package == "jax":
        args.device = args.plane = None
    out.update(
        package=args.package, device=args.device, plane=args.plane,
        shape=shape, launches=sha256_digest_words.launches,
        events_per_s=out["events"] / out["wall_s"],
        process_s=round(time.perf_counter() - start, 3),
    )
    if full:
        out["pin_equal"] = all(out[key] == PIN[key] for key in PIN)
    emit("RUNG5_DONE", out)
    return 0 if out.get("pin_equal", True) else 1


if __name__ == "__main__":
    sys.exit(main())
