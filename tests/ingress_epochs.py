"""Where the signed-ingress rung's slow steps come from, on a card.

Runs ``mirbft_tpu_torch.bench.ingress_run`` (chip_smoke phase 16's rung)
``--rungs`` times and prints, for each Poisson step, its goodput, p50 and
p95, the nodes' epochs after it, and the requests that took longer than
a second to commit: when they were submitted (ms into the step), their
latency and the sequence number that committed them.  A step whose
requests all commit late at the first sequence numbers past a multiple
of ``max_epoch_length``, with the epochs moved on, waited on an epoch
change.  Needs a CUDA card and the CUDA toolkit; exits 1 without a card.

    python3 tests/ingress_epochs.py [--rungs N]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rungs", type=int, default=3)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ingress_epochs: no CUDA card is present", file=sys.stderr)
        return 1
    from mirbft_tpu_torch import _build, bench
    from mirbft_tpu_torch.runtime.node import standard_initial_network_state

    _build.build_all(["sha256", "ed25519"])
    config = standard_initial_network_state(
        bench.INGRESS_NODES, bench.INGRESS_CLIENTS
    ).config
    print(f"max_epoch_length {config.max_epoch_length}, checkpoint "
          f"interval {config.checkpoint_interval}")
    for rung in range(args.rungs):
        ing = bench.ingress_run(device="cuda")
        for entry in ing["steps"]:
            step = entry["step"]
            records = sorted(step.records, key=lambda r: r["submit_ns"])
            start = records[0]["submit_ns"] if records else 0
            slow = [
                (round((r["submit_ns"] - start) / 1e6),
                 round((r["commit_ns"] - r["submit_ns"]) / 1e6), r["seq"])
                for r in records if r["commit_ns"] - r["submit_ns"] > 1e9
            ]
            print(f"rung {rung} {step.name}: committed {step.committed} of "
                  f"{step.submitted}, goodput {step.goodput_per_sec:.3f} "
                  f"req/s, p50 {step.p50_ms:.3f} ms, p95 {step.p95_ms:.3f} "
                  f"ms, retries {step.duplicates}, epochs after "
                  f"{entry['epochs']}; {len(slow)} slower than 1 s "
                  f"(submit ms, latency ms, seq), first: {slow[:4]}, "
                  f"seqs {sorted({s for _t, _l, s in slow})[:8]}")
        print(f"rung {rung}: wall {ing['wall_s']:.3f} s, snapshots "
              f"installed {ing['transfers']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
