"""Worker entrypoint: ``python -m mirbft_tpu_torch.cluster --spec <spec.json>``.

Spawned by ``ClusterSupervisor`` (one process per consensus node); can
also be launched by hand against a hand-written spec for debugging a
single node.  See worker.py for the spec schema, the boot handshake and
the exit codes.
"""

from __future__ import annotations

import argparse
import sys

from .worker import run_worker


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mirbft_tpu_torch.cluster",
        description="Run one mirbft-tpu consensus node (cluster worker) "
        "on the port's kernels.",
    )
    parser.add_argument(
        "--spec",
        required=True,
        help="path to the node's spec.json (written by the supervisor)",
    )
    args = parser.parse_args(argv)
    return run_worker(args.spec)


if __name__ == "__main__":
    sys.exit(main())
