"""CLI entry: ``python -m mirbft_tpu_torch.chaos [--seed N] [--seeds K]
[--smoke] [--live] [--adversary] [--cluster {threads,mp}] [--only S]
[--budget S] [--processor KIND] [--json] [--list] [--device {cuda,cpu}]``.

``--json`` replaces the human report with one JSON document per
campaign; each failed scenario carries a ``dump`` field pointing at the
flight-recorder segment flushed when its invariant fired (feed the
directory to ``python -m mirbft_tpu_torch.obsv --postmortem``).

``--live`` runs the campaign against a real loopback TCP cluster
instead of the deterministic testengine; ``--smoke`` selects each
mode's tier-1 subset; ``--adversary`` swaps in the Byzantine matrix
(corrupting, equivocating, censoring, and flooding leaders) on either
engine.  ``--cluster`` picks the live cluster shape: ``threads``
(chaos/live.py: every node in this process) or ``mp`` (cluster/: one
worker process a node, ``mp_matrix()``, or ``mp_adversary_matrix()``
with ``--adversary``; ``--smoke`` keeps the acceptance pair and the
dedup storm: ``crash-restart``, ``partition-minority`` and
``retry-storm-dedup``; each scenario's budget is at least 180 s).

The kernels run on ``--device``: ``cuda`` (the default; the run raises
without a card) or ``cpu`` (their plain versions).  ``--processor``
picks the executor every live replica builds (default ``cuda``); an
mp worker runs its kernels on ``--device`` too.

Exit status 0 iff every selected scenario passed all invariants (under
every seed of the sweep, when ``--seeds`` > 1)."""

from __future__ import annotations

import argparse
import json
import sys

from ..runtime.processor import PROCESSOR_KINDS
from .live import run_live_campaign
from .runner import run_campaign
from .scenarios import (
    adversary_matrix,
    adversary_smoke_matrix,
    live_adversary_matrix,
    live_matrix,
    live_smoke_matrix,
    matrix,
    smoke_matrix,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mirbft_tpu_torch.chaos",
        description="Seeded chaos campaign over the mirbft-tpu testengine "
        "(deterministic) or a real loopback TCP cluster (--live).",
    )
    parser.add_argument(
        "--seed", type=int, default=0, help="campaign base seed (default 0)"
    )
    parser.add_argument(
        "--seeds",
        type=int,
        default=1,
        metavar="N",
        help="sweep N campaigns at seeds seed..seed+N-1 (default 1)",
    )
    parser.add_argument(
        "--smoke",
        action="store_true",
        help="run only the tier-1 smoke subset",
    )
    parser.add_argument(
        "--live",
        action="store_true",
        help="run against a real loopback TCP cluster (real nodes, "
        "sockets, fsyncs) instead of the deterministic testengine",
    )
    parser.add_argument(
        "--adversary",
        action="store_true",
        help="run the Byzantine adversary matrix (corrupting, "
        "equivocating, censoring, and flooding leaders) instead of the "
        "crash/partition fault matrix",
    )
    parser.add_argument(
        "--cluster",
        default="threads",
        choices=("threads", "mp"),
        help="live cluster shape (--live only): threads = all nodes in "
        "this process, mp = one worker process per node",
    )
    parser.add_argument(
        "--only",
        default=None,
        help="run only scenarios whose name contains this substring",
    )
    parser.add_argument(
        "--budget",
        type=float,
        default=90.0,
        metavar="S",
        help="per-scenario wall-clock budget in seconds (--live only, "
        "default 90)",
    )
    parser.add_argument(
        "--processor",
        default="cuda",
        choices=tuple(PROCESSOR_KINDS),
        help="action executor every live replica runs (--live only, "
        "default cuda); the full fault matrix must pass under any of "
        "them",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="print one machine-readable JSON document per campaign "
        "instead of the human report; failed scenarios carry the flight "
        "recorder dump path under 'dump'",
    )
    parser.add_argument(
        "--list", action="store_true", help="list scenarios and exit"
    )
    parser.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="where the kernels run: cuda (default; raises without a "
        "card) or cpu (their plain versions)",
    )
    args = parser.parse_args(argv)

    if args.live and args.cluster == "mp":
        # The mp matrix is already the smoke-sized pair + the dedup
        # storm + the reconfiguration set; process-per-node runs are too
        # heavy for a long matrix.
        from ..cluster.chaos_mp import (
            MP_SMOKE_NAMES,
            mp_adversary_matrix,
            mp_matrix,
        )

        if args.adversary:
            scenarios = mp_adversary_matrix()
        elif args.smoke:
            keep = set(MP_SMOKE_NAMES) | {"retry-storm-dedup"}
            scenarios = [s for s in mp_matrix() if s.name in keep]
        else:
            scenarios = mp_matrix()
    elif args.live:
        if args.adversary:
            scenarios = live_adversary_matrix()
        else:
            scenarios = live_smoke_matrix() if args.smoke else live_matrix()
    elif args.adversary:
        scenarios = (
            adversary_smoke_matrix() if args.smoke else adversary_matrix()
        )
    else:
        scenarios = smoke_matrix() if args.smoke else matrix()
    if args.only:
        scenarios = [s for s in scenarios if args.only in s.name]
    if not scenarios:
        print("no scenarios match", file=sys.stderr)
        return 2
    if args.list:
        for scenario in scenarios:
            print(f"{scenario.name:<28} {scenario.description}")
        return 0

    if args.seeds < 1:
        print("--seeds must be >= 1", file=sys.stderr)
        return 2
    all_passed = True
    good_campaigns = 0
    for seed in range(args.seed, args.seed + args.seeds):
        if args.live and args.cluster == "mp":
            from ..cluster.chaos_mp import run_mp_campaign

            campaign = run_mp_campaign(
                scenarios,
                seed=seed,
                budget_s=max(args.budget, 180.0),
                processor=args.processor,
                device=args.device,
            )
        elif args.live:
            campaign = run_live_campaign(
                scenarios,
                seed=seed,
                budget_s=args.budget,
                processor=args.processor,
                device=args.device,
            )
        else:
            campaign = run_campaign(scenarios, seed=seed, device=args.device)
        if args.json:
            print(json.dumps(campaign.to_dict(), indent=2), flush=True)
        else:
            print(campaign.report(), flush=True)
        all_passed = all_passed and campaign.passed
        good_campaigns += campaign.passed
    if args.seeds > 1:
        print(
            f"sweep seeds={args.seed}..{args.seed + args.seeds - 1}: "
            f"{good_campaigns}/{args.seeds} campaigns passed"
        )
    return 0 if all_passed else 1


if __name__ == "__main__":
    sys.exit(main())
