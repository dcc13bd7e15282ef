"""``python -m mirbft_tpu_torch.obsv`` — instrumented ladder, merge, and diff.

Default mode runs a seeded Recorder with the observability plane
enabled — every digest on the SHA-256 kernel on ``cuda`` (``--device
cpu``: the kernel's plain version; without a card and without ``cpu``
the run raises) — prints the per-phase consensus latency table
(p50/p95/p99), and optionally writes a Chrome trace-event file (``--trace``, open in
ui.perfetto.dev), N per-node trace files plus their merge
(``--trace-dir``), the Prometheus exposition (``--prom``), or the
registry JSON (``--json``).

Tool modes (mutually exclusive with the run):

- ``--merge OUT IN [IN ...]`` — merge per-node traces into one
  Perfetto-loadable file with per-node process lanes (obsv/merge.py).
- ``--diff A B [--threshold PCT]`` — compare two trace/bench artifacts;
  prints a human summary plus one machine-readable JSON line, exits
  nonzero on a >= threshold regression, a ``growing`` resource-leak
  verdict in B, a device retrace-budget breach in B, or any recorded
  scalar/vector divergence in B (obsv/diff.py).  Either path may be a
  ``BENCH_stream.jsonl`` journal — torn or killed runs are recovered
  from their stage lines automatically.
- ``--postmortem DIR [--out PATH]`` — merge every node's newest flight
  recorder dump under DIR into one clock-aligned causal timeline ending
  at the failure (obsv/recorder.py); ``--out`` also writes the merged
  Chrome trace for Perfetto.
- ``--critpath DIR`` — build the per-request critical-path ledger from
  a run directory (per-node ``trace*.json`` files, optional
  ``records.json`` loadgen records) and print the per-percentile-band
  saturation attribution: which phase dominated, on which node
  (obsv/critpath.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import hooks
from .timeline import TimelineProfiler


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mirbft_tpu_torch.obsv",
        description="Run an instrumented testengine ladder and report "
        "per-phase consensus latency; or merge/diff trace artifacts.",
    )
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--clients", type=int, default=4)
    # Long enough that the run must pass stable checkpoints to keep
    # committing (>2 checkpoint windows), so the checkpoint phase has
    # samples in the table.
    parser.add_argument("--reqs", type=int, default=60,
                        help="requests per client")
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the run's digests are computed: the "
                        "SHA-256 kernel on the card (default), or its "
                        "plain version on the CPU")
    parser.add_argument("--sample-rate", type=float, default=None,
                        help="deterministic span sampling rate in (0,1]; "
                        "milestones/flows always kept")
    parser.add_argument("--trace", metavar="PATH",
                        help="write a Chrome trace-event JSON file")
    parser.add_argument("--trace-dir", metavar="DIR",
                        help="write per-node trace files plus merged.json")
    parser.add_argument("--prom", action="store_true",
                        help="print Prometheus text exposition")
    parser.add_argument("--json", action="store_true",
                        help="print the registry snapshot as JSON")
    parser.add_argument("--merge", nargs="+", metavar="PATH",
                        help="merge mode: OUT IN [IN ...]")
    parser.add_argument("--diff", nargs=2, metavar=("A", "B"),
                        help="diff mode: compare two trace/bench artifacts")
    parser.add_argument("--threshold", type=float, default=None,
                        help="regression threshold percent for --diff")
    parser.add_argument("--postmortem", metavar="DIR",
                        help="postmortem mode: merge flight recorder "
                        "dumps under DIR into one causal timeline")
    parser.add_argument("--critpath", metavar="DIR",
                        help="critical-path mode: per-request phase "
                        "attribution from a run directory of per-node "
                        "trace*.json files (+ optional records.json)")
    parser.add_argument("--out", metavar="PATH",
                        help="write the merged postmortem trace here "
                        "(--postmortem only)")
    parser.add_argument("--limit", type=int, default=200,
                        help="timeline lines to print (--postmortem, "
                        "default 200)")
    args = parser.parse_args(argv)

    if args.postmortem:
        return _postmortem_main(args)
    if args.critpath:
        return _critpath_main(args)
    if args.diff:
        return _diff_main(args)
    if args.merge:
        return _merge_main(args)
    return _run_main(args)


def _critpath_main(args) -> int:
    from .critpath import attribute, attribution_table, ledger_from_dir

    try:
        ledger, n_traces = ledger_from_dir(args.critpath)
    except (FileNotFoundError, NotADirectoryError) as exc:
        print(str(exc), file=sys.stderr)
        return 2
    if not n_traces:
        print(f"no trace*.json files under {args.critpath}", file=sys.stderr)
        return 2
    attribution = attribute(ledger)
    print(
        f"critpath: {len(ledger)} committed flow(s) from {n_traces} "
        f"node trace(s) under {args.critpath}"
    )
    print()
    print(attribution_table(attribution))
    print(json.dumps({"bands": attribution}))
    return 0


def _diff_main(args) -> int:
    from .diff import DEFAULT_THRESHOLD_PCT, diff_files, render_report

    threshold = (
        args.threshold if args.threshold is not None else DEFAULT_THRESHOLD_PCT
    )
    report = diff_files(args.diff[0], args.diff[1], threshold_pct=threshold)
    print(render_report(report))
    print(json.dumps(report))
    return 0 if report["ok"] else 1


def _postmortem_main(args) -> int:
    from .recorder import postmortem

    try:
        result = postmortem(args.postmortem, out_path=args.out,
                            limit=args.limit)
    except FileNotFoundError as exc:
        print(str(exc), file=sys.stderr)
        return 2
    dumps = result["dumps"]
    print(f"postmortem: {len(dumps)} node dump(s) under {args.postmortem}")
    for node, path in sorted(dumps.items()):
        print(f"  node {node}: {path}")
    print()
    print("causal timeline (clock-aligned, oldest first, ends at failure):")
    print(result["timeline"] or "  (no entries)")
    if args.out:
        events = len(result["merged"].get("traceEvents", ()))
        print(f"\nmerged trace ({events} events) written to {args.out} "
              "(open in ui.perfetto.dev)")
    return 0


def _merge_main(args) -> int:
    from .merge import merge_files

    if len(args.merge) < 3:
        print("--merge needs OUT and at least two inputs", file=sys.stderr)
        return 2
    out, inputs = args.merge[0], args.merge[1:]
    merged = merge_files(inputs, out_path=out)
    print(
        f"merged {len(inputs)} traces "
        f"({len(merged['traceEvents'])} events) into {out}"
    )
    return 0


def _run_main(args) -> int:
    # Import after argparse so --help stays instant.
    from ..testengine.crypto_plane import AsyncKernelHashPlane
    from ..testengine.engine import BasicRecorder
    from .merge import merge_traces, split_node_traces

    # Built before the plane is enabled: a run asked for on the card
    # raises here when there is none.
    hash_plane = AsyncKernelHashPlane(device=args.device)

    registry, tracer = hooks.enable(
        trace=True, sample_rate=args.sample_rate, sample_seed=args.seed
    )
    try:
        rec = BasicRecorder(
            args.nodes,
            args.clients,
            args.reqs,
            seed=args.seed,
            batch_size=args.batch_size,
            record=False,
            hash_plane=hash_plane,
        )
        for node in range(args.nodes):
            tracer.name_thread(node, f"node {node}")
        events = rec.drain_clients(max_steps=2_000_000)
        registry.gauge("mirbft_engine_sim_ms").set(rec.now)
        registry.counter("mirbft_engine_events_total").inc(events)

        profiler = TimelineProfiler.from_tracer(tracer)
        print(
            f"run: nodes={args.nodes} clients={args.clients} "
            f"reqs={args.reqs} batch_size={args.batch_size} "
            f"seed={args.seed} device={args.device} -> {events} events, "
            f"sim {rec.now} ms"
        )
        print()
        print("consensus phase latency (simulated ms):")
        print(profiler.table())

        if args.trace:
            tracer.write(args.trace)
            print(f"\ntrace written to {args.trace} "
                  "(open in ui.perfetto.dev)")
        if args.trace_dir:
            os.makedirs(args.trace_dir, exist_ok=True)
            per_node = split_node_traces(tracer, range(args.nodes))
            paths = []
            for node, trace in per_node.items():
                path = os.path.join(args.trace_dir, f"node{node}.trace.json")
                with open(path, "w", encoding="utf-8") as f:
                    json.dump(trace, f)
                paths.append(path)
            merged_path = os.path.join(args.trace_dir, "merged.trace.json")
            with open(merged_path, "w", encoding="utf-8") as f:
                json.dump(merge_traces(per_node.values()), f)
            print(f"\nper-node traces: {', '.join(paths)}")
            print(f"merged trace:    {merged_path} (open in ui.perfetto.dev)")
        if args.prom:
            print()
            print(registry.prometheus_text(), end="")
        if args.json:
            print()
            print(registry.to_json(indent=2))
    finally:
        hooks.disable()
    return 0


if __name__ == "__main__":
    sys.exit(main())
