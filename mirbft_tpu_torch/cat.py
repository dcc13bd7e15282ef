"""mirbft_tpu_torch.cat — the recorded-log inspection / replay CLI.

Rebuild of the reference's mircat tool (reference: mircat/main.go:419-563,
mircat/textmarshal.go): filter a recorded event log by node / event type /
message type / index range, print each event in a truncated text form,
replay the log against fresh StateMachines to any index and print the
status snapshot there, report per-node event counts, and diff two logs to
their first divergence.

Usage:
  python -m mirbft_tpu_torch.cat run.gz
  python -m mirbft_tpu_torch.cat run.gz --node 0 --node 2 --event-type EventStep
  python -m mirbft_tpu_torch.cat run.gz --msg-type Preprepare --from-index 100 --to-index 200
  python -m mirbft_tpu_torch.cat run.gz --status-at 500 --pretty
  python -m mirbft_tpu_torch.cat --diff a.gz b.gz
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from . import pb
from .eventlog import Player, first_divergence, read_log


# ---------------------------------------------------------------------------
# Truncating text marshal (reference: mircat/textmarshal.go:22-33)
# ---------------------------------------------------------------------------

_MAX_BYTES_SHOWN = 4


def text(value, max_bytes: int = _MAX_BYTES_SHOWN) -> str:
    """Render a pb message compactly, truncating byte fields."""
    if value is None:
        return "-"
    if isinstance(value, bytes):
        if len(value) <= max_bytes:
            return value.hex() or "''"
        return f"{value[:max_bytes].hex()}…({len(value)}B)"
    if isinstance(value, (int, str, bool)):
        return str(value)
    if isinstance(value, (list, tuple)):
        if len(value) > 3:
            inner = ", ".join(text(v, max_bytes) for v in value[:3])
            return f"[{inner}, …{len(value)} total]"
        return "[" + ", ".join(text(v, max_bytes) for v in value) + "]"
    if dataclasses.is_dataclass(value):
        fields = []
        for f in dataclasses.fields(value):
            v = getattr(value, f.name)
            if v in (None, b"", 0, [], False) and f.name != "type":
                continue
            fields.append(f"{f.name}={text(v, max_bytes)}")
        name = type(value).__name__
        return f"{name}{{{', '.join(fields)}}}"
    return repr(value)


def event_kind(event: pb.StateEvent) -> str:
    return type(event.type).__name__


def msg_kinds(event: pb.StateEvent) -> set:
    """Wire-message kinds carried by the event (a coalesced EventStepBatch
    can carry several; a --msg-type filter matches if any inner msg does)."""
    inner = event.type
    if isinstance(inner, pb.EventStep) and inner.msg is not None:
        return {type(inner.msg.type).__name__}
    if isinstance(inner, pb.EventStepBatch):
        return {type(m.type).__name__ for m in inner.msgs}
    return set()


# ---------------------------------------------------------------------------
# Filtering / commands
# ---------------------------------------------------------------------------


def filter_events(events, args):
    for index, recorded in enumerate(events):
        if args.from_index is not None and index < args.from_index:
            continue
        if args.to_index is not None and index > args.to_index:
            continue
        if args.node and recorded.node_id not in args.node:
            continue
        if args.event_type and event_kind(recorded.state_event) not in args.event_type:
            continue
        if args.msg_type:
            kinds = msg_kinds(recorded.state_event)
            if not kinds or kinds.isdisjoint(args.msg_type):
                continue
        yield index, recorded


def cmd_list(events, args, out) -> None:
    shown = 0
    for index, recorded in filter_events(events, args):
        line = (
            f"[{index:6d}] t={recorded.time_ms:<8d} node={recorded.node_id} "
            f"{text(recorded.state_event.type)}"
        )
        print(line, file=out)
        shown += 1
    print(f"# {shown}/{len(events)} events shown", file=out)


def cmd_summary(events, out) -> None:
    per_node: dict[int, int] = {}
    per_kind: dict[str, int] = {}
    for recorded in events:
        per_node[recorded.node_id] = per_node.get(recorded.node_id, 0) + 1
        kind = event_kind(recorded.state_event)
        per_kind[kind] = per_kind.get(kind, 0) + 1
    print(f"# events: {len(events)}", file=out)
    for node in sorted(per_node):
        print(f"# node {node}: {per_node[node]} events", file=out)
    for kind in sorted(per_kind):
        print(f"# {kind}: {per_kind[kind]}", file=out)


def cmd_status(events, args, out) -> None:
    from .status import state_machine_status

    player = Player(events)
    upto = args.status_at if args.status_at >= 0 else len(events)
    player.play(upto=upto)
    for node_id in sorted(player.nodes):
        machine = player.nodes[node_id].machine
        print(f"=== node {node_id} @ event {player.position} ===", file=out)
        try:
            status = state_machine_status(machine)
        except Exception as err:  # machine may be mid-bootstrap at this index
            print(f"(status unavailable: {err})", file=out)
            continue
        print(status.pretty() if args.pretty else status.to_json(), file=out)


def render_actions(actions, out, max_bytes: int = 16) -> None:
    """Textual rendering of one event's emitted Actions (the reference CLI
    prints aggregated actions during replay, mircat/main.go:419-503)."""
    if actions.is_empty():
        print("  (no actions)", file=out)
        return
    for send in actions.sends:
        print(
            f"  send {list(send.targets)}: {text(send.msg.type, max_bytes)}",
            file=out,
        )
    for fwd in actions.forward_requests:
        print(
            f"  forward {list(fwd.targets)}: "
            f"{text(fwd.request_ack, max_bytes)}",
            file=out,
        )
    for hr in actions.hashes:
        size = sum(len(chunk) for chunk in hr.data)
        print(
            f"  hash {size}B -> {text(hr.origin.type, 8)}",
            file=out,
        )
    for write in actions.write_ahead:
        if write.append is not None:
            print(
                f"  persist [{write.append.index}] "
                f"{text(write.append.data.type, max_bytes)}",
                file=out,
            )
        else:
            print(f"  truncate < {write.truncate}", file=out)
    for store in actions.store_requests:
        print(f"  store {text(store.request_ack, max_bytes)}", file=out)
    for commit in actions.commits:
        if commit.batch is not None:
            print(f"  commit {text(commit.batch, max_bytes)}", file=out)
        else:
            print(
                f"  checkpoint seq={commit.checkpoint.seq_no}",
                file=out,
            )
    if actions.state_transfer is not None:
        print(
            f"  state-transfer seq={actions.state_transfer.seq_no}",
            file=out,
        )


def cmd_actions(events, args, out) -> None:
    """Replay the log and print the Actions the state machine emitted at
    the chosen event indices."""
    wanted = set(args.actions_at)
    player = Player(events)
    limit = max(wanted) + 1
    while player.position < limit:
        recorded = player.step()
        if recorded is None:
            break
        index = player.position - 1
        if index not in wanted:
            continue
        print(
            f"=== actions @ event {index} (node {recorded.node_id}, "
            f"{event_kind(recorded.state_event)}) ===",
            file=out,
        )
        render_actions(player.nodes[recorded.node_id].actions, out)
    missing = [i for i in sorted(wanted) if i >= len(events)]
    for i in missing:
        print(f"# event {i} is beyond the log ({len(events)} events)", file=out)


def cmd_timing(events, out) -> None:
    """Replay the log and report per-node state-machine execution time
    (the reference CLI's per-node report, mircat/main.go:497-499)."""
    import time as _time

    player = Player(events)
    wall: dict[int, float] = {}
    applied: dict[int, int] = {}
    while True:
        start = _time.perf_counter()
        recorded = player.step()
        elapsed = _time.perf_counter() - start
        if recorded is None:
            break
        node_id = recorded.node_id
        wall[node_id] = wall.get(node_id, 0.0) + elapsed
        applied[node_id] = applied.get(node_id, 0) + 1
    for node_id in sorted(wall):
        total_ms = 1e3 * wall[node_id]
        per_event_us = 1e6 * wall[node_id] / applied[node_id]
        print(
            f"# node {node_id}: {applied[node_id]} events, "
            f"{total_ms:.1f} ms state-machine time "
            f"({per_event_us:.1f} us/event)",
            file=out,
        )


def cmd_diff(path_a: str, path_b: str, out) -> int:
    events_a = read_log(path_a)
    events_b = read_log(path_b)
    div = first_divergence(events_a, events_b)
    if div is None:
        print(f"# logs identical ({len(events_a)} events)", file=out)
        return 0
    index, ea, eb = div
    print(f"# first divergence at event {index}", file=out)
    for name, recorded in (("a", ea), ("b", eb)):
        if recorded is None:
            print(f"{name}: <log ended>", file=out)
        else:
            print(
                f"{name}: t={recorded.time_ms} node={recorded.node_id} "
                f"{text(recorded.state_event.type, max_bytes=8)}",
                file=out,
            )
    return 1


def main(argv=None, out=sys.stdout) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mirbft_tpu_torch.cat", description=__doc__.split("\n")[0]
    )
    parser.add_argument("log", nargs="?", help="recorded event log (.gz)")
    parser.add_argument("--node", type=int, action="append", default=[],
                        help="only events for this node (repeatable)")
    parser.add_argument("--event-type", action="append", default=[],
                        help="only this StateEvent kind, e.g. EventStep")
    parser.add_argument("--msg-type", action="append", default=[],
                        help="only Step events carrying this msg kind, e.g. Preprepare")
    parser.add_argument("--from-index", type=int, default=None)
    parser.add_argument("--to-index", type=int, default=None)
    parser.add_argument("--summary", action="store_true",
                        help="per-node / per-kind event counts only")
    parser.add_argument("--status-at", type=int, default=None,
                        help="replay to this index and print every node's status "
                             "(-1 = end of log)")
    parser.add_argument("--actions-at", type=int, action="append", default=[],
                        help="replay and print the Actions emitted at this "
                             "event index (repeatable)")
    parser.add_argument("--timing", action="store_true",
                        help="replay and report per-node state-machine "
                             "execution time")
    parser.add_argument("--pretty", action="store_true",
                        help="ASCII status dashboard instead of JSON")
    parser.add_argument("--diff", nargs=2, metavar=("A", "B"),
                        help="diff two logs to their first divergence")
    args = parser.parse_args(argv)

    if args.diff:
        return cmd_diff(args.diff[0], args.diff[1], out)
    if not args.log:
        parser.error("a log path (or --diff A B) is required")

    events = read_log(args.log)
    if args.summary:
        cmd_summary(events, out)
    elif args.actions_at:
        cmd_actions(events, args, out)
    elif args.timing:
        cmd_timing(events, out)
    elif args.status_at is not None:
        cmd_status(events, args, out)
    else:
        cmd_list(events, args, out)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        sys.exit(0)  # e.g. `... | head` closed the pipe: not an error
