"""The port's log CLI (mirbft_tpu_torch/cat.py) held against the JAX
package's ``cat``.

Mirrors tests/test_cat.py on the port (text, listing and filters,
summary, status replay, diff, timing, actions replay), and runs both CLIs
on one log: each package's CLI prints the same report for a log the
other package wrote (the timing report, which prints wall times, is
compared by its lines' shape)."""

import io

from mirbft_tpu import cat as ref_cat
from mirbft_tpu_torch import pb
from mirbft_tpu_torch.cat import main, text
from mirbft_tpu_torch.eventlog import EngineLog, write_log
from mirbft_tpu_torch.testengine import BasicRecorder
from mirbft_tpu_torch.testengine.crypto_plane import CoalescingHashPlane


def _record_run(tmp_path, name="run.gz", seed=0):
    path = str(tmp_path / name)
    log = EngineLog(path)
    r = BasicRecorder(4, 2, 3, seed=seed, interceptor=log.interceptor,
                      hash_plane=CoalescingHashPlane())
    r.drain_clients(max_steps=100000)
    log.close()
    return path, log.events


def _run(cli, argv) -> tuple:
    out = io.StringIO()
    status = cli(argv, out=out)
    return status, out.getvalue()


def test_text_truncates_bytes():
    rendered = text(pb.RequestAck(client_id=1, req_no=2, digest=b"\xaa" * 32))
    assert "aaaaaaaa…(32B)" in rendered
    assert "client_id=1" in rendered


def test_list_and_filters(tmp_path):
    path, events = _record_run(tmp_path)
    status, listing = _run(main, [path])
    assert status == 0
    assert f"# {len(events)}/{len(events)} events shown" in listing

    _, out = _run(main, [path, "--node", "0", "--event-type", "EventStep"])
    for line in out.splitlines():
        if line.startswith("#"):
            continue
        assert "node=0" in line and "EventStep" in line

    _, out = _run(main, [path, "--msg-type", "Preprepare"])
    body = [line for line in out.splitlines() if not line.startswith("#")]
    assert body and all("Preprepare" in line for line in body)


def test_summary(tmp_path):
    path, events = _record_run(tmp_path)
    _, summary = _run(main, [path, "--summary"])
    assert f"# events: {len(events)}" in summary
    for node in range(4):
        assert f"# node {node}:" in summary


def test_status_replay(tmp_path):
    path, _events = _record_run(tmp_path)
    _, status = _run(main, [path, "--status-at", "-1"])
    for node in range(4):
        assert f"=== node {node} " in status
    assert '"' in status

    _, pretty = _run(main, [path, "--status-at", "-1", "--pretty"])
    assert "===" in pretty


def test_diff(tmp_path):
    path_a, events_a = _record_run(tmp_path, "a.gz")
    path_b, _ = _record_run(tmp_path, "b.gz")
    status, out = _run(main, ["--diff", path_a, path_b])
    assert status == 0 and "identical" in out

    mutated = [
        (e.node_id, e.time_ms + (7 if i == 10 else 0), e.state_event)
        for i, e in enumerate(events_a)
    ]
    path_c = str(tmp_path / "c.gz")
    write_log(path_c, mutated, redact=False)
    status, out = _run(main, ["--diff", path_a, path_c])
    assert status == 1
    assert "first divergence at event 10" in out


def test_timing_report(tmp_path):
    path, _events = _record_run(tmp_path)
    status, report = _run(main, [path, "--timing"])
    assert status == 0
    for node in range(4):
        assert f"# node {node}: " in report
    assert "us/event" in report


def test_actions_replay(tmp_path):
    path, events = _record_run(tmp_path)
    propose_idx = next(
        i for i, e in enumerate(events)
        if isinstance(e.state_event.type, (pb.EventPropose,
                                           pb.EventProposeBatch))
    )
    status, report = _run(main, [path, "--actions-at", str(propose_idx)])
    assert status == 0
    assert f"=== actions @ event {propose_idx}" in report
    assert "hash" in report

    status, report = _run(main, [path, "--actions-at", str(len(events) + 5)])
    assert status == 0 and "beyond the log" in report


def test_both_clis_print_the_same_reports(tmp_path):
    """The port's CLI and the JAX package's on the port's log: the same
    listing, filters, summary, status replay, actions replay and diff."""
    path_a, events = _record_run(tmp_path, "a.gz")
    mutated = [
        (e.node_id, e.time_ms + (3 if i == 20 else 0), e.state_event)
        for i, e in enumerate(events)
    ]
    path_b = str(tmp_path / "b.gz")
    write_log(path_b, mutated, redact=False)
    for argv in (
        [path_a],
        [path_a, "--node", "1", "--msg-type", "Commit"],
        [path_a, "--from-index", "10", "--to-index", "40"],
        [path_a, "--summary"],
        [path_a, "--status-at", "60", "--pretty"],
        [path_a, "--actions-at", "5"],
        ["--diff", path_a, path_b],
    ):
        assert _run(main, argv) == _run(ref_cat.main, argv), argv


def test_timing_reports_have_the_same_shape(tmp_path):
    path, _events = _record_run(tmp_path)

    def shape(report):
        return [line.split(":")[0] for line in report.splitlines()]

    ours, theirs = _run(main, [path, "--timing"]), _run(
        ref_cat.main, [path, "--timing"])
    assert ours[0] == theirs[0] and shape(ours[1]) == shape(theirs[1])
