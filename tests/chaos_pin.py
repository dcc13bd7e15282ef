"""The JAX package's deterministic chaos campaign, row by row: how
``tests/chaos_reference.py`` is made and checked.

``reference_rows`` runs scenarios of ``mirbft_tpu.chaos`` at the seeds
``run_campaign(seed=0)`` gives them (each scenario's index in its matrix)
and returns, per scenario, ``(passed, events, sim_ms, commits, the
violation's first words)`` and, for a scenario with a flaky crypto plane,
the breaker's walk (trips, probes, final state, errors, timeouts).
``late_digest=True`` runs the JAX engine with the port's advance on a late
batch digest patched into its ``Sequence`` (ROADMAP queue 3, item 2).
``port_rows`` reads the same from the port's campaign results.

To write the pin again: ``python3 tests/chaos_pin.py > tests/chaos_reference.py``
(about a minute on the CPU).  The tests hold it against fresh runs
(``tests/test_torch_chaos.py``); this module imports JAX only inside its
functions, and ``chip_smoke.py`` reads only the pin.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

#: Words of a violation kept in a row.
VIOLATION_WORDS = 6


def first_words(violation: str) -> str:
    return " ".join(violation.split()[:VIOLATION_WORDS])


def row(result) -> tuple:
    return (result.passed, result.events, result.sim_ms, result.commits,
            first_words(result.violation))


def walk(plane) -> dict:
    breaker = plane.breaker
    return {
        "trips": breaker.trips,
        "probes": breaker.probes,
        "state": breaker.state,
        "errors": plane.device_errors,
        "timeouts": getattr(plane, "device_timeouts", 0),
    }


def port_walk(counters: dict, prefix: str = "") -> dict:
    """The breaker walk of a port result's counters: the digest plane's
    (``prefix=""``) or the signature plane's (``prefix="sig_"``)."""
    return {
        "trips": counters[f"{prefix}breaker_trips"],
        "probes": counters[f"{prefix}breaker_probes"],
        "state": counters[f"{prefix}breaker"],
        "errors": counters[f"{prefix}device_errors"],
        "timeouts": counters.get(f"{prefix}device_timeouts", 0),
    }


def port_rows(results) -> tuple:
    """``(rows, walks)`` of the port's scenario results."""
    rows, walks = {}, {}
    for result in results:
        rows[result.name] = row(result)
        if "breaker" in result.counters:
            walks[result.name] = port_walk(result.counters)
        elif result.counters.get("sig_device_errors"):
            walks[result.name] = port_walk(result.counters, "sig_")
    return rows, walks


@contextlib.contextmanager
def _late_digest_advances():
    from mirbft_tpu.core.sequence import Sequence

    original = Sequence.apply_batch_hash_result

    def apply_batch_hash_result(self, digest):
        self.digest = digest
        actions = self.apply_prepare_msg(self.owner, digest)
        return actions.concat(self.advance_state())

    Sequence.apply_batch_hash_result = apply_batch_hash_result
    try:
        yield
    finally:
        Sequence.apply_batch_hash_result = original


def _capturing(factory, planes: list):
    def build():
        plane = factory()
        planes.append(plane)
        return plane

    return build


def reference_rows(matrix: str, names=None, late_digest=False) -> tuple:
    """``(rows, walks)`` of the JAX package's ``matrix`` ("matrix" or
    "adversary_matrix") at campaign seed 0, for ``names`` (all if None)."""
    from mirbft_tpu.chaos import runner, scenarios

    rows, walks = {}, {}
    context = (_late_digest_advances() if late_digest
               else contextlib.nullcontext())
    with context:
        for index, scenario in enumerate(getattr(scenarios, matrix)()):
            if names is not None and scenario.name not in names:
                continue
            planes: list = []
            if scenario.hash_plane:
                scenario = dataclasses.replace(
                    scenario,
                    hash_plane=_capturing(scenario.hash_plane, planes))
            if scenario.signature_plane:
                scenario = dataclasses.replace(
                    scenario,
                    signature_plane=_capturing(scenario.signature_plane,
                                               planes))
            result = runner.run_scenario(scenario, seed=index)
            rows[scenario.name] = row(result)
            if planes:
                walks[scenario.name] = walk(planes[0])
    return rows, walks


def _format(name: str, table: dict) -> str:
    lines = [f"{name} = {{"]
    for key, value in table.items():
        lines.append(f"    {key!r}: {value!r},")
    lines.append("}")
    return "\n".join(lines)


def write_pin(out) -> None:
    matrix, walks = reference_rows("matrix")
    adversary, adversary_walks = reference_rows("adversary_matrix")
    walks.update(adversary_walks)
    late_matrix, _ = reference_rows("matrix", late_digest=True)
    late_adversary, _ = reference_rows("adversary_matrix", late_digest=True)
    late = {name: value for name, value in {**late_matrix,
                                            **late_adversary}.items()
            if value != {**matrix, **adversary}[name]}
    out.write(HEADER)
    out.write(_format("MATRIX", matrix) + "\n\n")
    out.write(_format("ADVERSARY", adversary) + "\n\n")
    out.write(LATE_DIGEST_DOC)
    out.write(_format("LATE_DIGEST", late) + "\n\n")
    out.write(BREAKER_DOC)
    out.write(_format("BREAKER", walks) + "\n")


HEADER = '''"""The JAX package's deterministic chaos campaign at seed 0, pinned.

Written by ``python3 tests/chaos_pin.py`` from ``mirbft_tpu.chaos``'s
``run_campaign(matrix(), seed=0)`` and ``run_campaign(adversary_matrix(),
seed=0)``; held against fresh runs by ``tests/test_torch_chaos.py`` (the
smoke rows in tier 1, every row in the slow lane) and against the port's
campaign on the card by ``chip_smoke.py`` phase 20.

Each row: ``(passed, events, sim_ms, commits, the violation's first
words)``.  Two rows are the reference's own failures: ``ack-loss-70pct``
(recovery past its bound) and ``crash-staggered-pair`` (no commit after
the last heal); ROADMAP queue 3 classifies them.
"""

'''

LATE_DIGEST_DOC = '''#: Rows where the JAX engine with the port's advance on a late batch digest
#: (ROADMAP queue 3, item 2: a reference fault the port repairs) differs
#: from the JAX engine as it is.  The port is held to these.
'''

BREAKER_DOC = '''#: The breaker's walk in the scenarios with a flaky crypto plane: the digest
#: plane's, or the signature plane's in ``signed-verifier-dies``.
'''


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    write_pin(sys.stdout)
