"""Rung 5 on the JAX package: the recipe of the JAX ``bench.rung5_run``
(``bench.py:844-930``) with its shape as keywords, watched by the port's
``bench.Rung5Watch``, so that the port's ``bench.rung5_run`` can be held
against it case by case.

``late_digest=True`` (the default) runs it with the port's advance on a
late batch digest patched into the JAX ``Sequence`` (ROADMAP queue 3,
item 2): a restart otherwise sends the JAX core down another road.  The
JAX package is imported inside ``jax_rung5`` only, so ``rung5_stage.py``
can import this module on a machine without JAX.

The cuts the tests run (``CUTS``) keep the JAX shape's widths (clients
of width 2 and one request, BatchSize 200, 4 buckets, checkpoints every
20, 20 ms of link jitter) and cut nodes, clients and the schedule.
"""

from __future__ import annotations

import contextlib
import time

#: name -> (nodes, clients, crash_node, crash_after, down_for): 16-node
#: cuts of the JAX schedule (node 13 stands for node 200).
CUTS = {
    # The JAX schedule's road: crashed during the RequestAck flood (192
    # acks in flight to it die) and restarted before the first commit; it
    # commits nothing until it installs the checkpoint at seq 100.
    "during-the-ack-flood": (16, 64, 13, 300, 300),
    # The same crash restarted at once: no time down, the same road.
    "restarted-at-once": (16, 64, 13, 300, 0),
    # Crashed before the flood (a tick in flight): it orders on from its
    # WAL with the others.
    "before-the-ack-flood": (16, 64, 13, 100, 0),
}


def jax_rung5(*, nodes: int, clients: int, crash_node: int,
              crash_after: int, down_for: int, max_steps: int = 50_000_000,
              progress=None, every: int = 50_000,
              late_digest: bool = True) -> dict:
    """The JAX recipe at the given shape; returns the same keys as the
    port's ``bench.rung5_run`` but the hash plane's."""
    from chaos_pin import _late_digest_advances
    from mirbft_tpu import pb
    from mirbft_tpu.testengine.engine import BasicRecorder, RuntimeParameters
    from mirbft_tpu_torch.bench import Rung5Watch

    f = (nodes - 1) // 3
    client_ids = [nodes + i for i in range(clients)]
    state = pb.NetworkState(
        config=pb.NetworkConfig(
            nodes=list(range(nodes)),
            f=f,
            number_of_buckets=4,
            checkpoint_interval=20,
            max_epoch_length=200,
        ),
        clients=[
            pb.NetworkClient(id=c, width=2, low_watermark=0)
            for c in client_ids
        ],
    )
    patch = (_late_digest_advances() if late_digest
             else contextlib.nullcontext())
    with patch:
        watch = Rung5Watch(crash_node, clients, progress=progress,
                           every=every)
        start = time.perf_counter()
        rec = BasicRecorder(
            nodes,
            clients,
            1,
            batch_size=200,
            network_state=state,
            record=False,
            params=RuntimeParameters(link_jitter=20),
        )
        watch.watch(rec)
        for _ in range(crash_after):
            rec.step()
        crash = {
            "node": crash_node,
            "crash_ms": rec.now,
            "crash_events": rec.event_count,
            "committed_anywhere_at_crash": sum(
                len(c.committed_anywhere) for c in rec.clients.values()
            ),
        }
        rec.crash(crash_node)
        for _ in range(down_for):
            rec.step()
        rec.schedule_restart(crash_node, delay=0)
        crash["restart_ms"] = rec.now
        crash["restart_events"] = rec.event_count
        watch.restarted()
        events = rec.drain_clients(max_steps=max_steps)
        wall = time.perf_counter() - start
    chains = {rec.node_states[n].app_chain for n in range(nodes)}
    crash.update(watch.outcome())
    return {
        "events": events,
        "sim_ms": rec.now,
        "wall_s": wall,
        "chains": sorted(c.hex() for c in chains),
        "commits": sorted({rec.committed_at(n) for n in range(nodes)}),
        "crash": crash,
    }
