"""Does the signed-ingress rung's epoch-change stall belong to the port or
to the JAX package?  Both packages' in-process clusters, on the CPU, at
chip_smoke phase 16's configuration.

The configuration is ``mirbft_tpu_torch.bench``'s ``INGRESS_*`` constants:
4 nodes, BatchSize 4, tick 0.04 s, clients 1-3 from
``standard_client_models`` signed, Poisson steps of 25, 50 and 100 req/s
of 2 s each (generator seed 11, arrivals seeded with the rate), a 25 s
drain, a forged twin of every 8th request.  On both sides every node
hashes on the host and a ``SpeculativeIngress`` sits in front of its
propose, verifying on that package's own
``testengine.signing.host_verifier``, so the compute behind the protocol
is the same on both sides.  This host verifier is a named reference
route for this comparison; the port's rung (``bench.ingress_run``) keeps
its kernel verifier.

The processor kind is ``serial`` by default, not phase 16's pipelined
one: the JAX package's in-process cluster cannot run ``pipelined``.  Its
``MemWal.wait(token)`` takes no ``timeout``, which the pipelined
processor's durability barrier passes, so every JAX node stops at its
first persisted batch and nothing commits (``--processor pipelined``
shows it: the run reports each node's failure).  Both kinds hash on the
host with hashlib; ``serial`` does it on the node's consumer thread.

For each package and each of ``--reps`` runs it prints, per step, the
goodput, p50 and p95, the epoch each node ends the step at, the epochs
that failed in the step (a node entered the epoch and left it for a
higher one with nothing committed in it: its log's sequence number did
not move), and the requests slower than 1 s with their sequence numbers,
as ``tests/ingress_epochs.py`` prints them.  A sampler thread reads each
node's epoch target and log every 50 ms.  Then one line a package: in
how many steps an epoch change was followed by a failed first epoch.
The last line starts ``SUMMARY`` and holds the counts as JSON.

    python3 tests/epoch_stall_compare.py [--reps 5] [--packages port jax]
        [--processor serial|pipelined]

About two minutes a package at five runs on an 8-core host.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import random
import statistics
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PACKAGES = {"port": "mirbft_tpu_torch", "jax": "mirbft_tpu"}

#: A signed request's data ends with the 64-byte signature and the 32-byte
#: public key; S, the signature's second half, is data[-64:-32].
S_AT = (64, 32)


class Front:
    """The load generator's cluster: ``submit`` hands a request to the
    node's ingress stage, and every ``forge_every``-th distinct request
    gets a forged twin (one seeded bit of S flipped) right after the
    honest one's first submission to each node, as phase 16 sends them."""

    def __init__(self, cluster, ingress, request_cls, forge_every, seed):
        self.cluster = cluster
        self.ingress = ingress
        self.request_cls = request_cls
        self.forge_every = forge_every
        self.node_ids = cluster.node_ids
        self._rng = random.Random(seed)
        self.honest: dict = {}
        self.forged: dict = {}
        self._sent: set = set()

    def poll_commits(self) -> list:
        return self.cluster.poll_commits()

    def _forge(self, data: bytes) -> bytes:
        start, end = S_AT
        s = bytearray(data[-start:-end])
        bit = self._rng.randrange(8 * len(s))
        s[bit // 8] ^= 1 << (bit % 8)
        return data[:-start] + bytes(s) + data[-end:]

    def submit(self, node_id: int, request) -> None:
        key = (request.client_id, request.req_no)
        if key not in self.honest:
            self.honest[key] = request.data
            if len(self.honest) % self.forge_every == 0:
                self.forged[key] = self._forge(request.data)
        self.ingress[node_id].submit(request)
        forged = self.forged.get(key)
        if forged is not None and (*key, node_id) not in self._sent:
            self._sent.add((*key, node_id))
            self.ingress[node_id].submit(self.request_cls(
                client_id=request.client_id, req_no=request.req_no,
                data=forged,
            ))


def epoch_tracker(replica, timeout: float):
    """The node's epoch target status, or None where the node has none
    yet or did not answer within ``timeout`` (a busy or stopping node)."""
    try:
        status = replica.node.status(timeout=timeout)
    except Exception:  # noqa: BLE001 — a node stopping
        return None
    return None if status is None else status.epoch_tracker


class EpochSampler(threading.Thread):
    """Every ``period`` s, each node's (time, epoch number, target state,
    last applied sequence number)."""

    def __init__(self, cluster, period: float = 0.05):
        super().__init__(daemon=True, name="epoch-sampler")
        self.cluster = cluster
        self.period = period
        self.samples = {r.node_id: [] for r in cluster.replicas}
        self._stop_event = threading.Event()

    def run(self) -> None:
        while not self._stop_event.wait(self.period):
            for replica in self.cluster.replicas:
                tracker = epoch_tracker(replica, 1.0)
                if tracker is None:
                    continue
                self.samples[replica.node_id].append((
                    time.monotonic_ns(), tracker.number, tracker.state,
                    replica.app_log.last_seq,
                ))

    def stop(self) -> None:
        self._stop_event.set()
        self.join()


def failed_epochs(samples: list) -> list:
    """(time left, epoch) of each epoch a node entered and left for a
    higher one with its log's sequence number unchanged from the last
    sample before it to the first sample after it.  An epoch the samples
    skipped (a jump of two or more) failed within one period: it counts
    too."""
    segments = []  # [epoch, first sample, last sample]
    for sample in samples:
        if segments and segments[-1][0] == sample[1]:
            segments[-1][2] = sample
        else:
            segments.append([sample[1], sample, sample])
    out = []
    for prev, seg, nxt in zip(segments, segments[1:], segments[2:]):
        if nxt[0] > seg[0] > prev[0] and nxt[1][3] == prev[2][3]:
            out.append((nxt[1][0], seg[0]))
    for prev, seg in zip(segments, segments[1:]):
        for skipped in range(prev[0] + 1, seg[0]):
            out.append((seg[1][0], skipped))
    return out


def run_once(name: str, settings: dict, forge_every: int,
             processor: str) -> tuple:
    """One run of the three steps on package ``name``; returns a dict a
    step, and the first node failure the cluster reports (or None)."""
    pkg = PACKAGES[name]
    loadgen = importlib.import_module(f"{pkg}.loadgen")
    pb = importlib.import_module(f"{pkg}.pb")
    ingress_mod = importlib.import_module(f"{pkg}.runtime.ingress")
    signing = importlib.import_module(f"{pkg}.testengine.signing")
    host = importlib.import_module(f"{pkg}.crypto.ed25519_host")

    clients = list(settings["clients"])
    for cid in clients:
        signing.register_pk(cid, host.public_key(signing.client_seed(cid)))
    models = {
        cid: dataclasses.replace(model, signed=True)
        for cid, model in loadgen.standard_client_models(clients).items()
    }
    kw = dict(node_count=settings["nodes"], client_ids=clients,
              batch_size=settings["batch_size"], processor=processor,
              tick_seconds=settings["tick_s"])
    if name == "port":
        kw["device"] = "cpu"
    cluster = loadgen.InProcessCluster(**kw)
    ingress = {}
    sampler = EpochSampler(cluster)
    steps = []
    failure = None
    try:
        for replica in cluster.replicas:
            ingress[replica.node_id] = ingress_mod.SpeculativeIngress(
                replica.node.propose, signing.host_verifier,
                name=f"ingress-{replica.node_id}",
            )
        front = Front(cluster, ingress, pb.Request, forge_every,
                      settings["seed"])
        generator = loadgen.LoadGenerator(front, models,
                                          seed=settings["seed"])
        sampler.start()
        for rate in settings["rates"]:
            began = time.monotonic_ns()
            step = generator.run_step(
                f"ingress-poisson-{int(rate)}",
                loadgen.PoissonArrivals(rate, seed=int(rate)),
                duration_s=settings["step_s"], drain_s=settings["drain_s"],
            )
            ended = time.monotonic_ns()
            epochs = [epoch_tracker(r, 5.0) for r in cluster.replicas]
            epochs = [None if t is None else t.number for t in epochs]
            records = sorted(step.records, key=lambda r: r["submit_ns"])
            start = records[0]["submit_ns"] if records else 0
            slow = [
                (round((r["submit_ns"] - start) / 1e6),
                 round((r["commit_ns"] - r["submit_ns"]) / 1e6), r["seq"])
                for r in records if r["commit_ns"] - r["submit_ns"] > 1e9
            ]
            steps.append({"name": step.name, "step": step, "epochs": epochs,
                          "slow": slow, "window": (began, ended)})
        try:
            cluster.check()
        except Exception as err:  # noqa: BLE001 — reported, not raised
            failure = f"{type(err).__name__}: {err}"
    finally:
        sampler.stop()
        for stage in ingress.values():
            stage.close()
        cluster.close()
    for entry in steps:
        began, ended = entry["window"]
        entry["failed"] = sorted(
            (node, epoch)
            for node, samples in sampler.samples.items()
            for left, epoch in failed_epochs(samples)
            if began <= left < ended
        )
    return steps, failure


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--packages", nargs="+", default=["port", "jax"],
                        choices=sorted(PACKAGES))
    parser.add_argument("--processor", default="serial",
                        choices=["serial", "pipelined"])
    args = parser.parse_args(argv)

    from mirbft_tpu_torch import bench
    from mirbft_tpu_torch.runtime.node import standard_initial_network_state

    settings = dict(
        nodes=bench.INGRESS_NODES, clients=bench.INGRESS_CLIENTS,
        batch_size=bench.INGRESS_BATCH_SIZE, rates=bench.INGRESS_RATES,
        step_s=bench.INGRESS_STEP_S, drain_s=bench.INGRESS_DRAIN_S,
        seed=bench.INGRESS_SEED, tick_s=bench.INGRESS_TICK_S,
    )
    forge_every = bench.INGRESS_FORGE_EVERY
    config = standard_initial_network_state(
        settings["nodes"], settings["clients"]).config
    print(f"settings {settings}, forged twin every {forge_every}, "
          f"processor {args.processor}; "
          f"max_epoch_length {config.max_epoch_length}, checkpoint interval "
          f"{config.checkpoint_interval}", flush=True)
    summary = {}
    for name in args.packages:
        stalled = steps_total = failures = slow_total = 0
        committed = submitted = 0
        p50s, node_failures = [], []
        for rep in range(args.reps):
            steps, failure = run_once(name, settings, forge_every,
                                      args.processor)
            if failure is not None:
                node_failures.append(failure)
                print(f"{name} run {rep}: a node failed: {failure}",
                      flush=True)
            for entry in steps:
                step = entry["step"]
                steps_total += 1
                stalled += bool(entry["failed"])
                failures += len(entry["failed"])
                slow_total += len(entry["slow"])
                committed += step.committed
                submitted += step.submitted
                p50s.append(step.p50_ms)
                print(
                    f"{name} run {rep} {step.name}: committed "
                    f"{step.committed} of {step.submitted}, goodput "
                    f"{step.goodput_per_sec:.3f} req/s, p50 "
                    f"{step.p50_ms:.3f} ms, p95 {step.p95_ms:.3f} ms, "
                    f"epochs after {entry['epochs']}, failed epochs "
                    f"(node, epoch) {entry['failed']}; {len(entry['slow'])} "
                    f"slower than 1 s (submit ms, latency ms, seq), first: "
                    f"{entry['slow'][:4]}, seqs "
                    f"{sorted({s for _t, _l, s in entry['slow']})[:8]}",
                    flush=True,
                )
        summary[name] = {
            "steps": steps_total, "steps_with_failed_first_epoch": stalled,
            "failed_epochs": failures, "slow_requests": slow_total,
            "committed": committed, "submitted": submitted,
            "median_p50_ms": statistics.median(p50s) if p50s else None,
            "runs_with_a_node_failure": len(node_failures),
        }
        print(f"{name} ({PACKAGES[name]}): an epoch change followed by a "
              f"failed first epoch in {stalled} of {steps_total} steps "
              f"({failures} failed epochs over the nodes; {slow_total} "
              f"requests slower than 1 s; {committed} of {submitted} "
              f"committed within the drain)", flush=True)
    print("SUMMARY", json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
