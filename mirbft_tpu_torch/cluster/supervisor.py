"""The cluster supervisor: spawn, wire, probe, kill, restart, tear down.

``ClusterSupervisor`` runs an N-node mirbft-tpu cluster as N real OS
processes (``python -m mirbft_tpu_torch.cluster`` workers) under one
scratch root, one directory per node (spec.json, address.json,
peers.json, worker.log, wal/, reqs/, app.log, checkpoints.jsonl,
kernels-<pid>.json, metrics.json).  Every worker runs its kernels on the
supervisor's ``device``: ``cuda`` by default, where a machine without a
card makes the first worker exit at boot and ``start()`` raise
``WorkerDied`` with its log naming the missing card; ``cpu`` runs the
kernels' plain versions.

Lifecycle is a filesystem + HTTP handshake (the worker side is
documented in worker.py):

- ``start()`` writes each node's spec, spawns the workers with stdout
  and stderr redirected to the node's ``worker.log``, collects every
  ``address.json``, optionally interposes a ``PartitionProxy`` on each
  directed edge, publishes ``peers.json``, and polls ``/healthz`` until
  every node reports ``ready: true``.
- ``kill(node, graceful=False)`` is SIGKILL — the real crash the
  in-process chaos driver can only approximate; ``graceful=True`` is
  SIGTERM + drain.  ``restart(node)`` respawns from the node's on-disk
  WAL/reqstore on the *same* transport port, so peer address books and
  proxy upstreams survive the reboot.
- ``teardown()`` SIGTERMs everything, escalates to SIGKILL after a
  grace period, records every worker's exit code (``exit_codes``) and
  kernel evidence (``evidence``, read from each node's
  ``kernels-<pid>.json`` and ``metrics.json`` before the root goes),
  closes proxies, and removes the scratch root.

Client traffic enters through ``submit()``: a dedicated client-side
``TcpTransport`` dials every node directly (client frames bypass the
partition proxies — a partitioned node is cut off from its *peers*, not
from its clients) and ships bare ``pb.Request`` frames that the worker's
transport hands to ``Node.propose``.

``poll_commits()`` tails every node's fsynced ``app.log`` incrementally
and returns newly observed commits ``(node, client_id, req_no, seq,
ts_ns)`` — the ground truth the load generator and the mp chaos driver
both audit.

Workers are started with ``subprocess.Popen`` (fork and exec), never
with a ``multiprocessing`` fork: a caller may already hold a CUDA
context, which a forked child cannot use.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

from .. import pb
from ..chaos.live import PartitionProxy
from ..runtime.transport import TcpTransport
from .profiles import WAN_PROFILES, profile_latency
from .worker import read_json, write_json_atomic

# Each worker imports torch and opens its own CUDA context before it
# writes address.json, so boot takes longer than the JAX worker's.
START_TIMEOUT_S = 120.0

# The client-side transport's endpoint id: far outside any node id range
# (workers discard it — propose frames carry no peer identity).
_CLIENT_NODE_ID = 1 << 20


class WorkerDied(RuntimeError):
    """A worker process exited while the supervisor still needed it."""


class _NodeHandle:
    """Supervisor-side state for one worker process."""

    def __init__(self, node_id: int, directory: str):
        self.node_id = node_id
        self.dir = directory
        self.spec_path = os.path.join(directory, "spec.json")
        self.process: subprocess.Popen | None = None
        self.log_file = None
        self.transport_port = 0
        self.metrics_port = 0
        self.app_port = 0  # KV service port (app mode only)
        # app.log tail state (poll_commits)
        self.log_offset = 0
        self.log_remainder = b""
        self.commits: list = []  # [(client_id, req_no, seq)]
        self.chain = ""
        # Every incarnation's exit code, in order (-9: SIGKILL), and
        # whether the supervisor meant to SIGKILL it (a chaos crash).
        self.exit_codes: list = []
        self.sigkilled: list = []
        # Seconds from spawn to address.json, per incarnation.
        self.boot_seconds: list = []
        self.spawned_at = 0.0

    @property
    def alive(self) -> bool:
        return self.process is not None and self.process.poll() is None

    def log_tail(self, max_bytes: int = 4096) -> str:
        try:
            with open(os.path.join(self.dir, "worker.log"), "rb") as fh:
                fh.seek(0, os.SEEK_END)
                size = fh.tell()
                fh.seek(max(0, size - max_bytes))
                return fh.read().decode("utf-8", "replace")
        except OSError:
            return "<no worker.log>"


def _log_faults(path: str) -> list:
    """The faults a worker's log reports: each traceback as one line (the
    thread it ran on, its last frames and the exception) and each line of
    the worker's own "died"/"failed" reports."""
    try:
        with open(path, "rb") as fh:
            lines = fh.read().decode("utf-8", "replace").splitlines()
    except OSError:
        return []
    faults = []
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith("Traceback"):
            end = i + 1
            while end < len(lines) and lines[end].startswith((" ", "\t")):
                end += 1
            block = lines[max(0, end - 4):end + 1]
            if i and lines[i - 1].startswith("Exception in thread"):
                block.insert(0, lines[i - 1])
            faults.append(" | ".join(part.strip() for part in block))
            i = end + 1
        else:
            if " died" in line or " failed" in line:
                faults.append(line)
            i += 1
    return faults


class ClusterSupervisor:
    """Boot and manage a multi-process mirbft-tpu cluster."""

    def __init__(
        self,
        node_count: int = 4,
        client_ids=None,
        *,
        root: str | None = None,
        batch_size: int = 1,
        processor: str = "cuda",
        profile: str = "lan",
        latency: dict | None = None,
        latency_seed: int = 0,
        tick_seconds: float = 0.04,
        proxied: bool = False,
        keep_root: bool = False,
        deferred_nodes=(),
        checkpoint_interval: int | None = None,
        network_config: dict | None = None,
        app: str | None = None,
        trace: bool = False,
        link_auth: bool = False,
        auth_secret: str = "",
        signed_ingress: bool = False,
        device: str = "cuda",
    ):
        if profile not in WAN_PROFILES:
            raise ValueError(
                f"unknown WAN profile {profile!r}; choose from "
                f"{sorted(WAN_PROFILES)}"
            )
        self.node_count = node_count
        self.client_ids = list(client_ids) if client_ids else [1, 2]
        self.batch_size = batch_size
        self.processor = processor
        self.profile = profile
        # Explicit per-link map wins over the named profile.
        self.latency = (
            latency
            if latency is not None
            else profile_latency(profile, node_count)
        )
        self.latency_seed = latency_seed
        self.tick_seconds = tick_seconds
        self.proxied = proxied
        self.keep_root = keep_root
        self._own_root = root is None
        self.root = (
            root
            if root is not None
            else tempfile.mkdtemp(prefix="mirbft-cluster-")
        )
        self.nodes = [
            _NodeHandle(n, os.path.join(self.root, f"node{n}"))
            for n in range(node_count)
        ]
        self.proxies: dict = {}  # (src, dst) -> PartitionProxy
        # Reconfiguration under fire: ``deferred_nodes`` are provisioned
        # members of the network config that start() does NOT spawn.
        # Every fresh worker then boots with the running subset as its
        # bootstrap leader set (identical FEntry everywhere), so the
        # absent members own no buckets until join_node() spawns them.
        self.deferred: set = set(int(n) for n in deferred_nodes)
        if self.deferred - set(range(node_count)):
            raise ValueError("deferred_nodes outside the provisioned set")
        if self.deferred:
            quorum = node_count - (node_count - 1) // 3
            if len(self.deferred) > node_count - quorum:
                raise ValueError(
                    "deferring that many nodes leaves no boot quorum"
                )
        self._boot_leaders = (
            sorted(set(range(node_count)) - self.deferred)
            if self.deferred
            else None
        )
        self.checkpoint_interval = checkpoint_interval
        # Explicit genesis NetworkConfig spec dict (nodes/f/buckets/ci/
        # mel) every fresh incumbent boots under.  For dynamic-membership
        # runs this is the *pre-reconfig* subset config; the joiner gets
        # the post-reconfig target via join_node(network_config=...) —
        # membership authority is the committed Reconfiguration, never a
        # static spec.
        self.network_config = dict(network_config) if network_config else None
        self.app = app  # "kv" installs the replicated KV service per node
        # Signed-mode knobs (docs/CRYPTO.md): MAC-authenticated replica
        # channels (all workers share auth_secret) and the speculative
        # Ed25519 ingress stage for client requests.
        if link_auth and not auth_secret:
            raise ValueError("link_auth requires auth_secret")
        self.link_auth = link_auth
        self.auth_secret = auth_secret
        self.signed_ingress = signed_ingress
        # Where every worker runs its kernels; written into every spec.
        self.device = device
        # node id -> kernel evidence, gathered by teardown().
        self.evidence: dict = {}
        # Per-node milestone tracing: each worker dumps <dir>/trace.json
        # (clock_sync-stamped) on graceful shutdown, the input for
        # obsv --critpath / the knee rung's saturation attribution.
        self.trace = trace
        self._booted: set = set()  # ids with a known transport address
        # Guards the client transport handle: submit() runs on load
        # generator threads while teardown() runs on the driver thread,
        # and an unguarded check-then-use would race the close-and-None.
        self._lock = threading.Lock()
        self._client_transport: TcpTransport | None = None  # guarded-by: _lock
        self._started = False

    # -- boot ----------------------------------------------------------------

    def _spec(
        self,
        node_id: int,
        fresh: bool,
        transport_port: int,
        network_config: dict | None = None,
    ) -> dict:
        latency = {
            str(peer): link
            for peer, link in self.latency.items()
            if int(peer) != node_id
        }
        spec = {
            "node_id": node_id,
            "node_count": self.node_count,
            "client_ids": self.client_ids,
            "dir": self.nodes[node_id].dir,
            "root": self.root,
            "batch_size": self.batch_size,
            "processor": self.processor,
            "tick_seconds": self.tick_seconds,
            "transport_port": transport_port,
            "fresh": fresh,
            "latency": latency,
            "latency_seed": self.latency_seed,
            "device": self.device,
        }
        explicit = network_config or self.network_config
        if explicit is not None:
            spec["network_config"] = dict(explicit)
        if self._boot_leaders is not None:
            # Every fresh worker (including a later joiner) builds the
            # same bootstrap FEntry, so the deterministic initial state
            # matches across the whole provisioned member set.
            spec["initial_leaders"] = self._boot_leaders
        if self.checkpoint_interval is not None:
            spec["checkpoint_interval"] = int(self.checkpoint_interval)
        if self.app is not None:
            spec["app"] = self.app
        if self.trace:
            spec["trace"] = True
        if self.link_auth:
            spec["link_auth"] = True
            spec["auth_secret"] = self.auth_secret
        if self.signed_ingress:
            spec["signed_ingress"] = True
        return spec

    def _spawn(self, handle: _NodeHandle) -> None:
        # A stale address.json would satisfy the boot wait instantly;
        # the handshake must observe *this* incarnation's ports.
        try:
            os.remove(os.path.join(handle.dir, "address.json"))
        except OSError:
            pass
        env = dict(os.environ)
        # The workers must import this very package even when it is run
        # from a source tree rather than installed (the worker's cwd is
        # the scratch root, not the repo).
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        existing = env.get("PYTHONPATH")
        env["PYTHONPATH"] = (
            pkg_root + os.pathsep + existing if existing else pkg_root
        )
        handle.log_file = open(
            os.path.join(handle.dir, "worker.log"), "ab"
        )
        handle.process = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "mirbft_tpu_torch.cluster",
                "--spec",
                handle.spec_path,
            ],
            stdout=handle.log_file,
            stderr=subprocess.STDOUT,
            env=env,
            cwd=self.root,
        )
        handle.spawned_at = time.monotonic()

    def _wait_address(self, handle: _NodeHandle, deadline: float) -> None:
        path = os.path.join(handle.dir, "address.json")
        while True:
            doc = read_json(path)
            if doc is not None:
                handle.transport_port = int(doc["transport_port"])
                handle.metrics_port = int(doc["metrics_port"])
                handle.app_port = int(doc.get("app_port", 0))
                handle.boot_seconds.append(
                    time.monotonic() - handle.spawned_at
                )
                return
            if not handle.alive:
                raise WorkerDied(
                    f"node {handle.node_id} exited during boot "
                    f"(rc={handle.process.returncode}):\n{handle.log_tail()}"
                )
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"node {handle.node_id} never wrote address.json:\n"
                    f"{handle.log_tail()}"
                )
            time.sleep(0.02)

    def healthz(self, node_id: int) -> dict | None:
        """One /healthz probe; None when the endpoint is unreachable."""
        port = self.nodes[node_id].metrics_port
        if not port:
            return None
        url = f"http://127.0.0.1:{port}/healthz"
        try:
            with urllib.request.urlopen(url, timeout=1.0) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except (urllib.error.URLError, OSError, ValueError):
            return None

    def status(self, node_id: int) -> dict | None:
        """One /status read (the node's state machine: watermarks, epoch,
        buckets); None while the endpoint is unreachable or the node's
        serializer does not answer in time."""
        port = self.nodes[node_id].metrics_port
        if not port:
            return None
        url = f"http://127.0.0.1:{port}/status"
        try:
            with urllib.request.urlopen(url, timeout=5.0) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except (urllib.error.URLError, OSError, ValueError):
            return None

    def _wait_ready(self, handle: _NodeHandle, deadline: float) -> None:
        while True:
            doc = self.healthz(handle.node_id)
            if doc is not None and doc.get("ready"):
                return
            if not handle.alive:
                raise WorkerDied(
                    f"node {handle.node_id} exited before ready "
                    f"(rc={handle.process.returncode}):\n{handle.log_tail()}"
                )
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"node {handle.node_id} never reported ready:\n"
                    f"{handle.log_tail()}"
                )
            time.sleep(0.05)

    def _peer_address(self, src: int, dst: int) -> tuple:
        if self.proxied:
            return self.proxies[(src, dst)].address
        return ("127.0.0.1", self.nodes[dst].transport_port)

    def _publish_peers(self, node_id: int) -> None:
        # Only peers with a known address (deferred members appear once
        # join_node boots them; workers re-poll peers.json and dial the
        # newcomers).
        peers = {
            str(peer): list(self._peer_address(node_id, peer))
            for peer in sorted(self._booted)
            if peer != node_id
        }
        write_json_atomic(
            os.path.join(self.nodes[node_id].dir, "peers.json"),
            {"peers": peers},
        )

    def _boot_handles(self) -> list:
        return [h for h in self.nodes if h.node_id not in self.deferred]

    def start(self, timeout_s: float = START_TIMEOUT_S) -> None:
        """Boot the cluster (minus deferred members) and block until
        every spawned node is ready."""
        if self._started:
            raise RuntimeError("cluster already started")
        self._started = True
        deadline = time.monotonic() + timeout_s
        for handle in self._boot_handles():
            os.makedirs(handle.dir, exist_ok=True)
            write_json_atomic(
                handle.spec_path,
                self._spec(handle.node_id, fresh=True, transport_port=0),
            )
            self._spawn(handle)
        for handle in self._boot_handles():
            self._wait_address(handle, deadline)
            self._booted.add(handle.node_id)
        if self.proxied:
            for a in sorted(self._booted):
                for b in sorted(self._booted):
                    if a != b:
                        self.proxies[(a, b)] = PartitionProxy(
                            ("127.0.0.1", self.nodes[b].transport_port)
                        )
        for handle in self._boot_handles():
            self._publish_peers(handle.node_id)
        for handle in self._boot_handles():
            self._wait_ready(handle, deadline)
        client_transport = TcpTransport(
            _CLIENT_NODE_ID,
            port=0,
            backoff_base=0.02,
            backoff_cap=0.25,
            dial_timeout=1.0,
        )
        for handle in self._boot_handles():
            client_transport.connect(
                handle.node_id, ("127.0.0.1", handle.transport_port)
            )
        with self._lock:
            self._client_transport = client_transport

    def join_node(
        self,
        node_id: int,
        timeout_s: float = START_TIMEOUT_S,
        network_config: dict | None = None,
    ) -> None:
        """Reconfiguration under fire: spawn a deferred member fresh
        against the running cluster.  The joiner boots the same
        deterministic provisioned state (and bootstrap leader set) as
        everyone else, dials the incumbents, and catches up to the
        commit frontier via snapshot state transfer; the incumbents
        pick its address up from the re-published peers.json on their
        next poll."""
        if node_id not in self.deferred:
            raise ValueError(f"node {node_id} is not a deferred member")
        handle = self.nodes[node_id]
        if handle.alive:
            raise RuntimeError(f"node {node_id} is already running")
        deadline = time.monotonic() + timeout_s
        os.makedirs(handle.dir, exist_ok=True)
        write_json_atomic(
            handle.spec_path,
            self._spec(
                node_id, fresh=True, transport_port=0,
                network_config=network_config,
            ),
        )
        self._spawn(handle)
        self._wait_address(handle, deadline)
        self.deferred.discard(node_id)
        self._booted.add(node_id)
        if self.proxied:
            for peer in sorted(self._booted):
                if peer == node_id:
                    continue
                self.proxies[(node_id, peer)] = PartitionProxy(
                    ("127.0.0.1", self.nodes[peer].transport_port)
                )
                self.proxies[(peer, node_id)] = PartitionProxy(
                    ("127.0.0.1", handle.transport_port)
                )
        for peer in sorted(self._booted):
            self._publish_peers(peer)
        self._wait_ready(handle, deadline)
        with self._lock:
            client_transport = self._client_transport
        if client_transport is not None:
            client_transport.connect(
                node_id, ("127.0.0.1", handle.transport_port)
            )

    # -- lifecycle -----------------------------------------------------------

    def kill(self, node_id: int, graceful: bool = False, timeout_s: float = 15.0) -> None:
        """Stop one node: SIGTERM + drain when graceful, SIGKILL when not
        (the chaos crash path — nothing un-fsynced survives)."""
        handle = self.nodes[node_id]
        if handle.process is None:
            return
        if handle.alive:
            if graceful:
                handle.process.send_signal(signal.SIGTERM)
                try:
                    handle.process.wait(timeout=timeout_s)
                except subprocess.TimeoutExpired:
                    handle.process.kill()
                    handle.process.wait(timeout=timeout_s)
            else:
                handle.process.kill()
                handle.process.wait(timeout=timeout_s)
        handle.exit_codes.append(handle.process.returncode)
        handle.sigkilled.append(not graceful)
        if handle.log_file is not None:
            handle.log_file.close()
            handle.log_file = None
        handle.process = None
        if not graceful:
            # SIGKILL gave the worker no chance to flush; its continuous
            # autoflush did, so reap the newest committed segment and
            # stamp how the process actually died.
            self._reap_flight(handle, "sigkill-reaped")

    def _reap_flight(self, handle: _NodeHandle, reason: str) -> str | None:
        """Annotate the node's newest flight segment with the real cause
        of death (the worker believed its last flush was routine).
        Returns the segment path, or None when the node never flushed."""
        from ..obsv.recorder import annotate_dump, load_dumps

        dumps = load_dumps(os.path.join(handle.dir, "flight"))
        entry = dumps.get(handle.node_id)
        if entry is None:
            return None
        path, _dump = entry
        annotate_dump(path, reason=reason)
        return path

    def flight_dumps(self) -> dict:
        """Newest flight-recorder segment per node id (postmortem
        input): feed ``self.root`` — or any one path's directory — to
        ``python -m mirbft_tpu_torch.obsv --postmortem``."""
        from ..obsv.recorder import load_dumps

        out = {}
        for handle in self.nodes:
            dumps = load_dumps(os.path.join(handle.dir, "flight"))
            entry = dumps.get(handle.node_id)
            if entry is not None:
                out[handle.node_id] = entry[0]
        return out

    def restart(self, node_id: int, timeout_s: float = START_TIMEOUT_S) -> None:
        """Respawn a killed node from its on-disk state, on its original
        transport port."""
        handle = self.nodes[node_id]
        if handle.alive:
            raise RuntimeError(f"node {node_id} is still running")
        write_json_atomic(
            handle.spec_path,
            self._spec(
                node_id, fresh=False, transport_port=handle.transport_port
            ),
        )
        deadline = time.monotonic() + timeout_s
        self._spawn(handle)
        self._wait_address(handle, deadline)
        self._wait_ready(handle, deadline)

    def alive_nodes(self) -> list:
        return [h.node_id for h in self.nodes if h.alive]

    def app_addresses(self) -> dict:
        """KV service endpoints: node_id -> (host, port) for every booted
        node with a service (requires ``app="kv"``).  Re-read after a
        restart — workers re-bind an ephemeral service port."""
        out = {}
        for handle in self.nodes:
            if handle.alive and handle.app_port:
                out[handle.node_id] = ("127.0.0.1", handle.app_port)
        return out

    @property
    def node_ids(self) -> list:
        """The load generator's duck interface (see loadgen.generator)."""
        return [h.node_id for h in self.nodes]

    # -- partitions ----------------------------------------------------------

    def set_partition(self, groups, cut: bool) -> None:
        """Cut (or heal) every proxied edge crossing the group boundary;
        requires ``proxied=True`` at construction."""
        if not self.proxied:
            raise RuntimeError(
                "set_partition requires ClusterSupervisor(proxied=True)"
            )
        group_of = {}
        for gi, group in enumerate(groups):
            for node in group:
                group_of[node] = gi
        for a in range(self.node_count):
            for b in range(self.node_count):
                if a != b and group_of.get(a) != group_of.get(b):
                    proxy = self.proxies.get((a, b))
                    if proxy is not None:  # edge to a not-yet-joined node
                        proxy.set_cut(cut)

    # -- client traffic ------------------------------------------------------

    def submit(self, node_id: int, request: pb.Request) -> None:
        """Ship one client request to one node (fire-and-forget; the
        transport's reconnect backoff absorbs a down target).

        Thread-safe against teardown(): the handle is snapshotted under
        the lock, so a concurrent teardown yields either this clean
        RuntimeError or a harmless propose into a closing transport
        (frames to a closed transport are dropped and counted) — never
        an AttributeError from the check-then-use window."""
        with self._lock:
            client_transport = self._client_transport
        if client_transport is None:
            raise RuntimeError("cluster not started")
        client_transport.propose(node_id, request)

    # -- commit observation --------------------------------------------------

    def poll_commits(self) -> list:
        """Incrementally tail every node's app.log; returns newly seen
        commits as ``(node_id, client_id, req_no, seq, ts_ns)``.  Torn or
        garbled lines (crash tails) are skipped, not fatal."""
        out = []
        for handle in self.nodes:
            path = os.path.join(handle.dir, "app.log")
            try:
                with open(path, "rb") as fh:
                    fh.seek(handle.log_offset)
                    chunk = fh.read()
            except OSError:
                continue
            if not chunk:
                continue
            handle.log_offset += len(chunk)
            data = handle.log_remainder + chunk
            lines = data.split(b"\n")
            handle.log_remainder = lines.pop()
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                handle.chain = rec.get("chain", handle.chain)
                if rec.get("t") != "apply":
                    continue
                ts_ns = rec.get("ts_ns")
                for client_id, req_no, _digest in rec["reqs"]:
                    handle.commits.append((client_id, req_no, rec["seq"]))
                    out.append(
                        (handle.node_id, client_id, req_no, rec["seq"], ts_ns)
                    )
        return out

    def committed(self, node_id: int) -> list:
        """Every commit observed so far on one node (tail first)."""
        self.poll_commits()
        return list(self.nodes[node_id].commits)

    def chains(self) -> list:
        """Last observed app-chain hex digest per node (tail first)."""
        self.poll_commits()
        return [h.chain for h in self.nodes]

    # -- teardown ------------------------------------------------------------

    def teardown(self) -> None:
        """Stop everything; idempotent."""
        with self._lock:
            client_transport = self._client_transport
            self._client_transport = None
        if client_transport is not None:
            client_transport.close(0)
        for handle in self.nodes:
            if handle.alive:
                handle.process.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 15.0
        for handle in self.nodes:
            if handle.process is None:
                continue
            remaining = max(0.1, deadline - time.monotonic())
            try:
                handle.process.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                handle.process.kill()
                handle.process.wait(timeout=10.0)
            handle.exit_codes.append(handle.process.returncode)
            handle.sigkilled.append(False)
            if handle.log_file is not None:
                handle.log_file.close()
                handle.log_file = None
            handle.process = None
        for handle in self.nodes:
            if os.path.isdir(handle.dir):
                self.evidence[handle.node_id] = self.kernel_evidence(
                    handle.node_id
                )
        for proxy in self.proxies.values():
            proxy.close()
        self.proxies = {}
        if self._own_root and not self.keep_root:
            shutil.rmtree(self.root, ignore_errors=True)

    # -- kernel evidence -----------------------------------------------------

    def exit_codes(self) -> dict:
        """node id -> every reaped incarnation's exit code, in order
        (-9 for a SIGKILL)."""
        return {h.node_id: list(h.exit_codes) for h in self.nodes}

    def worker_faults(self) -> list:
        """Every reaped incarnation that did not end as the supervisor
        ended it: 0 after a SIGTERM, -9 after a deliberate SIGKILL.  A -9
        after a SIGTERM is teardown's escalation (the worker hung in its
        drain); any other code is the worker's own fault exit."""
        faults = []
        for handle in self.nodes:
            for code, killed in zip(handle.exit_codes, handle.sigkilled):
                if code != (-9 if killed else 0):
                    sent = "SIGKILL" if killed else "SIGTERM"
                    faults.append(
                        f"node {handle.node_id} exited {code} after a {sent}"
                    )
        return faults

    def kernel_evidence(self, node_id: int) -> dict:
        """One node's work on the kernels, read from its directory: the
        processor's launches and digests and each wrapper's launches (the
        Ed25519 wrappers' also by rows, as ``{rows: launches}``) summed
        over every incarnation's ``kernels-<pid>.json``, and the
        crypto counters of the last graceful stop's ``metrics.json``
        (``mirbft_crypto_flush_total`` / ``mirbft_crypto_items_total`` by
        plane and path: ``hash/device``, ``hash/readback``,
        ``signature/ingress``).  A worker still running publishes every
        0.5 s, so its numbers may lag."""
        handle = self.nodes[node_id]
        totals: dict = {"incarnations": 0}
        summed = (
            "launches", "device_digests", "host_digests",
            "launches_sha256", "launches_ed25519_decompress",
            "launches_ed25519_ladder", "launches_bls_g1",
        )
        for key in summed:
            totals[key] = 0
        totals["kernel_ms"] = 0.0
        by_rows = ("launches_ed25519_decompress_by_rows",
                   "launches_ed25519_ladder_by_rows")
        for key in by_rows:
            totals[key] = {}
        processors = set()
        for path in sorted(glob.glob(os.path.join(handle.dir, "kernels-*.json"))):
            doc = read_json(path)
            if not doc:
                continue
            totals["incarnations"] += 1
            processors.add(doc.get("processor"))
            for key in summed:
                totals[key] += int(doc.get(key, 0))
            totals["kernel_ms"] += float(doc.get("kernel_ms", 0.0))
            for key in by_rows:
                for rows, n in (doc.get(key) or {}).items():
                    totals[key][int(rows)] = totals[key].get(int(rows), 0) + n
            for key, value in (doc.get("ingress") or {}).items():
                if key != "last_error":
                    name = f"ingress_{key}"
                    totals[name] = totals.get(name, 0) + int(value)
        totals["processors"] = sorted(p for p in processors if p)
        # What the worker wrote about a fault: a traceback (its thread,
        # last frames and exception), or its own "... died" / "...
        # failed" lines (worker.py's exit paths).
        totals["log_faults"] = _log_faults(os.path.join(handle.dir, "worker.log"))
        metrics = read_json(os.path.join(handle.dir, "metrics.json")) or {}
        for name, key in (
            ("mirbft_crypto_flush_total", "flushes"),
            ("mirbft_crypto_items_total", "items"),
        ):
            for series in metrics.get(name, {}).get("series", []):
                labels = series.get("labels", {})
                label = f"{labels.get('plane')}/{labels.get('path')}"
                totals.setdefault(key, {})[label] = series.get("value", 0)
        return totals

    def __enter__(self) -> "ClusterSupervisor":
        self.start()
        return self

    def __exit__(self, *_exc) -> None:
        self.teardown()
