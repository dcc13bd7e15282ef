"""The client-facing service seam.

Framing is length-prefixed JSON (4-byte big-endian length + UTF-8 body)
over a plain TCP loopback listener per worker — deliberately not the
consensus transport: clients are not replicas.  One connection carries
many in-flight ops (each frame has an ``id`` the response echoes), which
is how loadgen multiplexes millions of *logical users* over a handful of
sockets.

Write path (the Mir client contract): the **client** owns the consensus
identity — it assigns ``(client_id, req_no)`` and broadcasts the write
frame to every node (the f+1 weak-certificate quorum needs the request
everywhere), with ``want_reply`` set only toward its home node.  The
home node registers a commit-stream waiter *before* proposing, and
replies when the op applies with its apply index (the version).

Read path (PBFT §4.1 read optimization — reads skip consensus):

- ``committed``: the home node blocks the read behind the read-index
  barrier — the applied index must cover max(commit frontier at issue,
  the session's high-water index) — so a read never observes an
  uncommitted or forked prefix and a session never reads backwards.
- ``stale``: served immediately, tagged with the applied frontier.
"""

from __future__ import annotations

import json
import socket
import struct
import threading

from .. import pb
from ..obsv import hooks
from . import kvstore

_LEN = struct.Struct(">I")
_MAX_FRAME = 16 * 1024 * 1024


def send_frame(sock: socket.socket, obj: dict) -> None:
    body = json.dumps(obj, separators=(",", ":")).encode()
    sock.sendall(_LEN.pack(len(body)) + body)


def recv_frame(rfile) -> dict | None:
    head = rfile.read(4)
    if len(head) != 4:
        return None
    (length,) = _LEN.unpack(head)
    if length > _MAX_FRAME:
        return None
    body = rfile.read(length)
    if len(body) != length:
        return None
    return json.loads(body)


class KvFrontend:
    """Socket-independent server logic: one per node, shared by the TCP
    service and the in-process loopback session."""

    def __init__(self, stream, store, propose):
        self.stream = stream
        self.store = store
        self.propose = propose  # callable(pb.Request) -> None

    @staticmethod
    def encode_write(msg: dict) -> bytes | None:
        op = msg.get("op")
        try:
            if op == "put":
                return kvstore.encode_put(msg["key"], bytes.fromhex(msg["value"]))
            if op == "delete":
                return kvstore.encode_delete(msg["key"])
            if op == "cas":
                return kvstore.encode_cas(
                    msg["key"], int(msg["expect"]), bytes.fromhex(msg["value"])
                )
        except (KeyError, TypeError, ValueError):
            return None
        return None

    def _count_write(self, op: str, outcome: str) -> None:
        if hooks.enabled:
            hooks.metrics.counter(
                "mirbft_app_writes_total", mode=op, outcome=outcome
            ).inc()

    def _count_read(self, mode: str, outcome: str) -> None:
        if hooks.enabled:
            hooks.metrics.counter(
                "mirbft_app_reads_total", mode=mode, outcome=outcome
            ).inc()

    def execute(self, msg: dict) -> dict:
        op = msg.get("op")
        if op in ("put", "delete", "cas"):
            return self._write(msg)
        if op == "get":
            return self._read(msg)
        if op == "status":
            return {"status": "ok", "app": self.stream.status()}
        return {"status": "bad_request"}

    def _write(self, msg: dict) -> dict:
        data = self.encode_write(msg)
        if data is None:
            return {"status": "bad_request"}
        client_id = int(msg["client_id"])
        req_no = int(msg["req_no"])
        want_reply = bool(msg.get("want_reply"))
        waiter = None
        if want_reply:
            waiter = self.stream.register_waiter(client_id, req_no)
        try:
            self.propose(pb.Request(client_id=client_id, req_no=req_no, data=data))
        except Exception:
            if waiter is not None:
                self.stream.cancel_waiter(client_id, req_no)
            self._count_write(msg["op"], "rejected")
            return {"status": "rejected"}
        if waiter is None:
            return {"status": "accepted"}
        got = waiter.wait(float(msg.get("timeout", 10.0)))
        if got is None:
            self.stream.cancel_waiter(client_id, req_no)
            self._count_write(msg["op"], "timeout")
            return {"status": "timeout", "frontier": self.stream.applied_index}
        index, result = got
        if result is not None and "installed_seq" in result:
            # Applied inside a snapshot this node installed: committed,
            # its result never computed here.  A put always succeeds; a
            # delete's or a cas's outcome is not known on this node.
            outcome = "ok" if msg["op"] == "put" else "committed"
            self._count_write(msg["op"], outcome)
            return {
                "status": outcome,
                "version": 0,
                "index": 0,
                "frontier": self.stream.applied_index,
                "installed_seq": result["installed_seq"],
            }
        outcome = (result or {}).get("outcome", "ok")
        self._count_write(msg["op"], outcome)
        return {
            "status": outcome,
            "version": (result or {}).get("version", index),
            "index": index,
            "frontier": self.stream.applied_index,
        }

    def _read(self, msg: dict) -> dict:
        mode = msg.get("mode", "committed")
        key = msg["key"]
        if mode == "committed":
            ok, _waited, frontier = self.stream.read_barrier(
                min_index=int(msg.get("min_index", 0)),
                timeout=float(msg.get("timeout", 10.0)),
            )
            if not ok:
                self._count_read(mode, "timeout")
                return {"status": "timeout", "frontier": frontier}
        else:
            mode = "stale"
            frontier = self.stream.applied_index
        value, version = self.store.get(key)
        outcome = "ok" if value is not None else "not_found"
        self._count_read(mode, outcome)
        resp = {
            "status": outcome,
            "version": version,
            "frontier": frontier,
        }
        if value is not None:
            resp["value"] = value.hex()
        return resp


class KvService:
    """The per-worker loopback TCP listener: accept loop + one reader
    thread per connection; ops that block (want_reply writes, committed
    reads) run on per-request threads so one slow barrier doesn't
    head-of-line block the other logical users on the connection."""

    def __init__(self, frontend: KvFrontend, host: str = "127.0.0.1",
                 max_inflight: int = 128):
        self.frontend = frontend
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(64)
        self.address = self._sock.getsockname()
        self._inflight = threading.Semaphore(max_inflight)
        self._closed = False
        self._conns: list = []
        self._accept_thread = threading.Thread(
            target=self._accept, name="kv-service-accept", daemon=True
        )
        self._accept_thread.start()

    @property
    def port(self) -> int:
        return self.address[1]

    def _accept(self) -> None:
        while not self._closed:
            try:
                conn, _peer = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(conn)
            threading.Thread(
                target=self._serve, args=(conn,), name="kv-service-conn",
                daemon=True,
            ).start()

    def _serve(self, conn: socket.socket) -> None:
        rfile = conn.makefile("rb")
        wlock = threading.Lock()

        def respond(req_id, resp):
            resp["id"] = req_id
            try:
                with wlock:
                    send_frame(conn, resp)
            except OSError:
                pass

        def handle(msg):
            try:
                resp = self.frontend.execute(msg)
            except Exception:
                resp = {"status": "error"}
            finally:
                self._inflight.release()
            respond(msg.get("id"), resp)

        try:
            while not self._closed:
                msg = recv_frame(rfile)
                if msg is None:
                    return
                self._inflight.acquire()
                threading.Thread(
                    target=handle, args=(msg,), name="kv-service-op",
                    daemon=True,
                ).start()
        except OSError:
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass


class _Conn:
    """One client->node connection with a response-dispatch thread."""

    def __init__(self, address):
        self.sock = socket.create_connection(address, timeout=5.0)
        # The timeout above bounds connect only; a timed-out blocking
        # read would wrongly kill the connection during any >5s idle gap
        # or slow commit.  Op deadlines belong to the waiters, not the
        # socket.
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.rfile = self.sock.makefile("rb")
        self.wlock = threading.Lock()
        self.pending: dict = {}  # id -> (Event, [resp])
        self.plock = threading.Lock()
        self.dead = False
        threading.Thread(
            target=self._dispatch, name="kv-client-recv", daemon=True
        ).start()

    def _dispatch(self) -> None:
        while True:
            try:
                resp = recv_frame(self.rfile)
            except (OSError, ValueError):
                resp = None
            if resp is None:
                self.dead = True
                with self.plock:
                    waiting = list(self.pending.values())
                    self.pending.clear()
                for event, _slot in waiting:
                    event.set()
                return
            with self.plock:
                entry = self.pending.pop(resp.get("id"), None)
            if entry is not None:
                entry[1].append(resp)
                entry[0].set()

    def send(self, msg: dict, expect_reply: bool):
        entry = None
        if expect_reply:
            entry = (threading.Event(), [])
            with self.plock:
                self.pending[msg["id"]] = entry
        try:
            with self.wlock:
                send_frame(self.sock, msg)
        except OSError:
            self.dead = True
            if entry is not None:
                with self.plock:
                    self.pending.pop(msg["id"], None)
            return None
        return entry

    def close(self) -> None:
        self.dead = True
        try:
            self.sock.close()
        except OSError:
            pass


class KvClient:
    """One KV session: a consensus client identity (``client_id``, its
    own req_no sequence), a home node for replies and reads, and
    broadcast connections to every node.  Tracks the session's
    high-water apply index so committed reads never go backwards even
    across a home-node change.  Ops are serial per session; run many
    sessions for concurrency."""

    def __init__(self, addresses: dict, client_id: int, home: int):
        self.addresses = dict(addresses)  # node_id -> (host, port)
        self.client_id = client_id
        self.home = home
        self.req_no = 0
        self.next_id = 0
        self.session_index = 0  # high-water apply index observed
        self._conns: dict = {}

    def _conn(self, node_id):
        conn = self._conns.get(node_id)
        if conn is not None and not conn.dead:
            return conn
        if conn is not None:
            conn.close()
            self._conns.pop(node_id, None)
        addr = self.addresses.get(node_id)
        if addr is None:
            return None
        try:
            conn = _Conn(addr)
        except OSError:
            return None
        self._conns[node_id] = conn
        return conn

    def set_addresses(self, addresses: dict) -> None:
        """Refresh endpoints (chaos restarts re-bind service ports)."""
        for node_id, addr in addresses.items():
            if self.addresses.get(node_id) != addr:
                old = self._conns.pop(node_id, None)
                if old is not None:
                    old.close()
            self.addresses[node_id] = addr

    def _next_frame_id(self) -> int:
        self.next_id += 1
        return self.next_id

    def _observe(self, resp: dict) -> None:
        for field in ("index", "version", "frontier"):
            val = resp.get(field)
            if isinstance(val, int) and val > self.session_index:
                self.session_index = val

    def _write(self, msg: dict, timeout: float) -> dict:
        # Client windows open at req_no 0 and advance in order.
        req_no = self.req_no
        self.req_no += 1
        msg.update(client_id=self.client_id, req_no=req_no, timeout=timeout)
        entry = None
        for node_id in sorted(self.addresses):
            conn = self._conn(node_id)
            if conn is None:
                continue
            frame = dict(msg)
            frame["id"] = self._next_frame_id()
            frame["want_reply"] = node_id == self.home
            got = conn.send(frame, expect_reply=node_id == self.home)
            if node_id == self.home:
                entry = got
        if entry is None:
            return {"status": "unreachable"}
        if not entry[0].wait(timeout + 1.0):
            return {"status": "timeout"}
        if not entry[1]:
            return {"status": "disconnected"}
        resp = entry[1][0]
        self._observe(resp)
        return resp

    def put(self, key: str, value: bytes, timeout: float = 10.0) -> dict:
        return self._write(
            {"op": "put", "key": key, "value": value.hex()}, timeout
        )

    def delete(self, key: str, timeout: float = 10.0) -> dict:
        return self._write({"op": "delete", "key": key}, timeout)

    def cas(self, key: str, expect_version: int, value: bytes,
            timeout: float = 10.0) -> dict:
        return self._write(
            {
                "op": "cas",
                "key": key,
                "expect": expect_version,
                "value": value.hex(),
            },
            timeout,
        )

    def get(self, key: str, mode: str = "committed",
            timeout: float = 10.0) -> dict:
        conn = self._conn(self.home)
        if conn is None:
            return {"status": "unreachable"}
        frame = {
            "op": "get",
            "key": key,
            "mode": mode,
            "min_index": self.session_index if mode == "committed" else 0,
            "timeout": timeout,
            "id": self._next_frame_id(),
        }
        entry = conn.send(frame, expect_reply=True)
        if entry is None:
            return {"status": "unreachable"}
        if not entry[0].wait(timeout + 1.0):
            return {"status": "timeout"}
        if not entry[1]:
            return {"status": "disconnected"}
        resp = entry[1][0]
        self._observe(resp)
        return resp

    def close(self) -> None:
        for conn in self._conns.values():
            conn.close()
        self._conns.clear()
