"""Signed-request support for the testengine (BASELINE ladder rung 3).

The reference explicitly leaves request authentication to the consumer —
``Node.Step`` documents that the caller must have authenticated the source
(reference: mirbft.go:297-301, docs/Design.md:18-21).  This module is that
consumer-side ingress authentication: clients Ed25519-sign their requests,
and replicas verify them in deferred batches through the same coalescing
pattern as digesting (crypto_plane.py).

Request wire format in signed mode::

    data = payload || signature(64) || public_key(32)

The signed message binds client identity and sequence position:
``b"%d:%d:" % (client_id, req_no) + payload`` — a replayed signature for a
different (client, req_no) fails verification.

Planes:

- ``SignaturePlane(host_verifier)``: the host oracle (crypto.ed25519_host),
  the plane the device planes are held against; ``SignaturePlane(
  batch_verifier(device))`` runs the same lazy plane on the kernels,
  under the digest plane's fault seam when given a ``breaker``
  (``timeout_s``: a failed batch is re-verified on the kernels while the
  breaker grants a probe, never on the host);
- ``AsyncSignaturePlane``: waves launched on the Ed25519 kernels at every
  simulated-time boundary, verdicts read back lazily through CUDA events;
- ``SpeculativeSignaturePlane``: requests admitted at once, their
  signatures verified in kernel bursts at the next boundary.

Both device planes run on ``cuda`` unless ``device="cpu"`` is passed (the
kernels' plain versions), and raise without a card.  Neither has a host
route: every verdict comes from the kernels.
"""

from __future__ import annotations

import time

import torch

from ..crypto import ed25519_host as host
from ..obsv import hooks
from ..ops.batching import resolve_device
from ..ops.ed25519 import (
    launch_rows,
    marshal_light,
    verify_batch,
    verify_batch_pallas,
)
from .crypto_plane import guarded_launch, record_outcome

SIG_LEN = 64
PK_LEN = 32
TRAILER = SIG_LEN + PK_LEN


def client_seed(client_id: int) -> bytes:
    """Deterministic per-client signing seed (test harness only)."""
    return b"mirbft-tpu-client" + client_id.to_bytes(15, "big")


def signing_message(client_id: int, req_no: int, payload: bytes) -> bytes:
    return b"%d:%d:" % (client_id, req_no) + payload


def make_signer():
    """Returns signer(client_id, req_no, payload) -> signed request data.
    Public keys are derived (and cached) from the deterministic seeds."""
    pk_cache: dict[int, bytes] = {}

    def signer(client_id: int, req_no: int, payload: bytes) -> bytes:
        seed = client_seed(client_id)
        pk = pk_cache.get(client_id)
        if pk is None:
            pk = pk_cache[client_id] = host.public_key(seed)
        sig = host.sign(seed, signing_message(client_id, req_no, payload))
        return payload + sig + pk

    return signer


def split_signed(data: bytes):
    """data -> (payload, signature, public key); None if malformed."""
    if len(data) < TRAILER:
        return None
    return data[:-TRAILER], data[-TRAILER:-PK_LEN], data[-PK_LEN:]


# Expected-key registry, cached at module scope: derivation is a
# milliseconds-long pure-Python scalar mult and the keys are deterministic
# per client id, so re-deriving them on every flush would dominate
# signed-run time.
_PK_CACHE: dict[int, bytes] = {}


def register_pk(client_id: int, pk: bytes) -> None:
    """Pre-populate the expected-key registry.  A real deployment receives
    client public keys as configuration (like the network state); deriving
    them from seeds at first use is harness convenience — client setup
    (e.g. the pre-signing pass) should register keys so replica-side
    verification never pays the derivation."""
    _PK_CACHE[client_id] = pk


def _expected_pk(client_id: int, cache: dict = _PK_CACHE) -> bytes:
    pk = cache.get(client_id)
    if pk is None:
        pk = cache[client_id] = host.public_key(client_seed(client_id))
    return pk


def host_verifier(items: list) -> list:
    """items: [(client_id, req_no, data)] -> [bool], via the host oracle."""
    cache = _PK_CACHE
    out = []
    for client_id, req_no, data in items:
        parts = split_signed(data)
        if parts is None:
            out.append(False)
            continue
        payload, sig, pk = parts
        out.append(
            pk == _expected_pk(client_id, cache)
            and host.verify(
                pk, signing_message(client_id, req_no, payload), sig
            )
        )
    return out


def identified(items: list) -> tuple:
    """items: [(client_id, req_no, data)] -> (slots, [(pk, message,
    signature)]): the items whose signed trailer parses and whose key is
    the client's, with their places in ``items``.  The rest are rejected
    on the host before any batch verifier sees them."""
    cache = _PK_CACHE
    slots, triples = [], []
    for slot, (client_id, req_no, data) in enumerate(items):
        parts = split_signed(data)
        if parts is None:
            continue
        payload, sig, pk = parts
        if pk != _expected_pk(client_id, cache):
            continue
        slots.append(slot)
        triples.append((pk, signing_message(client_id, req_no, payload), sig))
    return slots, triples


def _batch_verdicts(items: list, verify, device) -> list:
    """Judge items through a batch verifier (ops.ed25519); the
    client-identity binding (pk == registry pk) stays host-side."""
    device = resolve_device(device)
    out = [False] * len(items)
    slots, triples = identified(items)
    if slots:
        pks, msgs, sigs = map(list, zip(*triples))
        verdicts = verify(pks, msgs, sigs, device=device)
        for slot, valid in zip(slots, verdicts, strict=True):
            out[slot] = bool(valid)
    return out


def kernel_verifier(items: list, device="cuda") -> list:
    """items: [(client_id, req_no, data)] -> [bool], through the Ed25519
    kernels at ``verify_batch``'s 512-row chunks."""
    return _batch_verdicts(items, verify_batch, device)


def pallas_verifier(items: list, device="cuda") -> list:
    """items: [(client_id, req_no, data)] -> [bool], through the Ed25519
    kernels at ``verify_batch_pallas``'s 4096-row chunks."""
    return _batch_verdicts(items, verify_batch_pallas, device)


def rlc_verifier(items: list) -> list:
    """items: [(client_id, req_no, data)] -> [bool], via the host batch
    verifier (crypto.ed25519_batch, a random linear combination).  The
    host route, taken only where a caller names it: no entry point picks
    it on its own.  Verdicts equal host_verifier's bit for bit; the
    client-identity binding (pk == registry pk) stays per item."""
    from ..crypto import ed25519_batch

    out = [False] * len(items)
    slots, triples = identified(items)
    if slots:
        verdicts = ed25519_batch.verify_batch(triples)
        for slot, valid in zip(slots, verdicts, strict=True):
            out[slot] = bool(valid)
    return out


def kernel_authority(device="cuda") -> bool:
    """Whether the Ed25519 kernels hold verify authority on ``device``:
    true for a CUDA device.  ``resolve_device`` raises without a card;
    there is no "no accelerator, so the host" branch."""
    return resolve_device(device).type == "cuda"


def batch_verifier(device="cuda"):
    """The batch verifier that live embedders inject into
    ``runtime.ingress.SpeculativeIngress``: ``kernel_verifier`` bound to
    ``device`` (``cuda`` unless the caller asks for ``cpu``, the kernels'
    plain versions).  Raises without a card; never ``rlc_verifier``."""
    device = resolve_device(device)

    def verifier(items: list) -> list:
        return kernel_verifier(items, device=device)

    verifier.device = device
    return verifier


class SignaturePlane:
    """Deferred, coalesced request authentication.

    Requests are submitted at schedule time (the client broadcast) and
    judged at first delivery — at which point everything pending verifies
    as one batch.  Verdicts are cached by (client_id, req_no, data), so
    each distinct request is verified exactly once no matter how many
    replicas receive it.  Deterministic: verdicts depend only on the data.
    """

    def __init__(self, verifier=host_verifier, breaker=None, timeout_s=None):
        self.verifier = verifier
        # The digest plane's fault seam (crypto_plane.guarded_launch): a
        # verifier batch that raises, reads back short or overruns
        # ``timeout_s`` counts against the breaker, and a failed batch is
        # verified again by the same verifier while the breaker grants a
        # probe.  ``fallback_verifies`` stays 0: there is no host route.
        # Without a breaker there is no seam: a fault raises as it comes.
        self.breaker = breaker
        self.timeout_s = timeout_s
        self.device_errors = 0
        self.device_timeouts = 0
        self.device_retries = 0
        self.fallback_verifies = 0
        self._pending: list = []  # [(client_id, req_no, data)]
        self._verdicts: dict = {}
        self.flush_sizes: list[int] = []
        # Blocking wall time per flush — the ingress-auth latency the
        # replica actually experiences (the rung-3 verify p99).
        self.flush_wall_s: list[float] = []

    def _key(self, client_id: int, req_no: int, data: bytes):
        return (client_id, req_no, data)

    def submit(self, client_id: int, req_no: int, data: bytes) -> None:
        key = self._key(client_id, req_no, data)
        if key not in self._verdicts:
            self._pending.append((client_id, req_no, data))
            self._verdicts[key] = None  # reserved: pending

    def on_time(self, _now: int) -> None:
        """Engine hook at simulated-time advancement; the base plane stays
        fully lazy (AsyncSignaturePlane launches completed waves here)."""

    def valid(self, client_id: int, req_no: int, data: bytes) -> bool:
        key = self._key(client_id, req_no, data)
        verdict = self._verdicts.get(key)
        if verdict is None:
            self.submit(client_id, req_no, data)  # no-op if already pending
            self._flush()
            verdict = self._verdicts[key]
        return verdict

    def _flush(self) -> None:
        if not self._pending:
            return
        batch = self._pending
        self._pending = []
        self.flush_sizes.append(len(batch))
        start = time.perf_counter()
        verdicts, attempt_start = guarded_launch(
            self, lambda: self.verifier(batch), len(batch),
            f"verify flush {len(self.flush_sizes) - 1}",
        )
        record_outcome(self, attempt_start)
        wall = time.perf_counter() - start
        self.flush_wall_s.append(wall)
        if hooks.enabled:
            hooks.record_flush("signature", "batch", len(batch), wall)
        for item, verdict in zip(batch, verdicts, strict=True):
            self._verdicts[self._key(*item)] = verdict


def _admit(client_id: int, data: bytes):
    """Structural parse and client-identity binding, the cheap checks
    every plane runs at submit: (payload, sig, pk), or None to reject."""
    parts = split_signed(data)
    if parts is None or parts[2] != _expected_pk(client_id):
        return None
    return parts


def _marshal(client_id: int, req_no: int, data: bytes):
    """``_admit`` and then ``marshal_light``: the kernels' row for a
    request, or None where the host rejects it."""
    parts = _admit(client_id, data)
    if parts is None:
        return None
    payload, sig, pk = parts
    return marshal_light(pk, signing_message(client_id, req_no, payload), sig)


class AsyncSignaturePlane(SignaturePlane):
    """The kernel-backed signature plane, shaped like the digest plane
    (crypto_plane.AsyncKernelHashPlane):

    - **Cheap rejection at submit time.**  Structural parsing, the
      client-identity binding (pk == registry pk) and ``marshal_light``'s
      range checks run at submit; a request that fails any of them never
      reaches a kernel.
    - **Wave launches.**  Marshalled rows accumulate into a wave; when
      simulated time advances past the submission instant (``on_time``),
      or the wave reaches ``chunk`` rows, the wave launches on the
      Ed25519 kernels, followed by a ``non_blocking`` copy of its verdicts
      into pinned host memory and a CUDA event.  The kernels then run
      while the engine works through the events before the first delivery.
    - **Lazy forcing.**  A verdict's first demand waits on its chunk's
      event; a demand for a request whose wave has not launched launches
      that wave and waits.  There is no host route: every request is either
      rejected at submit (``host_rejects``) or judged by the kernels
      (``device_verifies``, the rows launched).
    - **Bounded outstanding chunks.**  Under manglers a request can be
      submitted and never demanded.  ``max_outstanding`` caps live chunks
      (launching past the cap reads the oldest back first), and a chunk
      still undemanded ``stale_boundaries`` wave boundaries after launch is
      read back at ``on_time``.

    Verdicts depend only on the request bytes, so event counts, chains and
    recorded events equal the host plane's.
    """

    #: Always 0: there is no host route (the JAX package's counter name).
    host_verifies = 0

    def __init__(
        self,
        chunk: int = 1024,
        max_outstanding: int = 8,
        stale_boundaries: int = 2,
        device="cuda",
    ):
        super().__init__(verifier=None)
        self.device = resolve_device(device)
        self.chunk = chunk
        self.max_outstanding = max_outstanding
        self.stale_boundaries = stale_boundaries
        self._wave: list = []  # [(key, marshal_light row)]
        # chunk id -> (keys, host verdicts, CUDA events or None, launch
        # wall s, wave boundary at launch)
        self._chunks: dict = {}
        self._chunk_of: dict = {}  # key -> chunk id
        self._next_chunk = 0
        self._boundary = 0  # on_time wave-boundary counter
        self.forced_retirements = 0
        self.launches = 0
        self.demand_flushes = 0
        self.device_verifies = 0
        self.host_rejects = 0
        # The kernels' time on the card (CUDA events around each launch),
        # summed as chunks are read back.
        self.kernel_ms = 0.0

    def submit(self, client_id: int, req_no: int, data: bytes) -> None:
        key = self._key(client_id, req_no, data)
        if key in self._verdicts:
            return
        row = _marshal(client_id, req_no, data)
        if row is None:
            self._verdicts[key] = False
            self.host_rejects += 1
            return
        self._verdicts[key] = None  # pending
        self._wave.append((key, row))
        if len(self._wave) >= self.chunk:
            self._launch()

    def on_time(self, _now: int) -> None:
        self._boundary += 1
        floor = self._boundary - self.stale_boundaries
        stale = [cid for cid, entry in self._chunks.items() if entry[4] <= floor]
        for cid in stale:
            self.forced_retirements += 1
            self._retire(cid)
        if self._wave:
            self._launch()

    def _launch(self) -> None:
        wave, self._wave = self._wave, []
        start = time.perf_counter()
        events: list = []  # filled on CUDA only
        verdicts = launch_rows([row for _key, row in wave], self.device, events)
        if events:
            host_out = torch.empty(
                verdicts.shape, dtype=verdicts.dtype, pin_memory=True
            )
            host_out.copy_(verdicts, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
            timing = (*events[0], copied)
        else:
            host_out, timing = verdicts, None
        launch_s = time.perf_counter() - start
        cid = self._next_chunk
        self._next_chunk += 1
        keys = [key for key, _row in wave]
        self._chunks[cid] = (keys, host_out, timing, launch_s, self._boundary)
        for key in keys:
            self._chunk_of[key] = cid
        # Cap outstanding chunks: retire the oldest (queued first, so the
        # most likely to be done).
        while len(self._chunks) > self.max_outstanding:
            self.forced_retirements += 1
            self._retire(min(self._chunks))
        self.flush_sizes.append(len(wave))
        self.launches += 1
        self.device_verifies += len(wave)
        if hooks.enabled:
            hooks.record_flush("signature", "device", len(wave), launch_s)

    def valid(self, client_id: int, req_no: int, data: bytes) -> bool:
        key = self._key(client_id, req_no, data)
        if key not in self._verdicts:
            self.submit(client_id, req_no, data)
        verdict = self._verdicts[key]
        if verdict is not None:
            return verdict
        if key not in self._chunk_of:
            # Demanded before its wave launched: launch now and wait below.
            self.demand_flushes += 1
            self._launch()
        self._retire(self._chunk_of[key])
        return self._verdicts[key]

    def _retire(self, cid: int) -> None:
        """Read a chunk's verdicts back and drop its retained material."""
        keys, host_out, timing, launch_s, _born = self._chunks.pop(cid)
        start = time.perf_counter()
        if timing is not None:
            began, ended, copied = timing
            copied.synchronize()
            self.kernel_ms += began.elapsed_time(ended)
        valid = host_out.tolist()
        wall = launch_s + time.perf_counter() - start
        self.flush_wall_s.append(wall)
        if hooks.enabled:
            hooks.record_flush("signature", "readback", len(keys), wall)
        verdicts = self._verdicts
        chunk_of = self._chunk_of
        for key, verdict in zip(keys, valid, strict=True):
            verdicts[key] = bool(verdict)
            del chunk_of[key]


class SpeculativeSignaturePlane(SignaturePlane):
    """Speculative batched ingress verification.

    Mir's amortization argument: client-signature verification does not
    have to gate intake — requests may be *admitted optimistically* into
    the pre-consensus queues (the engine's delivery queue here) while their
    signatures verify as batches off the critical path, as long as the
    verdict joins before the request can reach the ordered log.

    - ``submit`` (the client broadcast instant) performs only the cheap
      structural + client-identity admission and parks the request.
    - ``on_time`` (the simulated-time wave boundary, which fires before
      the first delivery of anything submitted at earlier instants)
      verifies the parked wave in bursts of ``kernel_chunk``: each burst is
      marshalled on the host (``marshal_light``; its rejects count in
      ``host_rejects``) and its rows launched on the Ed25519 kernels on the
      plane's device (counted in ``device_verifies``).  Each burst's
      blocking wall time lands in ``flush_wall_s`` — the rung-3 verify
      p99.
    - ``valid`` (the delivery join) is then a verdict lookup; a
      demanded-before-boundary key forces the join early.  A False verdict
      evicts the speculatively admitted request — counted here and in
      ``mirbft_crypto_speculative_evictions_total`` — so a bad-signature
      request can be *in flight* but never *ordered*.

    Verdicts depend only on the request bytes, so determinism, event
    counts, and app chains are unchanged from the synchronous plane.
    """

    #: Always 0: there is no host route (the JAX package's counter name).
    host_verifies = 0

    def __init__(self, kernel_chunk: int = 512, device="cuda"):
        super().__init__(verifier=None)
        self.device = resolve_device(device)
        self.kernel_chunk = kernel_chunk
        self.speculative_evictions = 0
        self.forced_joins = 0
        self.admitted = 0
        self.device_verifies = 0
        self.host_rejects = 0
        # The kernels' time on the card (CUDA events around each launch).
        self.kernel_ms = 0.0

    # -- admission ---------------------------------------------------------

    def submit(self, client_id: int, req_no: int, data: bytes) -> None:
        key = self._key(client_id, req_no, data)
        if key in self._verdicts:
            return
        if _admit(client_id, data) is None:
            self._verdicts[key] = False
            self.host_rejects += 1
            return
        self._verdicts[key] = None  # pending: speculatively admitted
        self._pending.append((client_id, req_no, data))
        self.admitted += 1

    @property
    def speculative_depth(self) -> int:
        """Requests currently admitted but not yet judged."""
        return len(self._pending)

    # -- the join ----------------------------------------------------------

    def on_time(self, _now: int) -> None:
        if self._pending:
            self._flush()

    def valid(self, client_id: int, req_no: int, data: bytes) -> bool:
        key = self._key(client_id, req_no, data)
        verdict = self._verdicts.get(key)
        if verdict is None:
            self.submit(client_id, req_no, data)  # no-op if already parked
            self.forced_joins += 1
            self._flush()
            verdict = self._verdicts[key]
        if not verdict:
            self.speculative_evictions += 1
            if hooks.enabled:
                hooks.metrics.counter(
                    "mirbft_crypto_speculative_evictions_total"
                ).inc()
        return verdict

    # -- burst verification ------------------------------------------------

    def _flush(self) -> None:
        if not self._pending:
            return
        wave, self._pending = self._pending, []
        verdicts = self._verdicts
        for base in range(0, len(wave), self.kernel_chunk):
            burst = wave[base : base + self.kernel_chunk]
            start = time.perf_counter()
            rows, keys = [], []
            for item in burst:
                row = _marshal(*item)
                if row is None:
                    verdicts[self._key(*item)] = False
                    self.host_rejects += 1
                else:
                    rows.append(row)
                    keys.append(self._key(*item))
            events: list = []  # filled on CUDA only
            if rows:
                valid = launch_rows(rows, self.device, events).tolist()
                for key, verdict in zip(keys, valid, strict=True):
                    verdicts[key] = bool(verdict)
            wall = time.perf_counter() - start
            self.kernel_ms += sum(a.elapsed_time(b) for a, b in events)
            self.flush_sizes.append(len(burst))
            self.flush_wall_s.append(wall)
            self.device_verifies += len(rows)
            if hooks.enabled:
                hooks.record_flush("signature", "device", len(burst), wall)


class MacSealPlane:
    """Deterministic-engine model of MAC-authenticated replica channels
    (the simulation twin of the live transport's per-link MACs, the way
    SignaturePlane twins the live ingress verifier).

    The model is identity-based rather than cryptographic: the engine
    seals every node-to-node message object a legitimate sender emits,
    and at delivery admits a message only if that exact object was
    sealed.  Manglers that tamper with replica traffic always *rewrite*
    (they build fresh objects, never mutate — other targets share the
    original), so a forged or tampered message is by construction unsealed
    and is dropped at ingress exactly where the live transport drops a
    bad-MAC frame.  Duplicate deliveries of a sealed object are admitted —
    PBFT-style link MACs authenticate, they do not prevent replay; dedup
    owns that.

    Scope: EventStep/EventStepBatch (the replica plane).  Client proposes
    stay signature-authenticated.

    Sealed objects are pinned by strong reference so an id() can never be
    recycled into a false admit.  Registry size is bounded by the
    scenario's total send count.
    """

    def __init__(self):
        self._sealed: dict[int, object] = {}
        self.sealed = 0
        self.rejections = 0

    def seal(self, msg) -> None:
        key = id(msg)
        if key not in self._sealed:
            self._sealed[key] = msg
            self.sealed += 1

    def admit(self, msg) -> bool:
        if id(msg) in self._sealed:
            return True
        self.rejections += 1
        if hooks.enabled:
            hooks.metrics.counter(
                "mirbft_mac_rejections_total", kind="unsealed"
            ).inc()
        return False
