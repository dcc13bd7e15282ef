"""Local, static node configuration (reference: config.go:13-61).

The consensus-replicated configuration (node set, f, buckets, checkpoint
interval) lives in pb.NetworkConfig and changes only via reconfiguration;
this is the per-node operational config.

``processor`` names the executor ``runtime.build_processor`` builds.  The
default is ``cuda``: every digest on the hand-written SHA-256 kernel, so a
node built from a default ``Config`` needs a card (or ``device="cpu"``
passed to ``build_processor``).  The JAX package's ``tpu*`` names raise
with the ``cuda*`` name that replaces them.
"""

from __future__ import annotations

from dataclasses import dataclass

from .log import ConsoleLogger, Logger


#: Executor kinds: the host kinds hash with hashlib, the ``cuda*`` kinds
#: on the SHA-256 kernel.
PROCESSOR_NAMES = (
    "serial", "pool", "pipelined", "cuda", "cuda-pool", "cuda-pipelined",
)
#: The JAX package's accelerator kinds and the port's kind for each.
TPU_KINDS = {
    "tpu": "cuda", "tpu-pool": "cuda-pool", "tpu-pipelined": "cuda-pipelined",
}


@dataclass
class Config:
    id: int
    logger: Logger = None
    # Max requests per batch (batches may be cut smaller on heartbeats).
    batch_size: int = 1
    # Leader heartbeat period, in ticks.
    heartbeat_ticks: int = 2
    # Ticks without commit progress before suspecting the epoch.
    suspect_ticks: int = 4
    # Ticks to wait on a new-epoch leader; must be >= 2 (rebroadcast is
    # computed at half this value).
    new_epoch_timeout_ticks: int = 8
    # Per-remote-node byte budget for buffered not-yet-applyable messages.
    buffer_size: int = 5 * 1024 * 1024
    # Ingress frame bounds enforced by msgfilter.pre_process before a
    # peer message enters the serializer; raise max_batch_acks together
    # with batch_size when reconfiguring for larger batches.
    max_batch_acks: int = 256
    max_request_bytes: int = 1024 * 1024
    max_digest_bytes: int = 64
    # State-transfer ingress bounds (runtime/transfer.py): per-chunk
    # payload cap enforced on both the donor's chunking and the fetcher's
    # ingress (msgfilter.check_snapshot_chunk — a byzantine donor must
    # not be able to OOM a fetcher), and a total reassembled-snapshot
    # cap bounding chunk-count floods.
    max_snapshot_chunk_bytes: int = 256 * 1024
    max_snapshot_bytes: int = 64 * 1024 * 1024
    # Optional callable(state_event) invoked inside the serializer before
    # each event application (the tracing hook).
    event_interceptor: object = None
    # HTTP observability endpoint (GET /metrics, /status, /healthz, /dump).
    # Off by default; set a port to serve (0 binds an ephemeral port,
    # read back via Node.metrics_address).  See obsv/exporter.py.
    metrics_port: int | None = None
    metrics_host: str = "127.0.0.1"
    # Action-executor selection for runtime embedders that build their
    # processor via runtime.build_processor (bench.py):
    # serial | pool | pipelined (hashlib, asked for by name) or
    # cuda | cuda-pool | cuda-pipelined (the SHA-256 kernel).
    processor: str = "cuda"
    # Ack/quorum bookkeeping plane: "host" keeps the numpy _FastAcks
    # mirror; "device" keeps the dense bitmask plane on ack_device
    # (core/device_tracker.py).  None defers to the MIRBFT_ACK_PLANE env
    # knob (default host).
    ack_plane: str | None = None
    # The device ack plane's card: "cuda" runs its kernels and raises
    # without a card; "cpu" runs their plain versions.
    ack_device: str = "cuda"
    # Device-plane frame coalescing (validated, read only by the device
    # ack plane).  None defers to the MIRBFT_ACK_FLUSH_ROWS env knob.
    ack_flush_rows: int | None = None
    # Divergence-oracle audit stride: with hooks enabled, a Node audits
    # every Nth ack frame (obsv/shadow.py's ShadowSampler) unless a
    # sampler is already installed.  None leaves the oracle off.
    shadow_stride: int | None = None
    # MAC-authenticated replica channels (docs/CRYPTO.md): when on, every
    # node/hello/transfer transport frame carries a per-link MAC tag
    # derived from auth_secret (crypto/mac.py) and bad-MAC frames are
    # rejected at ingress (mirbft_mac_rejections_total).  The client
    # propose lane stays signature-authenticated.  All members of a
    # cluster must agree on both knobs — a mixed cluster rejects the
    # unauthenticated minority's frames by design.
    link_auth: bool = False
    auth_secret: bytes = b""

    def __post_init__(self):
        if self.logger is None:
            self.logger = ConsoleLogger()
        if self.new_epoch_timeout_ticks < 2:
            raise ValueError("new_epoch_timeout_ticks must be >= 2")
        if self.processor in TPU_KINDS:
            raise ValueError(
                f"processor {self.processor!r} is the JAX package's; the "
                f"port's kind is {TPU_KINDS[self.processor]!r}"
            )
        if self.processor not in PROCESSOR_NAMES:
            raise ValueError(
                f"processor must be one of {PROCESSOR_NAMES}, got "
                f"{self.processor!r}"
            )
        if self.ack_plane not in (None, "host", "device"):
            raise ValueError(
                f"ack_plane must be host|device, got {self.ack_plane!r}"
            )
        if self.ack_device not in ("cuda", "cpu"):
            raise ValueError(
                f"ack_device must be cuda|cpu, got {self.ack_device!r}"
            )
        if self.shadow_stride is not None and self.shadow_stride < 1:
            raise ValueError("shadow_stride must be >= 1")
        if self.ack_flush_rows is not None and self.ack_flush_rows < 1:
            raise ValueError("ack_flush_rows must be >= 1")
        if self.max_snapshot_chunk_bytes < 1:
            raise ValueError("max_snapshot_chunk_bytes must be >= 1")
        if self.max_snapshot_bytes < self.max_snapshot_chunk_bytes:
            raise ValueError(
                "max_snapshot_bytes must be >= max_snapshot_chunk_bytes"
            )
        if self.link_auth and not self.auth_secret:
            raise ValueError("link_auth requires a non-empty auth_secret")
