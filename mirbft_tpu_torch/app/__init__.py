"""The replicated application layer over the consensus engine.

Everything below the consensus engine orders batches; everything in this
package turns that order into a *service*:

- ``journal``  — the fsynced apply journal (moved here from chaos/live.py):
  the durable ground truth for what this node has applied, and — in
  payload mode — the local replay source between checkpoints.
- ``stream``   — the apply/commit-stream API: ordered, exactly-once-per-
  apply-index delivery of committed ops to a registered state machine,
  with a persisted applied-index and snapshot-install fast-forward.
- ``kvstore``  — the KvStore replicated state machine (put/get/delete/cas)
  with deterministic apply and snapshot encode/decode.
- ``service``  — the client-facing seam: request/response framing, the
  read path (``committed`` with a read-index barrier, ``stale``
  frontier-tagged), and the multiplexing client loadgen drives.

See docs/APP.md for the API boundary and consistency guarantees.
"""

from .journal import DurableChainLog
from .kvstore import KvStore
from .stream import AppLog, CommitStream
from .service import KvClient, KvFrontend, KvService

__all__ = [
    "AppLog",
    "CommitStream",
    "DurableChainLog",
    "KvClient",
    "KvFrontend",
    "KvService",
    "KvStore",
]
