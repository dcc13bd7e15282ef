"""Open-loop load generation with a latency-SLO gate.

- ``arrivals``: Poisson / bursty on-off / diurnal-ramp arrival plans
  (deterministic under a seed — the offered load is an input, not a
  measurement).
- ``clients``: client behaviour models — slow clients, mixed payload
  sizes, and retry storms that re-submit timed-out requests to several
  nodes (the hostile load request dedup exists for).
- ``generator``: ``LoadGenerator`` drives any cluster exposing
  ``node_ids`` / ``submit`` / ``poll_commits`` (the multi-process
  ``ClusterSupervisor`` or the tier-1 ``InProcessCluster``), tracking
  per-request submit→commit latency against the cluster's own commit
  records.
- ``slo``: the ``mirbft-loadgen-slo/1`` artifact + absolute SLO gate;
  ``obsv --diff`` consumes the artifact directly for the relative gate.
- ``inproc``: the no-sockets, no-fsync in-process backend for fast
  tests.
- ``kv``: ``KvWorkload`` drives the replicated KV service's own API
  (mixed reads/writes per ClientModel) and reports the user-visible
  read/write latency split (docs/APP.md).

The JAX package's ``knee`` (the capacity search) is not ported yet: it
needs ``obsv/critpath.py`` (ROADMAP queue 1).

``InProcessCluster`` runs its nodes on the ``cuda-pipelined`` processor
on ``cuda`` unless the caller passes ``device="cpu"`` (the digest
kernel's plain version) or names a host processor kind.
"""

from .arrivals import (  # noqa: F401
    BurstyArrivals,
    DiurnalArrivals,
    PoissonArrivals,
)
from .clients import (  # noqa: F401
    ClientModel,
    kv_client_models,
    standard_client_models,
)
from .generator import LoadGenerator, StepResult, percentile_ms  # noqa: F401
from .inproc import InProcessCluster  # noqa: F401
from .kv import KvStepResult, KvWorkload  # noqa: F401
from .slo import (  # noqa: F401
    SCHEMA,
    artifact,
    check_slo,
    load_artifact,
    write_artifact,
)
