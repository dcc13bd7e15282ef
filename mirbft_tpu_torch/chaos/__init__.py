"""Chaos campaign harness: seeded fault-scenario matrix + invariants,
runnable on two engines.

The testengine's mangler DSL (testengine/manglers.py) injects individual
faults; this package turns it into a *campaign*: a reproducible matrix of
scenarios — message loss, jitter, duplication, crash + restart schedules,
network partitions with heal, epoch-change-targeted leader isolation,
device-plane faults against the crypto planes, and signed-mode verifier
faults — each audited by an invariant checker:

- **No fork**: committed prefixes agree across nodes (any two nodes that
  committed a sequence number committed the same requests there, in the
  same order).
- **Durability**: a crashed node's post-replay commit log is a
  prefix-consistent continuation of what it had committed before the
  crash.
- **Bounded recovery**: the run converges within a bound of the last
  disruption (partition heal / node restart) — liveness degrades, never
  dies.
- **Commit resumption**: after the last heal/restart, the cluster
  *resumes committing* within the bound, not merely "eventually".

One scenario schema, two engines: the deterministic runner (runner.py)
lowers scenarios onto the simulated testengine, while the live driver
(live.py) lowers the same scenarios onto a real loopback TCP cluster —
real ``runtime.Node`` threads, socket-level partition proxies, crash-kill
+ ``Node.restart`` from on-disk WALs, and failing fsyncs.

Both engines run every digest, signature verdict and certificate on the
card's kernels (SHA-256, Ed25519, BLS G1): on ``cuda`` unless the caller
asks for ``cpu``, the kernels' plain versions.  The device-fault
scenarios wrap the kernel launch itself; the planes ride a transient
fault out on the kernel and raise on a persistent one.  The invariant
checkers also audit the app and state-transfer paths
(``check_linearizable_reads``, ``check_bounded_catchup``,
``check_transfer_corruption_rejected``).

Entry points::

    python -m mirbft_tpu_torch.chaos                 # full deterministic matrix
    python -m mirbft_tpu_torch.chaos --smoke         # the tier-1 subset
    python -m mirbft_tpu_torch.chaos --live          # real-cluster campaign
    python -m mirbft_tpu_torch.chaos --live --smoke  # tier-1 live smoke
    python -m mirbft_tpu_torch.chaos --seed 7 --only partition
    python -m mirbft_tpu_torch.chaos --smoke --device cpu  # plain versions
"""

from .faults import FlakyDigestBackend, FlakyVerifierBackend
from .invariants import (
    CrashSnapshot,
    InvariantViolation,
    audit_aggregate_certs,
    check_aggregate_cert_rejected,
    check_bounded_catchup,
    check_bounded_recovery,
    check_censorship_liveness,
    check_commit_resumption,
    check_config_agreement,
    check_corruption_rejected,
    check_durable_prefix,
    check_flood_bounded,
    check_full_convergence,
    check_linearizable_reads,
    check_mac_rejected,
    check_no_fork,
    check_no_fork_under_equivocation,
    check_no_vector_divergence,
    check_transfer_corruption_rejected,
    committed_by_seq,
)
from .live import (
    AdversaryProxy,
    DurableChainLog,
    LiveCluster,
    PartitionProxy,
    run_live_campaign,
    run_live_scenario,
)
from .runner import CampaignResult, ScenarioResult, run_campaign, run_scenario
from .scenarios import (
    ADVERSARY_SMOKE_NAMES,
    LIVE_ADVERSARY_NAMES,
    LIVE_SMOKE_NAMES,
    SMOKE_NAMES,
    Adversary,
    CrashPoint,
    PartitionWindow,
    Scenario,
    StorageFault,
    adversary_matrix,
    adversary_smoke_matrix,
    live_adversary_matrix,
    live_matrix,
    live_smoke_matrix,
    matrix,
    smoke_matrix,
)

__all__ = [
    "Adversary",
    "adversary_matrix",
    "adversary_smoke_matrix",
    "ADVERSARY_SMOKE_NAMES",
    "AdversaryProxy",
    "audit_aggregate_certs",
    "CampaignResult",
    "check_aggregate_cert_rejected",
    "check_bounded_catchup",
    "check_bounded_recovery",
    "check_censorship_liveness",
    "check_commit_resumption",
    "check_config_agreement",
    "check_corruption_rejected",
    "check_durable_prefix",
    "check_flood_bounded",
    "check_full_convergence",
    "check_linearizable_reads",
    "check_mac_rejected",
    "check_no_fork",
    "check_no_fork_under_equivocation",
    "check_no_vector_divergence",
    "check_transfer_corruption_rejected",
    "committed_by_seq",
    "CrashPoint",
    "CrashSnapshot",
    "DurableChainLog",
    "FlakyDigestBackend",
    "FlakyVerifierBackend",
    "InvariantViolation",
    "live_adversary_matrix",
    "LIVE_ADVERSARY_NAMES",
    "live_matrix",
    "live_smoke_matrix",
    "LIVE_SMOKE_NAMES",
    "LiveCluster",
    "matrix",
    "PartitionProxy",
    "PartitionWindow",
    "run_campaign",
    "run_live_campaign",
    "run_live_scenario",
    "run_scenario",
    "Scenario",
    "ScenarioResult",
    "smoke_matrix",
    "SMOKE_NAMES",
    "StorageFault",
]
