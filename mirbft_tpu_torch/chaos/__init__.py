"""Safety and liveness invariants over a run's evidence.

The JAX package's ``chaos/`` is a campaign harness: a seeded matrix of
fault scenarios on the test engine and on a live cluster, each audited by
an invariant checker.  The port carries the checkers (``invariants``, a
copy: pure host Python over harness evidence); the app and state-transfer
paths are audited with three of them (``check_linearizable_reads``,
``check_bounded_catchup``, ``check_transfer_corruption_rejected``).  The
scenario matrix, the fault backends and the live driver are not ported
yet (ROADMAP queue 1).
"""

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

__all__ = [
    "CrashSnapshot",
    "InvariantViolation",
    "audit_aggregate_certs",
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
]
