"""Observability plane: metrics registry, trace spans, timeline profiler,
cross-node flow merging, HTTP exposition, a timeline-diff gate, the
critical-path ledger, process and card resource sampling, the flight
recorder, kernel telemetry and the divergence oracle.

Usage:

    from mirbft_tpu_torch.obsv import hooks
    registry, tracer = hooks.enable(trace=True)
    ...  # run instrumented code
    print(registry.prometheus_text())
    tracer.write("trace.json")  # open in ui.perfetto.dev
    hooks.disable()

Instrumented call sites across core/testengine/runtime guard on
``hooks.enabled`` so that with observability off the entire plane costs
one branch per boundary crossing.  ``python -m mirbft_tpu_torch.obsv``
runs an instrumented testengine ladder (its digests on the SHA-256
kernel on ``cuda``, or ``--device cpu`` for the kernel's plain version)
and prints the per-phase consensus latency table; ``--merge`` combines
per-node traces, ``--diff`` gates one artifact against another,
``--postmortem`` merges flight dumps and ``--critpath`` attributes
latency to phases and nodes.
"""

from __future__ import annotations

from . import hooks
from .bqueue import BoundedQueue, QueueTelemetry
from .critpath import FlowRecord, attribute, attribution_table, build_ledger
from .diff import diff_files, diff_series, extract_series
from .exporter import ObsvExporter
from .merge import aligned_events, merge_files, merge_traces, split_node_traces
from .metrics import (
    CARDINALITY,
    CATALOG,
    CATALOG_LABELS,
    DEFAULT_BUCKETS,
    DEFAULT_CARDINALITY,
    CardinalityError,
    NullRegistry,
    Registry,
    null_registry,
)
from .timeline import PHASES, PhaseStats, TimelineProfiler
from .trace import SpanSampler, Tracer

__all__ = [
    "BoundedQueue",
    "CARDINALITY",
    "CATALOG",
    "CATALOG_LABELS",
    "CardinalityError",
    "DEFAULT_BUCKETS",
    "DEFAULT_CARDINALITY",
    "FlowRecord",
    "NullRegistry",
    "ObsvExporter",
    "PHASES",
    "PhaseStats",
    "QueueTelemetry",
    "Registry",
    "SpanSampler",
    "TimelineProfiler",
    "Tracer",
    "aligned_events",
    "attribute",
    "attribution_table",
    "build_ledger",
    "diff_files",
    "diff_series",
    "extract_series",
    "hooks",
    "merge_files",
    "merge_traces",
    "null_registry",
    "split_node_traces",
]
