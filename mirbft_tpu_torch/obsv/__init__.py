"""Observability plane: metrics registry, trace spans and the hook
switchboard that core and the test engine call.

``hooks``, ``metrics``, ``trace``, ``bqueue`` (the bounded hand-off
queues of the live node's pipeline and transport), ``device`` (kernel
timing by CUDA events, launch shapes, transfers), ``recorder`` (the
flight recorder) and ``shadow`` (the divergence oracle over the ack
planes) are carried over; the rest of the reference's plane (critical
path, diff, exporter, merge, timeline) is not part of this package yet.

Usage:

    from mirbft_tpu_torch.obsv import hooks
    registry, tracer = hooks.enable(trace=True)
    ...  # run instrumented code
    print(registry.prometheus_text())
    hooks.disable()
"""

from __future__ import annotations

from . import hooks
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
from .trace import SpanSampler, Tracer

__all__ = [
    "CARDINALITY",
    "CATALOG",
    "CATALOG_LABELS",
    "CardinalityError",
    "DEFAULT_BUCKETS",
    "DEFAULT_CARDINALITY",
    "NullRegistry",
    "Registry",
    "SpanSampler",
    "Tracer",
    "hooks",
    "null_registry",
]
