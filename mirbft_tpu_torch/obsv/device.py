"""Device-plane telemetry: kernel timings, launch shapes, transfers.

The host-protocol obsv stack is blind to the device plane's kernels.  This
module closes that gap with one decorator:

    from ..obsv import device as _device

    step = _device.instrument("device_ack_step", fn_name="device_ack_step")(
        ack_plane.ack_step
    )

Per call, while ``hooks.enabled`` is on, the wrapper

- observes the call's time in ``mirbft_device_kernel_seconds{kernel}``:
  CUDA events around the call when a tensor argument lies on a card (the
  kernel's device time, read after the events complete), ``perf_counter``
  around it on the CPU;
- takes the call's *launch shape* (shape and dtype of each tensor,
  bucketed length for sequences, value for scalars) and bumps
  ``mirbft_device_retraces_total{fn}`` when a new one shows up.  The JAX
  package counted retraces of a jitted program here; a hand-written
  kernel does not retrace, but a new launch shape is the same warning (a
  caller feeding unbucketed shapes), so it counts against the same
  per-function budget and the same metric, and a function past the budget
  lands in ``report()["retrace_breaches"]``.

Off, the cost is one module-attribute load and a branch.

``transfer(direction, nbytes, device)`` counts one copy between the host
and a card into ``mirbft_device_transfer_bytes_total{direction}``: the
plane calls it where it copies (the batch up, the row outputs down), so
the counter holds the bytes that crossed, not the bytes of the state the
kernels reach in place.  A CPU plane copies nothing and counts nothing.

``memory_sample()`` reports the card's allocator gauges, and never imports
torch itself: a process that has not paid for torch does not pay for it
here.
"""

from __future__ import annotations

import functools
import sys
import time

from .metrics import CardinalityError

#: New distinct launch shapes tolerated per function before the function
#: lands in ``report()["retrace_breaches"]``.  The ack plane pads its
#: batches to power-of-two buckets, so a handful of shapes is normal.
RETRACE_BUDGET = 8

_signatures: dict = {}  # fn name -> set of launch shapes seen
_retraces: dict = {}  # fn name -> count of new-shape events
_breaches: list = []  # fn names that exceeded the budget (insertion order)


def reset():
    """Forget all shapes, counts and breaches (new bench run)."""
    _signatures.clear()
    _retraces.clear()
    del _breaches[:]


def _registry():
    from . import hooks

    if hooks.enabled:
        return hooks.metrics
    return None


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _abstract(value):
    """Launch shape of one argument: shape and dtype for arrays and
    tensors, the next power of two of a sequence's length, the value of a
    scalar."""
    shape = getattr(value, "shape", None)
    dtype = getattr(value, "dtype", None)
    if shape is not None and dtype is not None:
        return ("arr", tuple(shape), str(dtype))
    if value is None or isinstance(value, (bool, int, float, str, bytes)):
        return ("static", value)
    if isinstance(value, (list, tuple)):
        return ("seq", type(value).__name__, _next_pow2(len(value)))
    return ("obj", type(value).__name__)


def _signature(args, kwargs):
    sig = tuple(_abstract(a) for a in args)
    if kwargs:
        sig += tuple((k, _abstract(v)) for k, v in sorted(kwargs.items()))
    return sig


def _cuda_device(values):
    """The card of the first CUDA tensor among ``values``, else None."""
    for value in values:
        device = getattr(value, "device", None)
        if getattr(device, "type", None) == "cuda":
            return device
    return None


def _note_signature(fn_name, sig, registry):
    seen = _signatures.get(fn_name)
    if seen is None:
        seen = _signatures[fn_name] = set()
    if sig in seen:
        return
    seen.add(sig)
    _retraces[fn_name] = _retraces.get(fn_name, 0) + 1
    if (_retraces[fn_name] > RETRACE_BUDGET
            and fn_name not in _breaches):
        _breaches.append(fn_name)
    try:
        registry.counter("mirbft_device_retraces_total", fn=fn_name).inc()
    except CardinalityError:
        pass  # over budget: the dict above still has the truth


def transfer(direction: str, nbytes: int, device) -> None:
    """Count one copy of ``nbytes`` between the host and ``device``
    (``direction`` "h2d" or "d2h"); nothing unless ``device`` is a card
    and hooks are on."""
    if getattr(device, "type", None) != "cuda" or not nbytes:
        return
    registry = _registry()
    if registry is None:
        return
    try:
        registry.counter(
            "mirbft_device_transfer_bytes_total", direction=direction
        ).inc(nbytes)
    except CardinalityError:
        pass


def instrument(kernel, *, fn_name=None):
    """Decorator wrapping one device-plane entry point.

    ``kernel`` labels the timing histogram; ``fn_name`` labels the launch
    shape counter (defaults to the wrapped function's ``__name__``).
    """

    def deco(fn):
        label = fn_name or getattr(fn, "__name__", kernel)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            registry = _registry()
            if registry is None:
                return fn(*args, **kwargs)
            _note_signature(label, _signature(args, kwargs), registry)
            device = _cuda_device(list(args) + list(kwargs.values()))
            if device is not None:
                import torch

                with torch.cuda.device(device):
                    began = torch.cuda.Event(enable_timing=True)
                    ended = torch.cuda.Event(enable_timing=True)
                    began.record()
                    out = fn(*args, **kwargs)
                    ended.record()
                    ended.synchronize()
                elapsed = began.elapsed_time(ended) / 1e3
            else:
                start = time.perf_counter()
                out = fn(*args, **kwargs)
                elapsed = time.perf_counter() - start
            try:
                registry.histogram(
                    "mirbft_device_kernel_seconds", kernel=kernel
                ).observe(elapsed)
            except CardinalityError:
                pass
            return out

        return wrapper

    return deco


def memory_sample():
    """The card's allocator gauges, or None when torch was never imported
    or no card was initialised.

    Returns ``{"live_buffers": int, "live_buffer_bytes": int,
    "hbm_bytes": int}``: the allocations and bytes the caching allocator
    has live (``torch.cuda.memory_allocated``), and the bytes it holds from
    the card.  Never imports torch itself.
    """
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        stats = torch.cuda.memory_stats()
        return {
            "live_buffers": int(stats.get("allocation.all.current", 0)),
            "live_buffer_bytes": int(torch.cuda.memory_allocated()),
            "hbm_bytes": int(torch.cuda.memory_reserved()),
        }
    except Exception:
        return None


def report(registry):
    """Summarize the capture for a bench payload's ``device`` section.

    Pulls kernel timings from the registry snapshot and launch-shape truth
    from the module dicts (the dicts survive CardinalityError drops)."""
    snap = registry.snapshot()
    kernels = {}
    entry = snap.get("mirbft_device_kernel_seconds")
    if entry:
        for series in entry.get("series", ()):
            name = series["labels"].get("kernel", "?")
            count = series.get("count", 0)
            total = series.get("sum", 0.0)
            kernels[name] = {
                "count": count,
                "total_s": total,
                "mean_ms": (total / count * 1e3) if count else 0.0,
            }
    transfers = {}
    entry = snap.get("mirbft_device_transfer_bytes_total")
    if entry:
        for series in entry.get("series", ()):
            transfers[series["labels"].get("direction", "?")] = series["value"]
    divergence = 0
    entry = snap.get("mirbft_divergence_total")
    if entry:
        divergence = sum(s["value"] for s in entry.get("series", ()))
    return {
        "kernel_seconds": kernels,
        "retraces": dict(_retraces),
        "retrace_budget": RETRACE_BUDGET,
        "retrace_breaches": list(_breaches),
        "transfer_bytes": transfers,
        "divergence_total": divergence,
    }
