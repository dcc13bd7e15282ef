"""Process resource sampling and least-squares leak verdicts.

This module is the package's one home for process introspection: RSS,
open file descriptors, thread counts, on-disk store footprints and the
card's allocator gauges (``obsv/device.py`` ``memory_sample``) are
sampled here and nowhere else.  Samplers feed catalog-registered gauges
(``mirbft_resource_*``, ``mirbft_device_*``) and, when a flight recorder
is wired, periodic ``resource`` snapshots into its ring buffer.

Everything is stdlib-only: ``psutil`` is deliberately not used (it is
not part of the pinned environment), so the samplers read
``/proc/self`` directly and degrade to ``None`` where the platform
does not expose a number.

A sampler told it watches a card (``device="cuda"``) counts a tick on
which the card's allocator could not be read as a failed tick, and every
failed tick is counted (``failed_ticks``, ``last_error``): the sampler
never hides the card, and a soak gates on both.

``leak_verdict`` turns a sampled series into a ``flat``/``growing``
verdict via an ordinary least-squares slope, normalised to percent of
the series mean per minute so the same threshold works for bytes,
fds, and thread counts.  ``obsv --diff`` and the bench soak rung gate
on the verdict the same way they gate on p95 regressions.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = [
    "rss_bytes",
    "open_fds",
    "thread_count",
    "dir_bytes",
    "sample_process",
    "leak_verdict",
    "ResourceSampler",
]

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def rss_bytes():
    """Current resident set size in bytes, or None when unreadable.

    ``/proc/self/statm`` reports *current* pages; ``getrusage`` only
    reports the high-water mark, which can never shrink and would make
    every leak series look monotone.  The peak is used only as a
    last-resort fallback on /proc-less platforms.
    """
    try:
        with open("/proc/self/statm", "r", encoding="ascii") as fh:
            fields = fh.read().split()
        return int(fields[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource as _resource

        peak_kb = _resource.getrusage(_resource.RUSAGE_SELF).ru_maxrss
        return int(peak_kb) * 1024
    except Exception:
        return None


def open_fds():
    """Number of open file descriptors, or None when unreadable."""
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


def thread_count():
    """Live Python threads in this process."""
    return threading.active_count()


def dir_bytes(path):
    """Total size of regular files under ``path`` (0 if absent).

    Races with concurrent segment rotation are expected: a file listed
    by the walk may vanish before stat, which counts as zero rather
    than raising.
    """
    total = 0
    if not path:
        return 0
    try:
        for root, _dirs, files in os.walk(path):
            for name in files:
                try:
                    total += os.stat(os.path.join(root, name)).st_size
                except OSError:
                    continue
    except OSError:
        return total
    return total


def sample_process(dirs=None):
    """One snapshot of the process: rss/fds/threads plus named dirs.

    ``dirs`` maps a store label (e.g. ``"wal"``) to a directory path;
    each contributes a ``disk.<label>`` entry in the returned dict.
    ``None`` values mark metrics the platform could not provide.
    """
    sample = {
        "rss_bytes": rss_bytes(),
        "open_fds": open_fds(),
        "threads": thread_count(),
    }
    for label, path in sorted((dirs or {}).items()):
        sample[f"disk.{label}"] = dir_bytes(path)
    return sample


def _least_squares(samples):
    """Slope/intercept/r^2 of (t, v) pairs; None when degenerate."""
    n = len(samples)
    if n < 2:
        return None
    mean_t = sum(t for t, _ in samples) / n
    mean_v = sum(v for _, v in samples) / n
    var_t = sum((t - mean_t) ** 2 for t, _ in samples)
    if var_t <= 0.0:
        return None
    cov = sum((t - mean_t) * (v - mean_v) for t, v in samples)
    slope = cov / var_t
    var_v = sum((v - mean_v) ** 2 for _, v in samples)
    if var_v <= 0.0:
        r2 = 0.0
    else:
        r2 = (cov * cov) / (var_t * var_v)
    return slope, mean_v, r2


def leak_verdict(
    samples,
    threshold_pct_per_min=5.0,
    min_samples=8,
    min_r2=0.5,
):
    """Classify a sampled series as ``flat`` or ``growing``.

    ``samples`` is a sequence of ``(t_seconds, value)`` pairs.  The
    verdict is ``growing`` only when the least-squares slope exceeds
    ``threshold_pct_per_min`` percent of the series mean per minute
    AND the fit explains the data (r^2 >= ``min_r2``) AND there are at
    least ``min_samples`` points — noisy or short series stay ``flat``
    with low confidence rather than flapping a PR gate.

    Returns a dict with the verdict, a 0..1 confidence, the raw and
    normalised slopes, the fit quality, and series endpoints, shaped
    for direct embedding in bench/soak JSON artifacts.
    """
    pts = [(float(t), float(v)) for t, v in samples if v is not None]
    base = {
        "verdict": "flat",
        "confidence": 0.0,
        "slope_per_s": 0.0,
        "rel_pct_per_min": 0.0,
        "r2": 0.0,
        "n": len(pts),
        "first": pts[0][1] if pts else None,
        "last": pts[-1][1] if pts else None,
        "mean": None,
        "span_s": (pts[-1][0] - pts[0][0]) if len(pts) >= 2 else 0.0,
    }
    if len(pts) < 2:
        return base
    fit = _least_squares(pts)
    mean_v = sum(v for _, v in pts) / len(pts)
    base["mean"] = mean_v
    if fit is None:
        return base
    slope, _, r2 = fit
    base["slope_per_s"] = slope
    base["r2"] = r2
    if mean_v:
        rel = (slope * 60.0 / abs(mean_v)) * 100.0
    elif slope > 0:
        rel = float("inf")
    else:
        rel = 0.0
    base["rel_pct_per_min"] = rel
    var_v = sum((v - mean_v) ** 2 for _, v in pts)
    if var_v <= 0.0:
        # Perfectly constant series: the strongest possible "flat".
        base["confidence"] = 1.0
        return base
    growing = (
        rel > threshold_pct_per_min
        and r2 >= min_r2
        and len(pts) >= min_samples
    )
    if growing:
        base["verdict"] = "growing"
        base["confidence"] = r2
    else:
        # Two independent ways a series is convincingly flat: a steep
        # nominal slope the fit cannot explain (sawtooth around a steady
        # mean — disk between compactions — has rel >> threshold but
        # r^2 ~ 0), or a well-fit slope far under the threshold.  Take
        # the stronger signal.
        base["confidence"] = max(
            0.0,
            min(
                1.0,
                max(
                    1.0 - r2,
                    1.0 - max(rel, 0.0) / threshold_pct_per_min,
                ),
            ),
        )
    return base


class ResourceSampler:
    """Background thread sampling process resources on an interval.

    Each tick feeds catalog gauges (when a registry is supplied),
    optionally a flight recorder (``resource`` entries), and an
    in-memory ``(t, v)`` series per metric for ``verdicts()``.
    ``dirs`` maps store labels to directories whose on-disk bytes are
    tracked (``mirbft_resource_disk_bytes{store=...}``).  ``device``
    names the card the process works on: with a ``cuda`` device a sample
    without the card's allocator gauges raises, so the background loop
    counts that tick as failed (``failed_ticks``) instead of recording a
    series without the card.
    """

    def __init__(
        self,
        registry=None,
        recorder=None,
        interval_s=0.5,
        dirs=None,
        node="proc",
        device=None,
    ):
        self.registry = registry
        self.recorder = recorder
        self.interval_s = max(0.05, float(interval_s))
        self.dirs = dict(dirs or {})
        self.node = node
        self.requires_card = str(device or "").startswith("cuda")
        self.series = {}
        self.failed_ticks = 0  # guarded-by: _lock
        self.last_error = None  # guarded-by: _lock
        self._t0 = time.perf_counter()
        self._stop = threading.Event()
        self._thread = None
        self._lock = threading.Lock()

    def sample_once(self):
        """Take one sample; safe to call without start() (tests)."""
        now = time.perf_counter() - self._t0
        sample = sample_process(self.dirs)
        # Device-plane gauges ride the same cadence; memory_sample() is
        # None until the process has initialised its card.
        from .device import memory_sample

        device = memory_sample()
        if device is None and self.requires_card:
            raise RuntimeError(
                "the card's allocator gauges are unreadable (torch.cuda "
                "not initialised in this process)"
            )
        if device is not None:
            for key, value in device.items():
                sample["device." + key] = value
        with self._lock:
            for name, value in sample.items():
                if value is None:
                    continue
                self.series.setdefault(name, []).append((now, value))
        if self.registry is not None:
            gauges = {
                "rss_bytes": "mirbft_resource_rss_bytes",
                "open_fds": "mirbft_resource_open_fds",
                "threads": "mirbft_resource_threads",
                "device.live_buffers": "mirbft_device_live_buffers",
                "device.live_buffer_bytes": "mirbft_device_live_buffer_bytes",
                "device.hbm_bytes": "mirbft_device_hbm_bytes",
            }
            for key, metric in gauges.items():
                if sample.get(key) is not None:
                    self.registry.gauge(metric).set(sample[key])
            for name, value in sample.items():
                if name.startswith("disk.") and value is not None:
                    self.registry.gauge(
                        "mirbft_resource_disk_bytes",
                        store=name[len("disk."):],
                    ).set(value)
        if self.recorder is not None:
            self.recorder.record(
                "resource",
                "resource.sample",
                self.node,
                {k: v for k, v in sample.items() if v is not None},
            )
        return sample

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception as exc:  # noqa: BLE001 — counted, reported
                # A failed tick (e.g. /proc raced away) must not kill the
                # sampler for the rest of the soak, and must not pass
                # unseen either: the soak gates on the count.
                with self._lock:
                    self.failed_ticks += 1
                    self.last_error = repr(exc)

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="obsv-resource-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
            self._thread = None

    def snapshot_series(self):
        with self._lock:
            return {name: list(pts) for name, pts in self.series.items()}

    def verdicts(self, **kwargs):
        """Leak verdict per sampled metric family.

        ``device.*`` series are sampled and recorded but excluded from
        the leak fit: the caching allocator's live and reserved bytes
        track its own block reuse, not process growth, and a
        growing-verdict there would gate PRs on allocator behaviour."""
        return {
            name: leak_verdict(pts, **kwargs)
            for name, pts in sorted(self.snapshot_series().items())
            if not name.startswith("device.")
        }
