"""Scalar/vector divergence oracle for the client-tracker ack planes.

Mir assumes replicas are deterministic state machines; replayability
(and every chaos invariant built on it) only holds if the ``_FastAcks``
vector path computes exactly what the scalar reference path
(``ClientReqNo.apply_request_ack`` / ``_step_ack_loop``) would have.
The two live in different representations — uint64 limb masks and a
digest byte-matrix on one side, per-object dicts on the other — so a
bookkeeping bug (a missed refresh, a threshold crossed with ``>`` where
the scalar uses ``>=``) silently forks the replica until something
downstream disagrees.

``audit_tracker`` re-derives, per mirror slot, what the scalar rules
say the dict state must be — weak/strong membership from the popcount
of the agreement mask against the cached quorums, available-list
membership from the weak crossing, tick_class from the reference
classifier — and reports every mismatch as a divergence record.  It is
the ground-truth check the live-cluster audit (``Node.audit_divergence``)
and the ack-plane rung (``bench.ackplane_run``) call.

``ShadowSampler`` is the always-on form: hooked into ``step_ack_many``
(via ``hooks.shadow``), it audits the slots each Nth frame touched — a
deterministic stride, no randomness (W12) — bumps
``mirbft_divergence_total{component}`` and flushes the FlightRecorder
once on first divergence so the post-mortem ring captures the frames
that led up to the fork.

Divergence components:

- ``committed``: mirror flags a slot COMMITTED but the object disagrees.
- ``weak`` / ``strong``: dict membership vs mask popcount quorum test.
- ``available``: a weak-quorum canonical request missing from the
  available list.
- ``membership``: structural invariants (strong ⊆ weak ⊆ requests).
- ``tick_class``: the mirror's vectorized tick class vs the reference
  classifier on the live object.
"""

from __future__ import annotations

import os

from .metrics import CardinalityError

#: Audit every Nth ack frame by default.  The audit is O(touched slots)
#: and frames are large on the vector path, so 16 keeps overhead well
#: under the obsv budget while still catching a fork within a handful
#: of frames (asserted by the injected-divergence test).
DEFAULT_STRIDE = 16


def resolve_stride(stride=None) -> int:
    """Sampler stride resolution: explicit value (Config.shadow_stride or
    a direct constructor arg) wins, then the ``MIRBFT_SHADOW_STRIDE`` env
    knob, then :data:`DEFAULT_STRIDE`.  Large-fleet rungs dial this up to
    cut audit overhead without losing the oracle
    (docs/OBSERVABILITY.md#shadow-oracle)."""
    if stride is not None:
        return max(1, int(stride))
    env = os.environ.get("MIRBFT_SHADOW_STRIDE")
    if env:
        return max(1, int(env))
    return DEFAULT_STRIDE


def _slot_ident(fast, slot):
    ci = int(fast.client_of[slot])
    client_id = ci + fast.cid0
    req_no = int(fast.base_arr[ci]) + slot - int(fast.offset_arr[ci])
    return client_id, req_no


def _available_ids(tracker):
    ids = set()
    it = tracker.available_list.iterator()
    while it.has_next():
        ids.add(id(it.next()))
    return ids


def _slot_divergences(fast, slot, crn, avail_ids):
    client_id, req_no = _slot_ident(fast, slot)

    def div(component, detail):
        return {
            "component": component,
            "slot": int(slot),
            "client_id": client_id,
            "req_no": req_no,
            "detail": detail,
        }

    out = []
    flags = int(fast.flags[slot])
    if flags & fast.COMMITTED:
        if crn is None or crn.committed is None:
            out.append(
                div("committed", "mirror COMMITTED but object uncommitted")
            )
        return out
    if crn is None:
        return out

    if not (flags & fast.SLOW) and fast.canon_ok[slot]:
        req = fast.canon_req[slot]
        key = req.ack.digest
        count = fast.combine_agree(slot).bit_count()
        in_weak = key in crn.weak_requests
        if in_weak != (count >= fast.weak_q):
            out.append(
                div(
                    "weak",
                    f"popcount {count} (weak_q {fast.weak_q}) vs "
                    f"weak_requests membership {in_weak}",
                )
            )
        in_strong = key in crn.strong_requests
        if in_strong != (count >= fast.strong_q):
            out.append(
                div(
                    "strong",
                    f"popcount {count} (strong_q {fast.strong_q}) vs "
                    f"strong_requests membership {in_strong}",
                )
            )
        if (
            count >= fast.weak_q
            and not req.garbage
            and id(req) not in avail_ids
        ):
            out.append(
                div("available", "weak-quorum request not in available list")
            )
        # NOTE: agreement voters are deliberately NOT checked against
        # non_null_voters — apply_forward_request bumps agreements
        # out-of-band without a non-null vote (that mask is only the
        # direct-ack spam guard), so agree ⊆ nonnull is not an invariant.

    weak_keys = set(crn.weak_requests)
    if not set(crn.strong_requests) <= weak_keys:
        out.append(div("membership", "strong_requests not subset of weak"))
    if not weak_keys <= set(crn.requests):
        out.append(div("membership", "weak_requests not subset of requests"))

    mirror_cls = int(fast.tick_class[slot])
    ref_cls = fast._classify_tick(crn)
    if mirror_cls != ref_cls:
        out.append(
            div(
                "tick_class",
                f"mirror class {mirror_cls} vs reference {ref_cls}",
            )
        )
    return out


def audit_tracker(tracker, slots=None):
    """Diff the tracker's vector mirror against the scalar rules.

    Returns a list of divergence dicts (empty = provably consistent on
    the audited slots).  ``slots=None`` audits every mirror slot; pass
    an iterable of slot indices to audit a frame's touched subset.
    Vacuously empty when the tracker has no live mirror — the scalar
    path IS the reference, there is nothing to diverge.

    A tracker running the device ack plane (core.device_tracker) is
    audited the same way against its dense arrays — slot indices then
    refer to the device plane's layout (only one plane is ever live).
    """
    fast = getattr(tracker, "_fast", None)
    if fast is None:
        return audit_device_plane(tracker, slots)
    fast.flush_canon_rows()
    avail_ids = _available_ids(tracker)
    if slots is None:
        slots = range(len(fast.canon_req))
    out = []
    for slot in slots:
        crn = fast.canon_crn[slot]
        out.extend(_slot_divergences(fast, slot, crn, avail_ids))
    return out


def audit_device_plane(tracker, slots=None):
    """Diff the device ack plane's dense arrays against the scalar rules
    — the device analogue of the ``_FastAcks`` audit above, with the same
    divergence components.  Flushing pending batches first is the sync
    point; staged (host-authoritative) slots are skipped by contract —
    their array rows are stale by design until the next flush re-derives
    them (docs/DEVICE_TRACKER.md)."""
    dev = getattr(tracker, "_device", None)
    if dev is None:
        return []
    import numpy as np

    from ..core.device_tracker import (
        COMMITTED,
        SLOW,
        classify_tick_device,
    )

    dev.flush(drain=tracker)
    snap = dev.host_snapshot()
    avail_ids = _available_ids(tracker)
    if slots is None:
        slots = range(dev.total)
    staged = dev._staged
    agree = snap["agree"]
    canon_ok = snap["canon_ok"]
    flags_arr = snap["flags"]
    held_arr = snap["held"]
    tick_arr = snap["tick_class"]
    out = []
    for slot in slots:
        if slot in staged:
            continue
        ci = slot // dev.w_pad
        if ci >= dev.n_clients or dev.clients[ci] is None:
            continue  # client-axis padding / dense-id gap: phantom rows
        crn = dev.canon_crn[slot]
        flags = int(flags_arr[slot])
        client_id, req_no = dev._ident(slot)

        def div(component, detail, *, _slot=slot, _cid=client_id,
                _rno=req_no):
            return {
                "component": component,
                "slot": int(_slot),
                "client_id": _cid,
                "req_no": _rno,
                "detail": detail,
            }

        if flags & COMMITTED:
            if crn is None or crn.committed is None:
                out.append(
                    div("committed", "device COMMITTED but object uncommitted")
                )
            continue
        if crn is None:
            continue

        got_cls = int(tick_arr[slot])
        if not (flags & SLOW) and canon_ok[slot]:
            req = dev.canon_req[slot]
            if req is None:
                out.append(
                    div(
                        "membership",
                        "device canonical slot with no materialized request",
                    )
                )
                continue
            key = req.ack.digest
            count = int(np.bitwise_count(agree[slot]).sum())
            in_weak = key in crn.weak_requests
            if in_weak != (count >= dev.weak_q):
                out.append(
                    div(
                        "weak",
                        f"popcount {count} (weak_q {dev.weak_q}) vs "
                        f"weak_requests membership {in_weak}",
                    )
                )
            in_strong = key in crn.strong_requests
            if in_strong != (count >= dev.strong_q):
                out.append(
                    div(
                        "strong",
                        f"popcount {count} (strong_q {dev.strong_q}) vs "
                        f"strong_requests membership {in_strong}",
                    )
                )
            if (
                count >= dev.weak_q
                and not req.garbage
                and id(req) not in avail_ids
            ):
                out.append(
                    div("available", "weak-quorum request not in available list")
                )
            exp_held = key in crn.my_requests and crn.acks_sent > 0
            exp_cls = classify_tick_device(
                False, False, count, exp_held, True, dev.weak_q
            )
            if bool(held_arr[slot]) != exp_held or got_cls != exp_cls:
                out.append(
                    div(
                        "tick_class",
                        f"device class {got_cls} (held {bool(held_arr[slot])})"
                        f" vs reference {exp_cls} (held {exp_held})",
                    )
                )
        elif flags & SLOW:
            my_or_weak = bool(crn.my_requests or crn.weak_requests)
            exp_cls = classify_tick_device(
                False, True, 0, False, my_or_weak, dev.weak_q
            )
            if got_cls != exp_cls:
                out.append(
                    div(
                        "tick_class",
                        f"device slow class {got_cls} vs reference {exp_cls}",
                    )
                )

        weak_keys = set(crn.weak_requests)
        if not set(crn.strong_requests) <= weak_keys:
            out.append(div("membership", "strong_requests not subset of weak"))
        if not weak_keys <= set(crn.requests):
            out.append(div("membership", "weak_requests not subset of requests"))
    return out


class ShadowSampler:
    """Sampling shadow-executor wired into ``step_ack_many``.

    Install via ``hooks.enable(...)`` + ``hooks.shadow = ShadowSampler()``
    or pass ``shadow=`` to ``hooks.enable``.  ``step_ack_many`` calls
    ``on_frame(tracker, msgs)`` after applying each frame; every
    ``stride``-th frame the slots that frame touched are audited.
    """

    def __init__(self, stride=None, registry=None, recorder=None):
        self.stride = resolve_stride(stride)
        self.registry = registry
        self.recorder = recorder
        self.frames = 0
        self.audits = 0
        self.divergences: list = []
        self._dumped = False

    def on_frame(self, tracker, msgs) -> None:
        self.frames += 1
        if self.frames % self.stride:
            return
        plane = getattr(tracker, "_fast", None)
        if plane is None:
            plane = getattr(tracker, "_device", None)
        if plane is None:
            return
        slots = set()
        for msg in msgs:
            ack = msg.type
            slot = plane.slot_of(ack.client_id, ack.req_no)
            if slot is not None:
                slots.add(slot)
        if not slots:
            return
        self.audits += 1
        divs = audit_tracker(tracker, sorted(slots))
        if divs:
            self._record(divs)

    def audit_full(self, tracker) -> list:
        """Audit every slot now (end-of-run sweeps); records like on_frame."""
        divs = audit_tracker(tracker)
        if divs:
            self._record(divs)
        return divs

    def _record(self, divs) -> None:
        from . import hooks

        self.divergences.extend(divs)
        registry = self.registry
        if registry is None and hooks.enabled:
            registry = hooks.metrics
        if registry is not None:
            for d in divs:
                try:
                    registry.counter(
                        "mirbft_divergence_total", component=d["component"]
                    ).inc()
                except CardinalityError:
                    pass
        recorder = self.recorder if self.recorder is not None else hooks.recorder
        if recorder is not None and not self._dumped:
            self._dumped = True
            recorder.record_note(
                "shadow.divergence",
                args={"count": len(divs), "first": divs[0]},
            )
            try:
                recorder.flush("shadow-divergence")
            except Exception:
                pass  # dump_dir unset or unwritable: the note is in the ring
