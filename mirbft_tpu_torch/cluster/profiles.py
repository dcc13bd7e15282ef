"""Emulated WAN profiles for the multi-process cluster runner.

Each profile is a per-link one-way delay plus uniform jitter, applied at
the transport send queue (``TcpTransport.set_link_latency``) of *every*
directed link, so a profile models a symmetric mesh.  Delays are held in
the sender's per-peer queue — frames stay coalescible and the emulation
adds no extra sockets or threads.

The numbers are deliberately round: ``lan`` is the loopback baseline
(no added delay), ``wan`` approximates a single-continent deployment,
``geo`` a geo-replicated one.  Scenario-specific asymmetric maps can be
passed straight to ``ClusterSupervisor(latency=...)`` instead.
"""

from __future__ import annotations

# profile name -> (one-way delay ms, uniform jitter ms)
WAN_PROFILES: dict = {
    "lan": (0.0, 0.0),
    "wan": (30.0, 5.0),
    "geo": (80.0, 15.0),
}


def profile_latency(profile: str, node_count: int) -> dict:
    """Lower a named profile into the per-link latency map shipped in
    worker specs: ``{peer_id: {"delay_ms": d, "jitter_ms": j}}`` for one
    node (the map is identical for every node in a symmetric profile)."""
    try:
        delay_ms, jitter_ms = WAN_PROFILES[profile]
    except KeyError:
        raise ValueError(
            f"unknown WAN profile {profile!r}; choose from "
            f"{sorted(WAN_PROFILES)}"
        ) from None
    if delay_ms == 0.0 and jitter_ms == 0.0:
        return {}
    return {
        peer: {"delay_ms": delay_ms, "jitter_ms": jitter_ms}
        for peer in range(node_count)
    }
