"""BASELINE ladder rung 3: the signed-mode configuration of bench.py:671-760.

64 nodes (f = 21), 1024 Ed25519-signed clients x 8 requests, BatchSize 200,
8 leader buckets, checkpoint interval 40, epochs of at most 400, client
window 8.  Clients sign before the clock starts (client-side work, not
replica throughput) and register their keys with the replicas, as a
deployment hands them over with the network configuration.

``nodes``, ``clients`` and ``reqs`` cut the rung for the CPU tests; the
defaults are the rung's.
"""

from __future__ import annotations

import functools
import multiprocessing

from .. import pb
from ..crypto import ed25519_host as host
from .signing import client_seed, register_pk, signing_message

NODES = 64
CLIENTS = 1024
REQS = 8
BATCH_SIZE = 200
BUCKETS = 8
CHECKPOINT_INTERVAL = 40
MAX_EPOCH_LENGTH = 400
CLIENT_WIDTH = 8


def client_ids(nodes: int = NODES, clients: int = CLIENTS) -> list:
    return [nodes + i for i in range(clients)]


def network_state(nodes: int = NODES, clients: int = CLIENTS) -> pb.NetworkState:
    """Few buckets and a short checkpoint interval tame the
    O(buckets * n^2) heartbeat traffic at this node count."""
    return pb.NetworkState(
        config=pb.NetworkConfig(
            nodes=list(range(nodes)),
            f=(nodes - 1) // 3,
            number_of_buckets=BUCKETS,
            checkpoint_interval=CHECKPOINT_INTERVAL,
            max_epoch_length=MAX_EPOCH_LENGTH,
        ),
        clients=[
            pb.NetworkClient(id=c, width=CLIENT_WIDTH, low_watermark=0)
            for c in client_ids(nodes, clients)
        ],
    )


def _sign_client(cid: int, reqs: int = REQS) -> tuple:
    """One client's key and its ``reqs`` signed requests (the engine's
    payloads, ``b"cid:rn"``)."""
    seed = client_seed(cid)
    pk = host.public_key(seed)
    data = []
    for rn in range(reqs):
        payload = b"%d:%d" % (cid, rn)
        sig = host.sign(seed, signing_message(cid, rn, payload))
        data.append(payload + sig + pk)
    return pk, data


def presign(processes: int = 1, *, nodes: int = NODES,
            clients: int = CLIENTS, reqs: int = REQS) -> dict:
    """{(client_id, req_no): signed request data} for every client, each
    client's key registered with ``register_pk``.  ``processes`` > 1 signs
    in a pool of spawned workers (a signature is milliseconds of
    pure-Python bigint work)."""
    ids = client_ids(nodes, clients)
    sign = functools.partial(_sign_client, reqs=reqs)
    if processes > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(processes) as pool:
            signed = pool.map(sign, ids, chunksize=16)
    else:
        signed = [sign(cid) for cid in ids]
    presigned = {}
    for cid, (pk, data) in zip(ids, signed):
        register_pk(cid, pk)
        for rn, item in enumerate(data):
            presigned[(cid, rn)] = item
    return presigned
