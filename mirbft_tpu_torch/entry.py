"""Top-level entry points of the port (the counterpart of
``__graft_entry__.py``).

- ``entry(device)`` returns the framework's flagship compute as a forward
  function and its arguments: the batched SHA-256 digest kernel (the
  consensus hot path, reference: processor.go:133-143) over 32 preimages
  of 200 bytes (4 blocks each).
- ``dryrun_multichip(n_devices, devices)`` runs one step of the sharded
  crypto plane on an n-device mesh (the digest batch split over the
  ``crypto`` axis, the quorum tally's partials summed across it) on tiny
  shapes, and checks what it gives.

Both run on ``cuda`` unless the caller names other devices, and raise
where no card is present.  A torch mesh names its devices, so no
subprocess or environment is needed to put the dryrun on the CPU: pass
``devices=[torch.device("cpu")] * n``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .ops.batching import pack_preimages, resolve_device, to_tensors
from .ops.sha256 import sha256_digest_words, words_to_digests
from .parallel.sharding import (
    make_mesh,
    sharded_quorum_tally,
    sharded_sha256,
)


def entry(device="cuda"):
    """(forward, (blocks, n_blocks)): the SHA-256 kernel's wrapper and a
    packed batch of 32 preimages of 200 bytes on ``device``."""
    device = resolve_device(device)
    batch = pack_preimages([bytes([i]) * 200 for i in range(32)])
    return sha256_digest_words, to_tensors(batch, device)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """One crypto-plane step on a mesh of ``n_devices`` (the visible cards,
    or the first ``n_devices`` of ``devices``): digest a sharded preimage
    batch, then tally sharded votes summed across the mesh.  Raises on a
    wrong result; returns what it checked."""
    mesh = make_mesh(n_devices, devices=devices)
    n = mesh.size
    messages = [bytes([i % 256]) * 100 for i in range(4 * n)]
    batch = pack_preimages(messages, batch_floor=n)
    words = sharded_sha256(mesh)(batch.blocks, batch.n_blocks)
    assert tuple(words.shape) == (batch.blocks.shape[0], 8), words.shape
    raw = words_to_digests(words)
    for i, message in enumerate(messages):
        assert raw[32 * i:32 * i + 32] == hashlib.sha256(message).digest(), i

    tally = sharded_quorum_tally(mesh)
    n_seqs = 16
    votes = np.ones((n, n_seqs), dtype=np.int8)
    # Zero a majority of voters on the first half of the seqs: with
    # threshold > floor(n/2) for every n >= 1, those seqs must miss quorum.
    votes[: (n + 1) // 2, : n_seqs // 2] = 0
    mask = tally(votes, threshold=(2 * n) // 3 + 1).cpu()
    assert tuple(mask.shape) == (n_seqs,), mask.shape
    assert mask.dtype == torch.bool
    assert not bool(mask[0]) and bool(mask[-1])
    print(
        f"dryrun_multichip ok: {n}-device mesh {list(map(str, mesh.devices))},"
        f" digest batch {tuple(batch.blocks.shape)}, tally summed over "
        f"'{mesh.axis_names[0]}'"
    )
    return {
        "devices": [str(d) for d in mesh.devices],
        "digest_shape": list(words.shape),
        "mask": mask.tolist(),
    }
