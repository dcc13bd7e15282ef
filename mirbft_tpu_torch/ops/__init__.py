"""Compute plane: batched crypto kernels behind the Actions->Results seam.

The reference's hot path is serial host hashing (reference:
processor.go:133-143).  Here that compute is coalesced across action
batches into fixed-shape tensors and launched as one hand-written CUDA
kernel per chunk, with bucketed padding (ops.batching).
"""

from .batching import PreimageBatch, pack_preimages, to_tensors  # noqa: F401
from .sha256 import sha256_chunked, sha256_many  # noqa: F401


def kernel_launches() -> dict:
    """Each kernel wrapper's launch count so far (process-wide; a wrapper
    counts only launches on a card, so all read 0 on the CPU)."""
    from . import bls_g1, ed25519, sha256

    return {
        "launches_sha256": sha256.sha256_digest_words.launches,
        "launches_ed25519_decompress": ed25519.decompress.launches,
        "launches_ed25519_ladder": ed25519.ladder.launches,
        "launches_bls_g1": bls_g1.aggregate_points.launches,
    }


def zero_kernel_launches() -> None:
    """Set every count ``kernel_launches`` reads to 0."""
    from . import bls_g1, ed25519, sha256

    sha256.sha256_digest_words.launches = 0
    ed25519.decompress.launches = ed25519.ladder.launches = 0
    bls_g1.aggregate_points.launches = 0
