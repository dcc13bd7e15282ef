"""Sharded crypto-plane programs over a mesh of torch devices.

The JAX package splits its crypto plane over a ``jax.sharding.Mesh`` with
``shard_map`` (``mirbft_tpu/parallel/sharding.py``).  The port's mesh is
the same idea without a collective library: an ordered tuple of
``torch.device``s on the one axis ``AXIS``, driven by the one process
that owns the plane (JAX's mesh is single-controller too).  A shard's
work is launched on its device; what JAX's collectives did is done here
by copies to ``devices[0]`` and the ``shard_sum`` kernel
(``ops.tally``), the port's ``psum``.  A mesh may name one device more
than once: ``[cuda:0] * 4`` runs the real four-way split, with the real
kernels, on one card, as the JAX tests' virtual CPU devices stand for
chips.

Three programs, as in the JAX package:

- ``sharded_sha256(mesh)``: the digest batch split over the mesh, each
  shard through the SHA-256 kernel, the digests gathered;
- ``sharded_quorum_tally(mesh)``: vote matrices split over voters, each
  shard's column sums by ``tally_columns``, then ``shard_sum`` of the
  partials against the threshold;
- ``sharded_ed25519_verify(mesh)``: signature rows decompressed on the
  host (``ops.ed25519.pack_signature_rows``, the JAX ``pack_rows``'s
  layout) split over the mesh, each shard through the extended ladder,
  the verdicts gathered.

The device ack plane (``core.device_tracker``) splits its dense state the
same way: each device owns a contiguous block of clients
(``split_blocks``, the counterpart of ``client_axis_sharding``), every
shard sees the whole batch (``replicate``, the counterpart of
``replicated_sharding``) and keeps the rows of its own block, and the
per-row outputs and the sweep's totals are merged by ``psum``.

Entry points run on the devices the mesh names: ``make_mesh`` with no
devices takes the visible cards and raises where there are fewer than
asked for (none at all: no CUDA card).  A CPU mesh is asked for by name:
``make_mesh(devices=[torch.device("cpu")] * 8)``.  On a CPU device every
kernel takes its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obsv import device as _device
from ..ops.batching import resolve_device
from ..ops.ed25519 import ladder_extended
from ..ops.sha256 import sha256_digest_words
from ..ops.tally import shard_sum, tally_columns

AXIS = "crypto"


def _mesh_device(device) -> torch.device:
    """A mesh's device: ``cuda`` (which needs a card) or ``cpu``, a card
    with its index filled in."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """An ordered tuple of devices on the axis ``AXIS``.  Shard i of any
    split lives on ``devices[i]``; ``devices[0]`` holds gathered results
    and sums.  A device may appear more than once."""

    def __init__(self, devices):
        devices = tuple(_mesh_device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = devices
        self.axis_names = (AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        names = ", ".join(str(d) for d in self.devices)
        return f"Mesh(({names}), axis={AXIS!r})"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of ``devices``, or of the first ``n_devices`` of them (every
    one when None).  With no ``devices``, the visible cards: it raises
    where there is no card, or fewer than ``n_devices``.  Unlike the JAX
    package's, it never moves to CPU devices on its own."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA card is present; pass devices="
                "[torch.device('cpu')] * n for a mesh of the CPU"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}"
            )
        devices = devices[:n_devices]
    return Mesh(devices)


def _checked(mesh: Mesh) -> Mesh:
    """The mesh, its devices checked again (a card may be gone)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a Mesh, got {type(mesh).__name__}")
    for device in mesh.devices:
        resolve_device(device)
    return mesh


def _tensor(x) -> torch.Tensor:
    """A tensor of ``x`` (numpy arrays without a copy)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _on(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x.to(device).contiguous()


def split_blocks(mesh: Mesh, x) -> list:
    """The leading axis of ``x`` cut into ``mesh.size`` contiguous blocks,
    block i on ``devices[i]`` (the JAX package's ``client_axis_sharding``).
    The axis must be a multiple of the mesh size."""
    x = _tensor(x)
    k = mesh.size
    if x.shape[0] % k:
        raise ValueError(
            f"leading axis {x.shape[0]} is not a multiple of the mesh "
            f"size {k}"
        )
    b = x.shape[0] // k
    return [_on(x[i * b:(i + 1) * b], d) for i, d in enumerate(mesh.devices)]


def replicate(mesh: Mesh, x) -> list:
    """``x`` on every device of the mesh, one copy a distinct device (the
    JAX package's ``replicated_sharding``)."""
    x = _tensor(x)
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = _on(x, d)
    return [copies[d] for d in mesh.devices]


def gather(mesh: Mesh, parts: list) -> torch.Tensor:
    """The shards' results joined along their leading axis on
    ``devices[0]``; one shard's is returned as it is."""
    if len(parts) == 1:
        return parts[0]
    home = mesh.devices[0]
    return torch.cat([p.to(home) for p in parts])


def psum(mesh: Mesh, parts: list, threshold=None) -> torch.Tensor:
    """The shards' (n,) int32 partials summed on ``devices[0]`` by the
    ``shard_sum`` kernel (its plain version on the CPU); with a threshold,
    the bool mask ``sum >= threshold``."""
    home = mesh.devices[0]
    if len(parts) == 1:
        stacked = parts[0].to(home).unsqueeze(0)
    else:
        stacked = torch.stack([p.to(home) for p in parts])
    return shard_sum(stacked, threshold)


def _int32_words(x) -> torch.Tensor:
    """uint32 words (numpy, as ``ops.batching`` packs them) or int32
    tensors -> int32 tensors of the same bits."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32)
                            .view(np.int32))


def sharded_sha256(mesh: Mesh):
    """Returns fn(blocks, n_blocks) -> (batch, 8) int32 digest words on
    ``mesh.devices[0]``, the batch split over the mesh, each shard through
    the SHA-256 kernel on its device.  ``blocks`` and ``n_blocks`` as
    ``ops.batching.pack_preimages`` packs them (numpy or tensors).  The
    batch must be a multiple of the mesh size (``pack_preimages(...,
    batch_floor=mesh.size)``).  On a mesh of one device it launches
    exactly what one ``sha256_digest_words`` call launches."""
    mesh = _checked(mesh)

    def run(blocks, n_blocks):
        blocks = _int32_words(blocks)
        n_blocks = _tensor(n_blocks).to(torch.int32)
        outs = [
            sha256_digest_words(b, c)
            for b, c in zip(split_blocks(mesh, blocks),
                            split_blocks(mesh, n_blocks))
        ]
        return gather(mesh, outs)

    return _device.instrument("sharded_sha256", fn_name="sharded_sha256")(run)


def sharded_quorum_tally(mesh: Mesh):
    """Returns fn(votes, threshold) -> (n_seqs,) bool mask of the sequences
    whose votes reach ``threshold``, on ``mesh.devices[0]``.  ``votes`` is
    a (n_voters, n_seqs) int8 or bool matrix split over voters (a multiple
    of the mesh size): each shard's column sums by ``tally_columns``, then
    ``shard_sum`` of the partials against the threshold, the port's psum.
    On one device: one ``tally_columns`` launch, one ``shard_sum``."""
    mesh = _checked(mesh)

    def run(votes, threshold):
        votes = _tensor(votes)
        if votes.dtype != torch.int8:
            votes = votes.to(torch.int8)
        parts = [tally_columns(v) for v in split_blocks(mesh, votes)]
        return psum(mesh, parts, threshold=int(threshold))

    return _device.instrument(
        "sharded_quorum_tally", fn_name="sharded_quorum_tally"
    )(run)


def sharded_ed25519_verify(mesh: Mesh):
    """Returns fn(s_words, k_words, neg_a, r_affine) -> (n,) int32 verdicts
    (nonzero: the signature verifies) on ``mesh.devices[0]``, the signature
    rows split over the mesh, each shard through the extended ladder
    (``ops.ed25519.ladder_extended``) on its device: the JAX function's
    signature and inputs, -A extended and R affine decompressed on the
    host.  The inputs are ``ops.ed25519.pack_signature_rows(rows,
    batch_floor=mesh.size)``'s ((n, 8) words of S and of k, (n, 4, 10) -A,
    (n, 2, 10) R; numpy or tensors), or the JAX ``pack_rows`` arrays
    through ``ops.ed25519.from_jax_rows``.  n must be a multiple of the
    mesh size.  On a mesh of one device it launches exactly what
    ``ops.ed25519.launch_signature_rows`` launches."""
    mesh = _checked(mesh)

    def run(s_words, k_words, neg_a, r_affine):
        s_words, k_words, neg_a, r_affine = (
            _tensor(a) for a in (s_words, k_words, neg_a, r_affine))
        n = s_words.shape[0]
        if (k_words.shape[0], neg_a.shape[0], r_affine.shape[0]) != (n,) * 3:
            raise ValueError(
                f"k_words, neg_a and r_affine must hold n = {n} rows, got "
                f"{k_words.shape[0]}, {neg_a.shape[0]} and "
                f"{r_affine.shape[0]}"
            )
        shards = zip(*(split_blocks(mesh, a)
                       for a in (neg_a, r_affine, s_words, k_words)))
        return gather(mesh, [ladder_extended(*shard) for shard in shards])

    return _device.instrument(
        "sharded_ed25519_verify", fn_name="sharded_ed25519_verify"
    )(run)
