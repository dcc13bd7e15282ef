"""mirbft_tpu_torch: the MirBFT rebuild on PyTorch and CUDA.

The protocol core (``core``), the wire format (``pb``, ``wire``) and the
deterministic test engine (``testengine``) are the host-side modules of
``mirbft_tpu`` carried over unchanged.  The compute plane is new: every
digest on the engine's commit path comes from a hand-written SHA-256
kernel for Hopper (``csrc/sha256.cu``), launched through ``ops.sha256``,
and in signed mode every signature verdict from two hand-written Ed25519
kernels (``csrc/ed25519.cu``: point decompression and the windowed Shamir
ladder), launched through ``ops.ed25519`` by ``testengine.signing``.

This package imports neither ``jax`` nor ``mirbft_tpu``.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; a CPU tensor takes
the kernel's plain PyTorch version, and a CUDA tensor always takes the
kernel.
"""

__version__ = "0.1.0"
