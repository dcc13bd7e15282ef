"""Host-side cryptographic reference implementations.

``ed25519_host`` is the RFC 8032 oracle: clients sign with it, and the
Ed25519 kernels (``ops.ed25519``) are held against it verdict for verdict.
``mac`` holds the per-link MAC authenticators of the live node's replica
channels (``Config.link_auth``, ``runtime/transport.py``).
"""

from . import ed25519_host as ed25519_host
