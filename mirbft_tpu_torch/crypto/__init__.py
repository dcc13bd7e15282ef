"""Host-side cryptographic reference implementations.

``ed25519_host`` is the RFC 8032 oracle: clients sign with it, and the
Ed25519 kernels (``ops.ed25519``) are held against it verdict for verdict.
``mac`` holds the per-link MAC authenticators of the live node's replica
channels (``Config.link_auth``, ``runtime/transport.py``).  ``bls_host``
is the BLS12-381 oracle (signing, pairing checks, the host fold the G1
aggregation kernel is held against) and ``qc`` the certificate seam over
it and ``ops.bls_g1``.  ``ed25519_batch`` is the host batch verifier
(a random linear combination); it is a reference and a named route only.
"""

from . import ed25519_host as ed25519_host
