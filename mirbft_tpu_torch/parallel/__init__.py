"""Multi-device scaling: device meshes, sharded crypto, tallies summed
across shards.

The reference scales with host-level concurrency (goroutine work pools,
reference: processor.go:183-470).  The JAX package splits the same work
over a device mesh; so does the port, on a mesh of torch devices:

- the digest batch is data-parallel across the mesh (each device hashes a
  shard of the preimages on the SHA-256 kernel);
- quorum tallies (prepare/commit/ack counting, reference:
  sequence.go:72-73, client_tracker.go:1018-1026) are column sums on each
  shard, added across the mesh by the ``shard_sum`` kernel.

See sharding.py; ``mirbft_tpu_torch.entry.dryrun_multichip`` drives this
path on a mesh of any devices.
"""

from .sharding import (  # noqa: F401
    make_mesh,
    sharded_sha256,
    sharded_quorum_tally,
)
