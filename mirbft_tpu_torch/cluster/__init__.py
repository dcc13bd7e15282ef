"""Multi-process cluster runner: one OS process per consensus node.

The in-process drivers (testengine, chaos/live.py) share one Python
process; this package runs the real thing — N worker processes
(``python -m mirbft_tpu_torch.cluster``) supervised over a filesystem +
HTTP handshake, with true SIGKILL crashes, restart-from-disk on a stable
port, socket-proxy partitions, and emulated WAN link latency.  Every
worker runs its kernels on the supervisor's ``device``: ``cuda`` unless
the caller passes ``cpu`` (the kernels' plain versions).

- ``ClusterSupervisor`` (supervisor.py): spawn/kill/restart/teardown,
  partition control, client submission, commit tailing, each worker's
  exit codes and kernel evidence.
- ``worker`` (worker.py): the per-node process body.
- ``chaos_mp`` (chaos_mp.py): the ``chaos --live --cluster mp`` driver.
- ``WAN_PROFILES`` (profiles.py): lan/wan/geo link-latency presets.

Process spawning (``subprocess``) is confined to this package.
"""

from .chaos_mp import (  # noqa: F401
    MP_SMOKE_NAMES,
    mp_matrix,
    retry_storm_scenario,
    run_mp_campaign,
    run_mp_scenario,
)
from .profiles import WAN_PROFILES, profile_latency  # noqa: F401
from .supervisor import ClusterSupervisor, WorkerDied  # noqa: F401
