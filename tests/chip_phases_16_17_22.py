"""chip_smoke.py's phases 16, 17 and 22 of one tree, each timed, on a card.

Run from the root of the tree to time (its ``chip_smoke.py`` and its
``mirbft_tpu_torch``), for example the parent's ``git archive`` unpacked
under ``build/parent`` and then this tree, on one card::

    (cd build/parent && python3 ../../tests/chip_phases_16_17_22.py)
    python3 tests/chip_phases_16_17_22.py

Prints each phase's lines and a ``TIMING`` line: phases 16 and 17
together (each phase prints when it is done, counted from their start)
and phase 22.
"""

import os
import sys
import time

sys.path.insert(0, os.getcwd())

if __name__ == "__main__":
    import chip_smoke
    from mirbft_tpu_torch import _build

    _build.build_all(["sha256", "ed25519"])
    t0 = time.perf_counter()
    chip_smoke.service_phases(t0)
    t1 = time.perf_counter()
    chip_smoke.cluster_phases(t1)
    t2 = time.perf_counter()
    print(f"TIMING {os.getcwd()}: phases 16+17 {t1 - t0:.3f} s, "
          f"phase 22 {t2 - t1:.3f} s", flush=True)
