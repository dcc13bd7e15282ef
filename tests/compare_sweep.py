"""Time the ack plane's quorum sweep against other versions of it on a
CUDA card.

This script builds ``csrc/ack_plane.cu`` as it stands ("tree"), copies of
it with the sweep's group and block rewritten (``--shape SLOTS,THREADS``,
repeatable: SLOTS slots a thread, 4, 8 or 16, THREADS threads a block),
and each ``--baseline PATH``, another ``ack_plane.cu``
(an earlier commit's: the one-thread-a-slot sweep behind a memset of its
totals, recognised by having no ``mirbft_ack_sweep_grid``).  One ``nvcc``
each, started together, into ``build/sweep/``.  It holds each build's
sweep against the plain version on the card, bit for bit (totals and
ticks, twice in a row), then times each on the ack-plane rung's final
state (chip_smoke phase 13's: 131,072 x 2 slots, 100,000 of them live and
certified), beside the empty kernel launched on the build's own grid (its
launch floor), with chip_smoke's ``time_events`` (CUDA events around one
launch queued behind a spin kernel, the median of 20 on fresh copies).

``--no-tail`` adds a probe, not a version: the tree's sweep cut after
each block has written its partials, with no ticket and no last block.
Its totals are not written, so it is timed unchecked; tree minus probe is
what the cross-block sum costs.  Builds are timed in turns, ``--turns``
times each (default 3), so a drift of the card reaches all of them.  It
is part of no path:

    python3 tests/compare_sweep.py [--shape S,T ...] [--no-tail]
        [--baseline PATH ...] [--turns 3]

Prints the card's name and power limit, each build's ptxas line and grid,
one line a turn, then the medians; the last line starts ``RESULT``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

# The tree's sweep after the block's partials are stored: the ticket, the
# last block's sum and the totals (cut by --no-tail).
TAIL_START = "    last = draw_ticket(ticket)"
TAIL_END = "\n}\n\n// The sweep's grid"


def rewrite(source: str, name: str, value: int) -> str:
    """``source`` with its ``constexpr int name`` set to ``value``."""
    source, n = re.subn(rf"constexpr int {name} = \d+;",
                        f"constexpr int {name} = {value};", source)
    if n != 1:
        raise ValueError(f"ack_plane.cu: no single {name}")
    return source


def variant(source: str, *, shape=None, no_tail=False) -> str:
    """The tree's source with its sweep's group and block rewritten, or
    its tail cut."""
    if shape is not None:
        source = rewrite(source, "kSweepSlots", shape[0])
        source = rewrite(source, "kSweepThreads", shape[1])
    if no_tail:
        start = source.index(TAIL_START)
        end = source.index(TAIL_END)
        source = source[:start] + "  }" + source[end:]
    return source


def build(name: str, source: str) -> tuple:
    """Compile one source into build/sweep/; (library, ptxas line of the
    sweep kernel)."""
    from mirbft_tpu_torch import _build

    out = ROOT / "build" / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"ack_plane_{name}.cu"
    src.write_text(source)
    lib = out / f"liback_plane_{name}.so"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}")
    block = proc.stdout.split("mirbft_ack_sweep_kernel", 1)[1]
    report = " ".join(
        re.search(pattern, block).group(0)
        for pattern in (r"Used \d+ registers", r"\d+ bytes stack frame",
                        r"\d+ bytes spill stores", r"\d+ bytes spill loads")
    )
    return lib, report


class Sweep:
    """One build's sweep and its empty launch, through its own C ABI."""

    def __init__(self, path: Path, total: int):
        import torch

        self.lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        self.ticketed = hasattr(self.lib, "mirbft_ack_sweep_grid")
        self.lib.mirbft_ack_sweep_empty.argtypes = [i32, ptr]
        if self.ticketed:
            self.lib.mirbft_ack_sweep.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
            self.lib.mirbft_ack_sweep_grid.argtypes = [i32] + [
                ctypes.POINTER(i32)] * 3
            grid = [ctypes.c_int() for _ in range(3)]
            self.lib.mirbft_ack_sweep_grid(total, *map(ctypes.byref, grid))
            self.grid = [g.value for g in grid]
            self.ticket = torch.zeros((1,), dtype=torch.int32, device="cuda")
        else:
            self.lib.mirbft_ack_sweep.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
            self.grid = [-(-total // 256), 256, 1]
        self.total = total

    def __call__(self, agree, canon_ok, flags, held, tick, *, weak_q,
                 strong_q):
        import torch

        limbs = agree.shape[-1]
        stream = torch.cuda.current_stream().cuda_stream
        totals = torch.empty((3,), dtype=torch.int32, device="cuda")
        ptrs = [t.data_ptr() for t in (agree, canon_ok, flags, held, tick,
                                       totals)]
        if self.ticketed:
            partials = torch.empty((3 * self.grid[0],), dtype=torch.int32,
                                   device="cuda")
            ptrs += [partials.data_ptr(), self.ticket.data_ptr()]
        err = self.lib.mirbft_ack_sweep(*ptrs, self.total, limbs, weak_q,
                                        strong_q, stream)
        if err:
            raise RuntimeError(f"sweep launch failed: CUDA error {err}")
        return totals

    def empty(self) -> None:
        import torch

        err = self.lib.mirbft_ack_sweep_empty(
            self.total, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"empty launch failed: CUDA error {err}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shape", action="append", default=[],
                        help="SLOTS,THREADS: slots a thread and threads a "
                        "block")
    parser.add_argument("--no-tail", action="store_true")
    parser.add_argument("--baseline", type=Path, action="append", default=[],
                        help="another ack_plane.cu, built and timed as it is")
    parser.add_argument("--turns", type=int, default=3)
    args = parser.parse_args()

    import torch

    import chip_smoke as cs
    from mirbft_tpu_torch import _build
    from mirbft_tpu_torch.ops import ack_plane

    if not torch.cuda.is_available():
        print("compare_sweep: no CUDA card is present", file=sys.stderr)
        return 1
    print(cs.nvidia_smi("name,power.limit,clocks.max.sm"))
    tree = (_build.CSRC / "ack_plane.cu").read_text()
    sources = {"tree": tree}
    for shape in args.shape:
        slots, threads = map(int, shape.split(","))
        sources[f"slots{slots}x{threads}"] = variant(
            tree, shape=(slots, threads))
    for i, path in enumerate(args.baseline, 1):
        print(f"baseline{i}: {path}")
        sources[f"baseline{i}"] = path.read_text()
    checked = dict.fromkeys(sources, True)
    if args.no_tail:
        sources["probe_no_tail"] = variant(tree, no_tail=True)
        checked["probe_no_tail"] = False
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources, sources.values())))

    # The rung's final state: chip_smoke phase 13's.
    c_pad, w_pad, clients = 131072, 2, 100000
    state, _batch = cs.rung_step_inputs(clients, 3, c_pad, w_pad)
    state[0][:] = 0b1110
    args5 = [state[i] for i in (0, 3, 4, 5, 6)]
    kw = dict(weak_q=2, strong_q=3)
    cases = cs.ack_plane_cases()
    mixed = cases.make_sweep_case(cs.SEED, 8193, 1)
    sweeps = {}
    for name, (path, report) in built.items():
        sweep = sweeps[name] = Sweep(path, c_pad * w_pad)
        print(f"{name}: {report}; grid {sweep.grid} (blocks, threads, "
              f"slots a thread)")
        if not checked[name]:
            continue
        for plane, pkw in ((args5, kw), (cases.sweep_tensors(mixed, "cuda"),
                                         dict(weak_q=mixed["weak_q"],
                                              strong_q=mixed["strong_q"]))):
            small = Sweep(path, plane[1].numel())
            kernel = [t.clone() for t in plane]
            plain = [t.clone() for t in plane]
            for _ in range(2):
                got = (small if plane is not args5 else sweep)(*kernel, **pkw)
                want = ack_plane.quorum_sweep_plain(*plain, **pkw)
                if got.tolist() != want.tolist() or not torch.equal(
                        kernel[4], plain[4]):
                    raise AssertionError(f"{name}: sweep != plain")
    times = {name: [] for name in sweeps}
    floors = {name: [] for name in sweeps}
    for turn in range(args.turns):
        for name, sweep in sweeps.items():
            times[name].append(cs.time_events(
                lambda: [t.clone() for t in args5],
                lambda *a, sweep=sweep: sweep(*a, **kw)))
            floors[name].append(cs.time_events(lambda: [], sweep.empty))
        print(f"turn {turn + 1}: " + ", ".join(
            f"{name} {times[name][-1]:.6f} ms (floor "
            f"{floors[name][-1]:.6f})" for name in sweeps), flush=True)
    result = {name: {"ms": statistics.median(times[name]),
                     "floor_ms": statistics.median(floors[name]),
                     "grid": sweeps[name].grid,
                     "ptxas": built[name][1], "checked": checked[name]}
              for name in sweeps}
    for name, r in result.items():
        print(f"{name}: median {r['ms']:.6f} ms, floor {r['floor_ms']:.6f} "
              f"ms, above the floor {1e3 * (r['ms'] - r['floor_ms']):.3f} us")
    print("RESULT", json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
