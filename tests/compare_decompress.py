"""Time Ed25519 point decompression against another version of it on a
CUDA card.

This script builds ``csrc/ed25519.cu`` as it stands and each
``--baseline PATH``, another ``ed25519.cu`` (an earlier commit's, or a
copy with ``kDecGroup`` rewritten; one ``nvcc`` each, started together,
into ``build/sweep/``), holds each build's decompression against the plain
version on the card, bit for bit, and times each at the main path's
shapes: n = 512, 1024 and 4096 signatures, 2n points.  It compares
versions within one run on one card, and is part of no path:

    python3 tests/compare_decompress.py [--reps N] [--baseline PATH ...]

Points: the decompression corpus (tests/ed25519_corpus.py), then random y
(about half of them no point) with random sign bits, from a seed; the
kernel's work does not depend on the data.  Device times by CUDA events
over launches queued behind a spin kernel.  Prints the card's name and
power limit first, then each build's ptxas report.
"""

from __future__ import annotations

import argparse
import ctypes
import random
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from sweep_digest_bodies import device_ms  # noqa: E402

SEED = 20261018
SIGNATURES = (512, 1024, 4096)


def build(name: str, source: str) -> tuple:
    """Compile one source into build/sweep/; (library path, ptxas line of
    the decompress kernel)."""
    from mirbft_tpu_torch import _build

    out = ROOT / "build" / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"ed25519_{name}.cu"
    src.write_text(source)
    lib = out / f"libed25519_{name}.so"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}")
    block = proc.stdout.split("mirbft_ed25519_decompress_kernel", 1)[1]
    report = " ".join(
        re.search(pattern, block).group(0)
        for pattern in (r"Used \d+ registers", r"\d+ bytes stack frame",
                        r"\d+ bytes spill stores", r"\d+ bytes spill loads")
    )
    return lib, report


def encodings(rng, rows: int) -> list:
    from ed25519_corpus import decompression_corpus

    encs = decompression_corpus()[:rows]
    while len(encs) < rows:
        raw = bytearray(rng.randbytes(32))
        raw[31] &= 0xBF  # y < 2^254 < p; the sign bit random
        raw[31] |= rng.getrandbits(1) << 7
        encs.append(bytes(raw))
    return encs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--baseline", type=Path, action="append", default=[],
                        help="another ed25519.cu to build and time as it is "
                        "(repeatable: baseline1, baseline2, ...)")
    args = parser.parse_args()

    import torch

    from mirbft_tpu_torch import _build
    from mirbft_tpu_torch.ops import ed25519

    if not torch.cuda.is_available():
        print("compare_decompress: no CUDA card is present",
              file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    sources = {"tree": (_build.CSRC / "ed25519.cu").read_text()}
    for i, path in enumerate(args.baseline, 1):
        print(f"baseline{i}: {path}")
        sources[f"baseline{i}"] = path.read_text()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources, sources.values())))
    libs = {}
    for name, (path, report) in built.items():
        print(f"{name}: {report}")
        lib = ctypes.CDLL(str(path))
        lib.mirbft_ed25519_decompress.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.mirbft_ed25519_decompress.restype = ctypes.c_int
        libs[name] = lib

    rng = random.Random(SEED)
    consts = torch.from_numpy(ed25519.constants()).to("cuda")
    print("n points " + " ".join(f"{name}_ms" for name in libs))
    for n in SIGNATURES:
        rows = 2 * n
        enc = torch.from_numpy(ed25519._words(encodings(rng, rows))).to("cuda")
        plain_xy, plain_ok = ed25519.decompress_plain(enc)
        xy = torch.empty((rows, 2, 10), dtype=torch.int32, device="cuda")
        ok = torch.empty((rows,), dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        times = {}
        for name, lib in libs.items():
            def launch(lib=lib, name=name):
                err = lib.mirbft_ed25519_decompress(
                    enc.data_ptr(), xy.data_ptr(), ok.data_ptr(), rows,
                    consts.data_ptr(), stream,
                )
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            xy.fill_(-1)
            launch()
            torch.cuda.synchronize()
            if not (torch.equal(xy, plain_xy) and torch.equal(ok, plain_ok)):
                raise AssertionError(f"{name} at n = {n}: != plain")
            times[name] = device_ms(launch, args.reps)
        print(f"{n} {rows} " + " ".join(f"{t:.6f}" for t in times.values()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
