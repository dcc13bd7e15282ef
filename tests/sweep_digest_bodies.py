"""Time the SHA-256 digest kernel's two bodies side by side on a CUDA card.

``csrc/sha256.cu`` has one entry point, ``mirbft_sha256_digest``, which
takes the warp-specialised body for buckets of ``kWsMinBlocks`` blocks and
more and the one-thread body below.  This script builds the source twice
more with that threshold rewritten, so that one build takes the one-thread
body at every bucket and the other the specialised body, and times each
build's entry point at the packed (rows, blocks) shapes the system
launches: the engine's eight buckets (``AsyncKernelHashPlane.rows_for``)
and the live rung's (8 ... 4096 rows of 1 and 8 blocks).  It is the
evidence for the threshold, not part of any path:

    python3 tests/sweep_digest_bodies.py [--reps N]

Rows fill their bucket (from bucket/2 + 1 blocks up), the data made from a
seed.  Device times by CUDA events over launches queued behind a spin
kernel.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import random
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEED = 20261017
ENGINE_SHAPES = (
    (8192, 1), (8192, 2), (8192, 4), (4096, 8), (2048, 16), (1024, 32),
    (512, 64), (256, 128),
)
LIVE_SHAPES = tuple(
    (rows, blocks)
    for blocks in (1, 8)
    for rows in (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
)
THRESHOLD = re.compile(r"constexpr int kWsMinBlocks = \d+;")
VARIANTS = {"one-thread": 1 << 30, "specialised": 1}


def build_variant(name: str, min_blocks: int) -> Path:
    from mirbft_tpu_torch import _build

    source = (_build.CSRC / "sha256.cu").read_text()
    source, count = THRESHOLD.subn(
        f"constexpr int kWsMinBlocks = {min_blocks};", source
    )
    if count != 1:
        raise RuntimeError("sha256.cu: kWsMinBlocks not found once")
    out = ROOT / "build" / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"sha256_{name}.cu"
    src.write_text(source)
    lib = out / f"libsha256_{name}.so"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}")
    return lib


def batch(rng, rows: int, bucket: int):
    from mirbft_tpu_torch.ops.batching import pack_preimages, to_tensors

    top = bucket * 64 - 9
    low = 0 if bucket == 1 else 32 * bucket - 8
    messages = [rng.randbytes(rng.randrange(low, top + 1)) for _ in range(rows)]
    packed = pack_preimages(messages, block_floor=bucket, batch_floor=rows)
    assert packed.blocks.shape == (rows, bucket, 16), packed.blocks.shape
    return to_tensors(packed, "cuda")


def device_ms(launch, reps: int) -> float:
    import torch

    for _ in range(10):
        launch()
    torch.cuda.synchronize()
    began = torch.cuda.Event(enable_timing=True)
    ended = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 40e-6 * 2e9))  # ~40 us of host time a launch
    began.record()
    for _ in range(reps):
        launch()
    ended.record()
    ended.synchronize()
    return began.elapsed_time(ended) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=200)
    args = parser.parse_args()

    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("sweep_digest_bodies: no CUDA card is present", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS,
                                            VARIANTS.values())))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        lib.mirbft_sha256_digest.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.mirbft_sha256_digest.restype = ctypes.c_int
        libs[name] = lib

    rng = random.Random(SEED)
    print("rows blocks " + " ".join(f"{name}_ms" for name in libs)
          + " specialised/one-thread")
    for rows, bucket in ENGINE_SHAPES + LIVE_SHAPES:
        blocks, n_blocks = batch(rng, rows, bucket)
        out = torch.empty((rows, 8), dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        times, digests = {}, {}
        for name, lib in libs.items():
            def launch(lib=lib):
                err = lib.mirbft_sha256_digest(
                    blocks.data_ptr(), n_blocks.data_ptr(), out.data_ptr(),
                    rows, bucket, stream,
                )
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            times[name] = device_ms(launch, args.reps)
            digests[name] = out.clone()
        if not torch.equal(digests["one-thread"], digests["specialised"]):
            raise AssertionError(f"({rows}, {bucket}): the bodies disagree")
        print(f"{rows} {bucket} "
              + " ".join(f"{t:.6f}" for t in times.values())
              + f" {times['specialised'] / times['one-thread']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
