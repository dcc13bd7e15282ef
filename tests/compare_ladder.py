"""Time the Ed25519 ladders of ``csrc/ed25519.cu`` against another version
of the decompressed route's ladder, on a CUDA card.

This script builds ``csrc/ed25519.cu`` as it stands ("tree") and, with
``--baseline PATH``, another ``ed25519.cu`` (an earlier commit's), one
``nvcc`` each, into ``build/ladder_compare/``.  It first holds the tree's
extended ladder (the host route's) against its plain version, the RFC
8032 oracle and the device route's verdicts at n = 1, 3, 7, 8, 256, 512,
513, 1024 and 4096 rows (valid, corrupted, identity and order-8 keys,
every other row's -A scaled to Z != 1), and the baseline's ladder against
the tree's on the same decompressed points.  Then, at n = 512, 1024 and
4096, it times the baseline's ladder, the tree's ladder and the tree's
extended ladder in turns (baseline, tree, extended, extended, tree,
baseline) with chip_smoke's ``time_device`` (CUDA events over 20 launches
queued behind a spin kernel), and the host's ``marshal_signature`` a row.
It is part of no path:

    python3 tests/compare_ladder.py [--baseline PATH]

Prints the card's name and power limit, each build's ptxas report, one
line a check and a line a shape; the last line starts ``RESULT``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

CHECKED = (1, 3, 7, 8, 256, 512, 513, 1024, 4096)
TIMED = (512, 1024, 4096)


def build_baseline(path: Path) -> ctypes.CDLL:
    from mirbft_tpu_torch import _build

    out = ROOT / "build" / "ladder_compare"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libbaseline_ed25519.so"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    print(f"baseline {path}:\n{proc.stdout}", flush=True)
    proc.check_returncode()
    baseline = ctypes.CDLL(str(lib))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    baseline.mirbft_ed25519_ladder.argtypes = [ptr] * 5 + [i32, ptr, ptr]
    baseline.mirbft_ed25519_ladder.restype = i32
    return baseline


def signed_rows() -> list:
    """44 seeded (pk, msg, sig): valid, corrupted R, corrupted S and wrong
    message in turn, then the identity and a point of order 8 as keys."""
    from ed25519_corpus import order8_encoding
    from mirbft_tpu_torch.crypto import ed25519_host as host

    rng = random.Random(5)
    rows = []
    for i in range(42):
        seed, msg = rng.randbytes(32), rng.randbytes(20)
        pk, sig = host.public_key(seed), host.sign(seed, msg)
        if i % 4 == 1:
            sig = bytes([sig[0] ^ 2]) + sig[1:]
        elif i % 4 == 2:
            sig = sig[:40] + bytes([sig[40] ^ 8]) + sig[41:]
        elif i % 4 == 3:
            msg += b"?"
        rows.append((pk, msg, sig))
    r = 77
    r_sig = host.compress(host.scalar_mult(r, host.to_extended(
        host.BASE))) + r.to_bytes(32, "little")
    return rows + [((1).to_bytes(32, "little"), b"m", r_sig),
                   (order8_encoding(), b"m", r_sig)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", type=Path,
                        help="another ed25519.cu whose ladder to time")
    args = parser.parse_args(argv)

    import torch

    from chip_smoke import nvidia_smi, time_device
    from mirbft_tpu_torch import _build
    from mirbft_tpu_torch.crypto import ed25519_host as host
    from mirbft_tpu_torch.ops import ed25519

    if not torch.cuda.is_available():
        print("compare_ladder: no CUDA card is present", file=sys.stderr)
        return 1
    print(nvidia_smi("name,power.limit"), flush=True)
    lib = _build.build_all(["ed25519"])["ed25519"]
    print(lib.with_suffix(".ptxas.txt").read_text(), flush=True)
    baseline = build_baseline(args.baseline) if args.baseline else None
    card = torch.device("cuda")
    consts = ed25519._constants_on(card)
    base = signed_rows()
    oracle = {t: host.verify(*t) for t in base}
    accepted = [t for t in base if ed25519.marshal_signature(*t) is not None]
    ok = True

    def cycle(n):
        return (accepted * (n // len(accepted) + 1))[:n]

    for n in CHECKED:
        triples = cycle(n)
        lam = random.Random(n)
        rows = []
        for j, t in enumerate(triples):
            s, k, neg_a, r = ed25519.marshal_signature(*t)
            if j % 2:
                factor = lam.randrange(2, ed25519.P)
                neg_a = tuple(c * factor % ed25519.P for c in neg_a)
            rows.append((s, k, neg_a, r))
        s_words, k_words, neg_a, r_xy = (
            torch.from_numpy(a).to(card)
            for a in ed25519.pack_signature_rows(rows))
        got = ed25519.ladder_extended(neg_a, r_xy, s_words, k_words)
        torch.cuda.synchronize()
        plain = ed25519.ladder_extended_plain(neg_a, r_xy, s_words, k_words)
        device_route = ed25519.verify_batch(*map(list, zip(*triples)),
                                            device=card)
        want = [int(oracle[t]) for t in triples]
        same = (got.tolist() == plain.tolist() == want
                == [int(v) for v in device_route])
        ok &= same
        print(f"n={n}: extended ladder == plain == oracle == device route: "
              f"{same} ({sum(want)} accepted)", flush=True)

    timed = {}
    for n in TIMED:
        triples = cycle(n)
        light = [ed25519.marshal_light(*t) for t in triples]
        enc, s_words, k_words = (torch.from_numpy(a).to(card)
                                 for a in ed25519.pack_rows(light))
        xy, okf = ed25519.decompress(enc)
        start = time.perf_counter()
        host_rows = [ed25519.marshal_signature(*t) for t in triples]
        marshal_us = (time.perf_counter() - start) * 1e6 / n
        e_s, e_k, e_neg_a, e_r = (
            torch.from_numpy(a).to(card)
            for a in ed25519.pack_signature_rows(host_rows))
        out = torch.empty(n, dtype=torch.int32, device=card)

        def baseline_ladder():
            err = baseline.mirbft_ed25519_ladder(
                xy.data_ptr(), okf.data_ptr(), s_words.data_ptr(),
                k_words.data_ptr(), out.data_ptr(), n, consts.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"baseline ladder launch failed ({err})")

        tree = ed25519.ladder(xy, okf, s_words, k_words)
        calls = {
            "ladder": lambda: ed25519.ladder(xy, okf, s_words, k_words),
            "ladder_extended": lambda: ed25519.ladder_extended(
                e_neg_a, e_r, e_s, e_k),
        }
        turns = ["ladder", "ladder_extended", "ladder_extended", "ladder"]
        if baseline is not None:
            baseline_ladder()
            torch.cuda.synchronize()
            same = torch.equal(out, tree)
            ok &= same
            print(f"n={n}: baseline ladder == tree ladder: {same}")
            calls["baseline"] = baseline_ladder
            turns = ["baseline", *turns, "baseline"]
        ms = {name: [] for name in calls}
        for name in turns:
            ms[name].append(time_device(calls[name], 20)[0])
        timed[n] = {"marshal_signature_us": marshal_us, **ms}
        print(f"n={n}: " + "; ".join(
            f"{name} " + " / ".join(f"{v:.6f}" for v in values) + " ms"
            for name, values in ms.items())
            + f"; marshal_signature {marshal_us:.3f} us a row", flush=True)
    print("RESULT " + json.dumps({"ok": ok, "timed": timed}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
