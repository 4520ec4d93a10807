#!/usr/bin/env python3
"""Clock cycles per add of one warp's chain of dependent float64 adds: the
floor under the long-row combine's left-to-right sum (each chunk's partial
is added to the running sum in order).

    python3 tools/add_chain.py [--adds 3008]

Run from the root of a checkout on a machine with a CUDA card and nvcc.  It
builds ``tools/add_chain.cu`` into ``src/repro_torch/build/add_chain/`` and
prints, for operands in registers, in shared memory (the combine's
staging) and by shuffles, the cycles per add (``clock64`` around the chain,
median of 10 launches) and the SM clock those cycles ran at (cycles over
the launch's CUDA-event time), beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MODES = {0: "registers", 1: "shared memory", 2: "shuffles"}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--adds", type=int, default=3008)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("add_chain: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "add_chain" / "libadd_chain.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(ROOT / "tools" / "add_chain.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    P = ctypes.c_void_p
    lib.add_chain.argtypes = [P, P, P, ctypes.c_int, ctypes.c_int, P]
    lib.add_chain.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"gpu: {smi}", flush=True)
    dev = torch.device("cuda")
    x = torch.randn(32, dtype=torch.float64, device=dev)
    res = torch.zeros(1, dtype=torch.float64, device=dev)
    cyc = torch.zeros(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for mode, name in MODES.items():
        per, mhz = [], []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)
            start.record()
            err = lib.add_chain(x.data_ptr(), res.data_ptr(), cyc.data_ptr(), args.adds, mode,
                                stream)
            end.record()
            if err:
                raise SystemExit(f"launch failed: {err}")
            torch.cuda.synchronize()
            per.append(cyc.item() / args.adds)
            mhz.append(cyc.item() / (start.elapsed_time(end) * 1e3))
        print(f"operands in {name}: {statistics.median(per):.2f} cycles per dependent add "
              f"({args.adds} adds; SM clock at least {statistics.median(mhz):.0f} MHz)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
