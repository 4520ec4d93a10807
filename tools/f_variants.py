#!/usr/bin/env python3
"""Time kernel F (the single instance's bound merge) before its redesign
and as the port ships it, on ``pb`` of ``chip_smoke.py``: a thread per
column with a fill before each launch, against the merge body of #9 and
#15 on one plane with the loop carry's fold (see ``tools/f_variants.cu``).

    python3 tools/f_variants.py [--reps 30]

Run from the root of a checkout on a machine with a CUDA card and nvcc.  It
builds ``tools/f_variants.cu`` into ``src/repro_torch/build/f_variants/``,
makes ``pb`` (n = 60,000, K = 128), takes kernel D's candidate planes at its
initial bounds (so nearly every accumulator entry holds a candidate, as on
the first rounds) and, for each variant, holds the merged bounds, the
handed-back planes and the flag or carry against the plain version, then
times it two ways, the variants in turn within each repetition and the
inputs restored before each launch: the device time of the kernel
(``torch.profiler``, as in a fixed point's trace) and the time between CUDA
events around the launch queued behind a sleep (launch latency included).
The fill that zeroed the flag before the redesign is timed apart.  Prints
the medians and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "tools" / "f_variants.cu"
VARIANTS = {
    0: "before the redesign: a thread per column, every tightening thread stores the flag "
       "(zeroed by a fill)",
    1: "the port's F: merge body of #9/#15 on one plane, four columns a thread, one store "
       "per warp, folded into the loop carry by the last block",
}
CARRY = (1,)


def build() -> ctypes.CDLL:
    out = ROOT / "src" / "repro_torch" / "build" / "f_variants" / "libf_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(out), str(SOURCE)], check=True)
    lib = ctypes.CDLL(str(out))
    P, I64, F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    lib.f_variant.argtypes = [ctypes.c_int] + [P] * 6 + [I64, F64, F64, P]
    lib.f_variant.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("f_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    import repro_torch.data as td
    from repro_torch.core import carry as rt_carry
    from repro_torch.kernels import ref as tref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    lib = build()
    dev = torch.device("cuda")
    p = td.make_pseudo_boolean(n=60_000, m=150_000, seed=0)
    prep = rt.prepare_block_ell(p, device=dev)
    d, cfg = prep.d, rt.core.DEFAULT_CONFIG
    eps, inf = cfg.eps_for(torch.float64), cfg.inf
    best = tref.fused_scatter_round_tiles_ref(d.val, d.col, prep.ii_g, prep.lhs_g, prep.rhs_g,
                                              prep.lb0, prep.ub0, prep.n_pad, cfg.int_eps, inf)
    want = tref.merge_carry_ref(prep.lb0, prep.ub0, best[0].clone(), best[1].clone(), eps, inf,
                                0.0, rt_carry.armed_state(dev), 0, 1)
    want_carry = rt_carry.armed_state(dev)
    want_carry[rt_carry.ROUNDS] = 1
    want_carry[rt_carry.GO] = int(bool(want[2]))
    pristine = (prep.lb0, prep.ub0, best[0], best[1], rt_carry.armed_state(dev),
                torch.zeros((), dtype=torch.bool, device=dev))
    scratch = tuple(t.clone() for t in pristine)
    flush = torch.empty(64 << 17, dtype=torch.float64, device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    ptr = lambda t: t.data_ptr()

    def reset():
        for s, t in zip(scratch, pristine):
            s.copy_(t)
        flush.zero_()

    def launch(v):
        lb, ub, bl, bu, carry, flag = scratch
        if v == 0:
            flag.zero_()  # the fill of the redesign's predecessor, before each launch
        err = lib.f_variant(v, *map(ptr, (lb, ub, bl, bu, flag, carry)), prep.n_pad, eps, inf,
                            stream())
        if err:
            raise RuntimeError(f"variant {v}: CUDA error {err}")

    for v in VARIANTS:
        reset()
        launch(v)
        torch.cuda.synchronize()
        lb, ub, bl, bu, carry, flag = scratch
        ok = torch.equal(lb, want[0]) and torch.equal(ub, want[1])
        ok &= bool((bl == -inf).all()) and bool((bu == inf).all())
        ok &= torch.equal(carry, want_carry) if v in CARRY else bool(flag) == bool(want[2])
        if not ok:
            print(f"f_variants: variant {v} disagrees with the plain version", file=sys.stderr)
            return 1

    events = {v: [] for v in VARIANTS}
    device = {v: [] for v in VARIANTS}
    fills = []
    for _ in range(args.reps):
        for v in VARIANTS:
            reset()
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(v)
            end.record()
            torch.cuda.synchronize()
            events[v].append(start.elapsed_time(end))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for v in VARIANTS:
                reset()
                launch(v)
            torch.cuda.synchronize()
        items = [(e.name, e.time_range.elapsed_us()) for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        kernels = [us for name, us in items if "f_before_kernel" in name
                   or "merge_grid_kernel" in name]
        if len(kernels) != len(VARIANTS):
            print(f"f_variants: the profiler recorded {len(kernels)} merges, not "
                  f"{len(VARIANTS)}", file=sys.stderr)
            return 1
        for v, us in zip(VARIANTS, kernels):
            device[v].append(us)
        fills += [us for name, us in items if "FillFunctor<bool>" in name]
    print(f"gpu: {smi}")
    print(f"pb: n_pad {prep.n_pad}, {int((best[0] != -inf).sum() + (best[1] != inf).sum())} "
          f"candidate entries handed back, flag {bool(want[2])}; medians of {args.reps}")
    for v, what in VARIANTS.items():
        print(f"variant {v}: device {statistics.median(device[v]):.2f} us, events "
              f"{statistics.median(events[v]) * 1e3:.2f} us -- {what}")
    if fills:
        print(f"the flag's fill before each launch (variant 0): device "
              f"{statistics.median(fills):.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
