"""Probe of the schwarz_fwd and schwarz_bwd kernels on the card.

  python3 schwarz_probe.py check
  python3 schwarz_probe.py time [--root DIR] [--tag NAME]

`check` builds the kernels, prints the Schwarz kernels' -Xptxas -v lines
and runs chip_smoke.py's Schwarz gates on seeded random inputs, f64 and
f32: against the plain versions at ex4_p8's shape (8, 6094, 1553), a
rank's block (1, 6094, 1553), the ragged and wide shapes and views one
element past a 16-byte boundary; blocks 0 and p - 1 alone, a stack's
member, the offset views and a second launch bitwise equal to the batched
launch.  `time` times both kernels in f64 at (1, 6094, 1553) and
(8, 6094, 1553): back to back (mean of 20), queued (20 calls queued
while the card slept, so no host time between them: `device_ms`), cold
(the L2 refilled by a read of 512 MB before each call) and the pair
alternating on one A as the solve launches it, beside the plain version,
cuBLAS (back to back and queued), the byte bound and a sum over A
(`sum_ms`, the rate a library pass reads A at), with each CUDA launch's
time from the profiler; one JSON line a row.
--root names another checkout (an unpacked `git archive` of another
commit) whose chip_smoke.py and src/ are imported instead, so that two
commits are compared in one call: parent, change, change, parent.
Needs a CUDA device."""
import argparse
import json
import os
import sys
import time

ap = argparse.ArgumentParser()
ap.add_argument("role", choices=("check", "time"))
ap.add_argument("--root", default=".")
ap.add_argument("--tag", default="change")
a = ap.parse_args()
root = os.path.abspath(a.root)
sys.path[:0] = [root, os.path.join(root, "src")]
os.chdir(root)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

SHAPES = ((1, 6094, 1553), (8, 6094, 1553))
REPS = 20
t0 = time.time()
_build.load()
print(f"[{a.tag}] build {time.time() - t0:.1f} s", flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)


# The two timers below are chip_smoke.py's queued_ms and cold_ms, kept here
# so that a parent checkout's chip_smoke.py, which may lack them, serves.


def events_ms(fn, flush=None) -> float:
    """Mean device time of ``fn`` over REPS calls, CUDA events around
    each; ``flush`` (a buffer over the L2's size) is read first."""
    fn()
    pairs = []
    for _ in range(REPS):
        if flush is not None:
            flush.sum()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(x.elapsed_time(y) for x, y in pairs) / REPS


def queued_ms(fn) -> float:
    """Mean device time of ``fn`` over REPS calls queued while the card
    slept: no wait for the host between the launches."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    e0.record()
    for _ in range(REPS):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / REPS


def time_rows() -> None:
    flush = torch.zeros(128 << 20, dtype=torch.float32, device="cuda")
    names = ("schwarz_fwd", "schwarz_bwd")
    for shape in SHAPES:
        case = cs.random_case(*shape, 0, torch.float64, gen)
        fwd, bwd = (cs._kernel(n) for n in names)
        def pair():
            fwd(*case[names[0]])
            bwd(*case[names[1]])

        pair_ms, pair_dev = cs.time_ms(pair, REPS), queued_ms(pair)
        for name in names:
            args = case[name]
            bound, by = cs._bound(name, args)
            row = {"tag": a.tag, "name": name, "shape": list(shape),
                   "ms": cs.time_ms(lambda: cs._kernel(name)(*args), REPS),
                   "cold_ms": events_ms(lambda: cs._kernel(name)(*args),
                                        flush),
                   "device_ms": queued_ms(lambda: cs._kernel(name)(*args)),
                   "pair_ms": pair_ms, "pair_device_ms": pair_dev,
                   "plain_ms": cs.time_ms(lambda: cs._plain(name)(*args),
                                          REPS),
                   "library_ms": cs.time_ms(cs._library(name, args), REPS),
                   "bound_ms": bound, "bound_by": by}
            for key in ("ms", "device_ms", "cold_ms"):
                row[key.replace("ms", "share")] = bound / row[key]
            row["launches"] = cs.launch_times(
                lambda: cs._kernel(name)(*args), r"(schwarz_\w+_kernel)")
            row["library_device_ms"] = queued_ms(cs._library(name, args))
            # a library pass over A alone: the card's reading rate
            row["sum_ms"] = cs.time_ms(lambda: args[0].sum(), REPS)
            print(json.dumps(row), flush=True)


def check() -> None:
    for line in cs.ptxas_report(cs.SCHWARZ_PTXAS):
        print(f"  ptxas {line}")
    for dtype in (torch.float64, torch.float32):
        for shape in reversed(SHAPES):
            case = cs.random_case(*shape, 0, dtype, gen)
            for name in cs.SCHWARZ:
                cs.compare(name, case[name], dtype, f"random {shape}")
            cs.schwarz_bitwise(case, dtype, f"random {shape}")
        for p, m, w, pad in cs.RAGGED + cs.SCHWARZ_WIDE:
            case = cs.random_case(p, m, w, pad, dtype, gen)
            for name in cs.SCHWARZ:
                cs.compare(name, case[name], dtype, f"ragged {(p, m, w)}")
                cs.schwarz_offset(name, case[name], dtype,
                                  f"ragged {(p, m, w)}")


try:
    time_rows() if a.role == "time" else check()
except cs.SmokeFailure as exc:
    print(f"schwarz_probe: FAILED: {exc}", file=sys.stderr)
    sys.exit(1)
print(f"[{a.tag}] {a.role} done in {time.time() - t0:.1f} s; card: "
      f"{cs.phase_environment()}")
