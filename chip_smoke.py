"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
and drives the port's main path — the streaming DD-KF engine
(``repro_torch.assim.AssimilationEngine``, single-device solver) — at the
paper's size: n = 2048, p = 8, m = 2000 observations per cycle on
``drifting_swarm`` (``EXAMPLE4`` ``ex4_p8`` of ``repro/configs/cls_paper``),
then a 2D shelf tiling with overlap at the same width.  Each engine runs
three ways: (a) through the kernels, (b) the same again, (c) through the
plain PyTorch versions.  It fails unless every cycle's analysis is within
1e-10 of the direct CLS solve, (a) and (b) are bitwise equal, (a) and (c)
agree within 1e-12, the host decisions of all three match, and the launch
counters show that (a) ran every kernel and (c) none.  Each kernel is then
held against its plain version on the card, in f64 and f32, on the
engine's first packing, on random values at the same shapes and at
ragged shapes, and timed beside its bound, the plain version and one
library call.

Needs one CUDA card and ``nvcc``; imports nothing of JAX.  Exits nonzero
on any failure, and when there is no card.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense peaks: FP64 (tensor core) 67 TFLOP/s,
# FP32 67 TFLOP/s outside the tensor cores; HBM3 3.35 TB/s.
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

REPLACES = {
    "gram": "src/repro/kernels/gram.py:58",
    "schwarz_fwd": "src/repro/kernels/schwarz_step.py:69",
    "schwarz_bwd": "src/repro/kernels/schwarz_step.py:130",
}
SOURCES = {
    "gram": "src/repro_torch/kernels/csrc/gram.cu",
    "schwarz_fwd": "src/repro_torch/kernels/csrc/schwarz_step.cu",
    "schwarz_bwd": "src/repro_torch/kernels/csrc/schwarz_step.cu",
}
REL_TOL = {torch.float64: 1e-12, torch.float32: 1e-4}


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_environment() -> str:
    print("== environment")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
          f", count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    return smi


def phase_build():
    from repro_torch.kernels import _build
    print("== build")
    t0 = time.perf_counter()
    _build.load()
    print(f"built {len(list(_build.CSRC.glob('*.cu')))} sources in "
          f"{time.perf_counter() - t0:.1f} s")
    for log in _build.BUILD_LOG:
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "warning", "error")):
                print("  " + line.strip())


def run_engine(cfg, scenario: str, m: int, cycles: int):
    """One engine run through the user entry point; returns the journal,
    the per-cycle analyses, the launch counts of this run alone and the
    packing (with its rhs) that the run solved first."""
    from repro_torch.assim import AssimilationEngine
    from repro_torch.kernels import ops

    eng = AssimilationEngine(cfg)
    analyses = []
    eng.on_analysis = lambda cycle, x: analyses.append(x)
    solved = []
    solve_input = eng.solve_input

    def keep_first(prep):
        out = solve_input(prep)
        if not solved:
            solved.append(out[0])
        return out

    eng.solve_input = keep_first
    ops.reset_counts()
    t0 = time.perf_counter()
    journal = eng.run_scenario(scenario, m=m, cycles=cycles)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    return journal, analyses, counts, wall, solved[0]


HOST_FIELDS = ("loads", "loads_before", "repartitioned", "migrated",
               "rounds", "rebalance_suppressed")


def phase_engine(title: str, cfg, scenario: str, m: int, cycles: int):
    print(f"== engine: {title}")
    runs = {}
    first = None
    variants = (("a", cfg), ("b", cfg),
                ("c", dataclasses.replace(cfg, solver_kernel="plain",
                                          gram_mode="plain")))
    for tag, c in variants:
        journal, xs, counts, wall, packed = run_engine(c, scenario, m,
                                                       cycles)
        runs[tag] = (journal, xs, counts)
        if tag == "a":
            first = packed
        errs = [r.error_vs_direct for r in journal.records]
        p50 = {k: round(v["p50"] * 1e3, 3)
               for k, v in journal.phase_stats().items()}
        print(f"  ({tag}) solver_kernel={c.solver_kernel} "
              f"gram_mode={c.gram_mode}: {wall:.2f} s for {cycles} cycles, "
              f"launches {counts}, max err vs direct {max(errs):.3e}")
        print(f"      phase p50 ms: {json.dumps(p50, sort_keys=True)}")
        check(len(journal.records) == cycles and all(
            e <= 1e-10 for e in errs),
            f"({tag}) every cycle within 1e-10 of the direct solve")
    ja, xa, ca = runs["a"]
    jb, xb, _ = runs["b"]
    jc, xc, cc = runs["c"]
    check(all(torch.equal(u, v) for u, v in zip(xa, xb)),
          "(a) and (b) analyses bitwise equal")
    diff = max(float((u - v).abs().max()) for u, v in zip(xa, xc))
    check(diff <= 1e-12, f"(a) vs (c) max abs diff {diff:.3e} <= 1e-12")
    for tag, j in (("b", jb), ("c", jc)):
        check(all(getattr(r, f) == getattr(s, f) for r, s in
                  zip(ja.records, j.records) for f in HOST_FIELDS),
              f"host decisions of (a) and ({tag}) identical")
    check(ca["gram"] >= cycles and ca["schwarz_fwd"] == cycles * cfg.iters
          and ca["schwarz_bwd"] == cycles * cfg.iters,
          f"(a) ran the kernels: {ca}")
    check(all(v == 0 for v in cc.values()), f"(c) ran no kernel: {cc}")
    from repro_torch.core import ddkf
    # Run (a)'s first packing and its analysis gathered to local slots:
    # the kernels' inputs on the main path.
    return ca, (first, ddkf.gather_local(first, xa[0]))


def phase_profile(cfg, scenario: str, m: int, cycles: int) -> None:
    """Where one cycle's time goes: ``torch.profiler`` over the engine's
    prepare and solve of cycle 0 — host wall times, the device's busy
    share of them, and the operations with the most device time."""
    from repro_torch.assim import AssimilationEngine, CycleStep, streams
    from torch.profiler import ProfilerActivity, profile

    print("== profile: one ex4_p8 cycle (prepare + solve)")
    eng = AssimilationEngine(cfg)
    obs = next(iter(streams.make_stream(scenario, m, cycles)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prep = eng.prepare(0, obs)
        t1 = time.perf_counter()
        eng.solve_step(CycleStep(cycle=0, obs=obs, prep=prep))
        t2 = time.perf_counter()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # Device-side entries only (kernels, copies): the host ops that
    # launched them carry the same time again.
    events = sorted((e for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")),
                    key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    wall_ms = (t2 - t0) * 1e3
    print(f"  prepare {(t1 - t0) * 1e3:.1f} ms, solve {(t2 - t1) * 1e3:.1f} "
          f"ms (host wall); device busy {busy_ms:.1f} ms = "
          f"{busy_ms / wall_ms:.3f} of the wall time")
    for e in events[:10]:
        print(f"    {dev_us(e) / 1e3:9.3f} ms device  {e.count:6d} calls  "
              f"{e.key[:70]}")


def kernel_cases(packed, x_loc, dtype):
    """Inputs of the three kernels at one packing's shapes."""
    from repro_torch.kernels import ref

    A = packed.A_loc.to(dtype)
    p, m, _ = A.shape
    x = x_loc.to(dtype).contiguous()
    wdiv, muov, mask = (t.to(dtype) for t in
                        (packed.wdiv, packed.muov, packed.mask))
    r, b = packed.r.to(dtype), packed.b.to(dtype)
    y, u = ref.schwarz_fwd_plain(A, x, wdiv)
    Ax = y.sum(dim=0)
    return {
        "gram": (A, r.expand(p, m).contiguous()),
        "schwarz_fwd": (A, x, wdiv),
        "schwarz_bwd": (A, r, b, Ax, u.contiguous(), x, muov, mask),
    }


# Ragged shapes: m and w off every tile, w = 1, zero-padded columns.
RAGGED = ((3, 1001, 77, 0), (2, 37, 1, 0), (2, 300, 130, 9), (1, 5, 300, 40))


def random_case(p: int, m: int, w: int, pad: int, dtype, gen):
    """Random inputs of the three kernels at (p, m, w), with random
    positive r and the last ``pad`` columns zero."""
    def v(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64,
                           device="cuda").to(dtype)

    A = v(p, m, w)
    mask = torch.ones(p, w, dtype=dtype, device="cuda")
    if pad:
        A[:, :, w - pad:] = 0.0
        mask[:, w - pad:] = 0.0
    r = v(m).abs()
    return {
        "gram": (A, r.expand(p, m).contiguous()),
        "schwarz_fwd": (A, v(p, w), v(p, w).abs()),
        "schwarz_bwd": (A, r, v(m), v(m), v(p, m), v(p, w), v(p, w).abs(),
                        mask),
    }


def _plain(name):
    from repro_torch.kernels import ref
    return {"gram": ref.gram_plain, "schwarz_fwd": ref.schwarz_fwd_plain,
            "schwarz_bwd": ref.schwarz_bwd_plain}[name]


def _kernel(name):
    from repro_torch.kernels import gram, schwarz_step
    return {"gram": gram.gram, "schwarz_fwd": schwarz_step.schwarz_fwd,
            "schwarz_bwd": schwarz_step.schwarz_bwd}[name]


def _library(name, args):
    """One cuBLAS batched product computing the kernel's function (with
    the small elementwise parts of the function around it; gram's
    scaling by r, a pass over all of A, is made before the timing)."""
    if name == "gram":
        A, r = args
        Ar = A * r[..., None]
        return lambda: torch.bmm(A.mT, Ar)
    if name == "schwarz_fwd":
        A, x, wdiv = args
        return lambda: torch.bmm(A, torch.stack([x * wdiv, x], dim=2))
    A, r, b, Ax, u, x, muov, mask = args
    return lambda: torch.baddbmm(
        (muov * x)[:, None, :], (r[None] * ((b - Ax)[None] + u))[:, None, :],
        A)[:, 0] * mask


def _bound(name, args):
    """(bound_ms, bound_by): the larger of bytes moved (each input read
    once, each output written once) over the HBM rate and the flops over
    the dtype's peak."""
    A = args[0]
    p, m, w = A.shape
    it = A.element_size()
    if name == "gram":
        flops = p * m * w * (w + 1)            # symmetric half, 2 per FMA
        elems = p * m * w + p * m + p * w * w
    elif name == "schwarz_fwd":
        flops = 4 * p * m * w
        elems = p * m * w + 2 * p * w + 2 * p * m
    else:
        flops = 2 * p * m * w + 4 * p * m + 3 * p * w
        elems = p * m * w + 3 * m + p * m + 3 * p * w + p * w
    t_ops = flops / PEAK_FLOPS[A.dtype] * 1e3
    t_bytes = elems * it / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def compare(name, args, dtype, label):
    out_k = _kernel(name)(*args)
    out_p = _plain(name)(*args)
    torch.cuda.synchronize()
    outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
    outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
    err = max(float((k - q).abs().max()) for k, q in zip(outs_k, outs_p))
    scale = max(float(q.abs().max()) for q in outs_p) or 1.0
    ok = all(k.shape == q.shape and bool(torch.isfinite(k).all())
             for k, q in zip(outs_k, outs_p))
    check(ok and err / scale <= REL_TOL[dtype],
          f"{name} {label} {str(dtype)[6:]}: max abs err {err:.3e}, "
          f"rel {err / scale:.3e} <= {REL_TOL[dtype]:g}")
    return err


def phase_kernels(main_cases, counts):
    """Kernel vs plain at the main path's shapes (f64, f32): the engine's
    first packing, and random values with random positive r at the same
    (p, m, w); then at ragged shapes.  The timings of the first (main)
    packing go into the JSON line; its max_abs_err is the larger f64 one
    of the two main-shape cases."""
    print("== kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for label, (packed, x_loc) in main_cases:
        real = int(packed.mask.sum())
        print(f"  {label} first packing: w = {packed.w}, {real} real "
              f"column slots of p*w = {packed.p * packed.w} "
              f"({real / (packed.p * packed.w):.3f} of A_loc is not "
              f"padding)")
        shape = tuple(packed.A_loc.shape)
        timed = not rows
        for dtype in (torch.float64, torch.float32):
            for name, args in random_case(*shape, 0, dtype, gen).items():
                err = compare(name, args, dtype, f"{label} random {shape}")
                if timed and dtype == torch.float64:
                    rows[name] = {"max_abs_err": err}
            cases = kernel_cases(packed, x_loc, dtype)
            for name, args in cases.items():
                err = compare(name, args, dtype, f"{label} {shape}")
                if not timed or dtype != torch.float64:
                    continue
                reps = 5 if name == "gram" else 20
                bound, by = _bound(name, args)
                rows[name] = {
                    "name": name, "ok": True, "route": "cuda",
                    "source": SOURCES[name],
                    "replaces": REPLACES[name],
                    "launches": counts[name],
                    "max_abs_err": max(err, rows[name]["max_abs_err"]),
                    "ms": time_ms(lambda: _kernel(name)(*args), reps),
                    "plain_ms": time_ms(lambda: _plain(name)(*args), reps),
                    "bound_ms": bound, "bound_by": by,
                    "library_ms": time_ms(_library(name, args), reps),
                    "shape": list(args[0].shape), "dtype": "float64",
                }
                print(f"  {name} {label}: kernel {rows[name]['ms']:.4f} ms, "
                      f"plain {rows[name]['plain_ms']:.4f} ms, library "
                      f"{rows[name]['library_ms']:.4f} ms, bound "
                      f"{bound:.4f} ms ({by})")
    for dtype in (torch.float64, torch.float32):
        for p, m, w, pad in RAGGED:
            for name, args in random_case(p, m, w, pad, dtype, gen).items():
                compare(name, args, dtype, f"ragged {(p, m, w)}")
    return [rows[k] for k in ("gram", "schwarz_fwd", "schwarz_bwd")]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this check runs "
              "only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.assim import EngineConfig

    t_start = time.perf_counter()
    smi = phase_environment()
    phase_build()

    paper = EngineConfig(n=2048, p=8, iters=120, track_reference=True)
    counts_1d, main_1d = phase_engine(
        "ex4_p8 (n=2048, p=8, m=2000, drifting_swarm, 6 cycles)", paper,
        "drifting_swarm", 2000, 6)
    shelf = EngineConfig(ndim=2, nx=64, ny=32, pr=2, pc=4, overlap=1,
                         damping=0.7, iters=120, track_reference=True)
    counts_2d, main_2d = phase_engine(
        "2D shelf 64x32, 2x4 cells, overlap 1, damping 0.7 "
        "(rotating_swarm, m=2000, 3 cycles)", shelf, "rotating_swarm",
        2000, 3)

    rows = phase_kernels([("ex4_p8", main_1d), ("shelf2d", main_2d)],
                         counts_1d)
    phase_profile(paper, "drifting_swarm", 2000, 6)
    print(f"== done in {time.perf_counter() - t_start:.1f} s "
          f"(2D launches {counts_2d})")
    print(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
