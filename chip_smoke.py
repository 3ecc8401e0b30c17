"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
and drives the port's two paths through the entry points a user calls.

DD-KF: the streaming engine (``repro_torch.assim.AssimilationEngine``,
single-device solver) at the paper's size: n = 2048, p = 8, m = 2000
observations per cycle on ``drifting_swarm`` (``EXAMPLE4`` ``ex4_p8`` of
``repro/configs/cls_paper``), then a 2D shelf tiling with overlap at the
same width.  Each engine runs three ways: (a) through the kernels, (b)
the same again, (c) through the plain PyTorch versions.  It fails unless
every cycle's analysis is within 1e-10 of the direct CLS solve, (a) and
(b) are bitwise equal, (a) and (c) agree within 1e-12, the host
decisions of all three match, and the launch counters show that (a) ran
every kernel and (c) none.

LM serving: ``repro_torch.launch.serve.serve_batch`` on RecurrentGemma-9B
at full width in bf16 (weights drawn on the card from a seeded
generator), four requests of 4096, 3072, 2500 and 1800 prompt tokens
left-padded to 4096, 32 greedy tokens each: (a) through the kernels, (b)
the same again, bitwise equal to (a), (c) the prefill through the plain
versions, within 2e-2 of (a) in the last-position logits (relative to
their max-abs) and in the trunk's output less the embedding (Frobenius
over Frobenius, and within 0.2 at the worst position), (d) the prefill through the kernels with every kernel
call held against its plain version on that call's inputs.  The launch
counters must show 12 ``flash_attention`` and 26 ``rglru_scan`` launches
for the prefill.  The smoke config (f32) is also served on the card and
on the CPU, whose plain path the CPU tests hold to the JAX package.

Each kernel is then held against its plain version on the card, on the
main path's own inputs, on random values at the same shapes and at
ragged shapes, and timed beside its bound, the plain version and one
library call.  ``torch.profiler`` traces one DD-KF cycle and one LM
prefill.

Needs one CUDA card and ``nvcc``; imports nothing of JAX.  Exits nonzero
on any failure, and when there is no card.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense peaks: FP64 (tensor core) 67 TFLOP/s,
# FP32 67 TFLOP/s outside the tensor cores, BF16 (tensor core) 989
# TFLOP/s; HBM3 3.35 TB/s.
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12,
              torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12

REPLACES = {
    "gram": "src/repro/kernels/gram.py:58",
    "schwarz_fwd": "src/repro/kernels/schwarz_step.py:69",
    "schwarz_bwd": "src/repro/kernels/schwarz_step.py:130",
    "flash_attention": "src/repro/kernels/flash_attention.py:118",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:57",
}
SOURCES = {
    "gram": "src/repro_torch/kernels/csrc/gram.cu",
    "schwarz_fwd": "src/repro_torch/kernels/csrc/schwarz_step.cu",
    "schwarz_bwd": "src/repro_torch/kernels/csrc/schwarz_step.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "rglru_scan": "src/repro_torch/kernels/csrc/rglru_scan.cu",
}
REL_TOL = {torch.float64: 1e-12, torch.float32: 1e-4}
# The LM kernels' tolerances, as in tests/test_kernels.py.
LM_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Full-width RecurrentGemma-9B, kernels vs plain route, the trunk's output
# less the embedding: the worst position's difference norm over its norm.
# bf16 rounding differences that grow through 38 random layers give
# 5.6e-2; run (e), the last attention layer's last 64 rows zeroed, gives
# 0.44 (NVIDIA H100 80GB HBM3, 700.00 W).
TRUNK_ROW_TOL = 0.2


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

    wall_ms = (t2 - t0) * 1e3
    print(f"  prepare {(t1 - t0) * 1e3:.1f} ms, solve {(t2 - t1) * 1e3:.1f} "
          f"ms (host wall)")
    device_report(prof, wall_ms, 10)


def device_report(prof, wall_ms: float, top: int) -> None:
    """Print the device's busy time and share of ``wall_ms``, and the
    ``top`` device operations by time, from a ``torch.profiler`` run."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # Device-side entries only (kernels, copies): the host ops that
    # launched them carry the same time again.
    events = sorted((e for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")),
                    key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    print(f"  device busy {busy_ms:.1f} ms = {busy_ms / wall_ms:.3f} of "
          f"the {wall_ms:.1f} ms wall time, "
          f"{sum(e.count for e in events)} device operations")
    for e in events[:top]:
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


# ---------------------------------------------------------------------------
# LM serving: RecurrentGemma-9B.
# ---------------------------------------------------------------------------

LM_ARCH = "recurrentgemma-9b"
DEVICE = "cuda"
PROMPT_LENS = (4096, 3072, 2500, 1800)
MAX_NEW = 32


@contextlib.contextmanager
def wrapped(module, name: str, wrap):
    """Replace ``module.name`` by ``wrap(module.name)`` for the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def keep_prefill(store: list):
    """Wrap ``steps.make_prefill_step`` so each prefill's batch and
    last-position logits are kept in ``store``."""
    def wrap(make):
        def make_and_keep(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(params, batch):
                out = step(params, batch)
                store.append((batch, out[0]))
                return out
            return run
        return make_and_keep
    return wrap


def keep_first_call(store: dict, name: str):
    """Wrap a kernel op so its first call's arguments land in ``store``."""
    def wrap(fn):
        def run(*args, **kwargs):
            store.setdefault(name, (args, kwargs))
            return fn(*args, **kwargs)
        return run
    return wrap


def compare_calls(errs: dict, name: str):
    """Wrap a kernel op so every call's output is also held against the
    op's plain version on the same inputs; ``errs[name]`` gets each
    call's (max abs err, relative err, input dtype)."""
    def wrap(fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            kw = {k: v for k, v in kwargs.items() if k != "mode"}
            plain = lm_plain(name)(*args, **kw).float()
            err = float((out.float() - plain).abs().max())
            scale = float(plain.abs().max()) or 1.0
            errs.setdefault(name, []).append((err, err / scale,
                                              args[0].dtype))
            return out
        return run
    return wrap


def keep_trunk_output(store: dict):
    """Wrap ``transformer._rglru_prefill_block`` so the residual stream it
    returns lands in ``store["h"]``.  The prefill's last block is a tail
    RG-LRU block, so what stays is the trunk's output before the final
    norm."""
    def wrap(block):
        def run(*args, **kwargs):
            h, cache = block(*args, **kwargs)
            store["h"] = h
            return h, cache
        return run
    return wrap


def serve_run(cfg, params, prompts, kept_inputs=None):
    """One ``serve_batch`` of the prompts, greedy; returns the prefill's
    (batch, logits), the generated tokens, the stats and the launch
    counts of this run alone.  ``kept_inputs`` (a dict) receives the
    arguments of the first call of each kernel op and the prefill's
    trunk output (:func:`keep_first_call`, :func:`keep_trunk_output`)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.runtime import steps

    reqs = [serve.Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    kept = []
    with contextlib.ExitStack() as stack:
        stack.enter_context(wrapped(steps, "make_prefill_step",
                                    keep_prefill(kept)))
        if kept_inputs is not None:
            for name in ("flash_attention", "rglru_scan"):
                stack.enter_context(wrapped(
                    ops, name, keep_first_call(kept_inputs, name)))
            stack.enter_context(wrapped(transformer, "_rglru_prefill_block",
                                        keep_trunk_output(kept_inputs)))
        ops.reset_counts()
        reqs, stats = serve.serve_batch(cfg, params, reqs,
                                        max_seq=max(map(len, prompts))
                                        + MAX_NEW)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    return kept[0], [r.out for r in reqs], stats, counts


def phase_lm_small() -> None:
    """The smoke config (f32, window 16, prompts longer than the window)
    served on the card through the kernels and on the CPU through the
    plain versions, with the same weights: the CPU path is the one the
    tests hold to the JAX package at 1e-4."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.runtime import steps

    print("== lm_serve: smoke config, card vs CPU")
    cfg = configs.get_smoke_config(LM_ARCH)
    cpu = transformer.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 29, 17)]
    (_, logits_card), toks_card, _, counts = serve_run(
        cfg, _to_device(cpu, DEVICE), prompts)
    kept = []
    with wrapped(steps, "make_prefill_step", keep_prefill(kept)):
        reqs, _ = serve.serve_batch(
            cfg, cpu, [serve.Request(rid=i, prompt=p, max_new=MAX_NEW)
                       for i, p in enumerate(prompts)],
            max_seq=max(map(len, prompts)) + MAX_NEW)
    diff = float((logits_card.cpu() - kept[0][1]).abs().max())
    check(diff <= 1e-4, f"smoke prefill logits, card kernels vs CPU plain: "
          f"max abs diff {diff:.3e} <= 1e-4")
    check(toks_card == [r.out for r in reqs],
          f"smoke greedy tokens equal on the card and the CPU "
          f"({len(prompts)} x {MAX_NEW})")
    check(counts["flash_attention"] == 1 and counts["rglru_scan"] == 4,
          f"smoke prefill ran 1 flash_attention and 4 rglru_scan: {counts}")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def prefill_trunk(cfg, params, batch, mode="auto"):
    """One prefill of ``batch``: its last-position logits and the
    trunk's output before the final norm."""
    from repro_torch.models import transformer
    from repro_torch.runtime import steps

    kept: dict = {}
    with wrapped(transformer, "_rglru_prefill_block",
                 keep_trunk_output(kept)):
        logits, _ = steps.make_prefill_step(
            cfg, max_seq=max(PROMPT_LENS) + MAX_NEW, mode=mode)(params,
                                                                batch)
    torch.cuda.synchronize()
    return logits, kept["h"]


def trunk_diff(label, t, ref):
    """Print and return (Frobenius ratio, worst position's norm ratio) of
    ``t - ref``; ``t`` and ``ref`` are trunk outputs less the embedding,
    (B, S, D)."""
    diff = t - ref
    frob = float(diff.norm() / ref.norm())
    rows = float((diff.norm(dim=-1) / ref.norm(dim=-1)).max())
    print(f"  {label}: trunk less the embedding, max abs diff / max abs "
          f"{float(diff.abs().max() / ref.abs().max()):.3e} (max abs "
          f"{float(ref.abs().max()):.4g}), worst position's norm ratio "
          f"{rows:.3e}, Frobenius ratio {frob:.3e}")
    return frob, rows


def phase_lm_serve():
    """RecurrentGemma-9B at full width in bf16: runs (a) to (e).
    Returns (a)'s launch counts, the weights, the prefill batch, the
    first inputs of each kernel op in (a) and the largest max abs error
    of each op over every layer of (d).

    With random weights the scaled embedding dominates the residual
    stream and so the logits, so (c) is also held to (a) in the trunk's
    own contribution: the final residual stream less the embedding.
    bf16 rounding differences grow through 38 random layers, so that
    gate is on norms (all positions, and the worst one), and (e) shows
    that it trips on a fault in one deep layer.  The tight check of the
    kernels is (d), a kernel-route prefill whose every kernel call is
    held against the plain version on that call's inputs."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    cfg = configs.get_config(LM_ARCH)
    print(f"== lm_serve: {LM_ARCH} full width ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, bf16), prompts {PROMPT_LENS} left-padded"
          f" to {max(PROMPT_LENS)}, {MAX_NEW} greedy tokens each")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, 0, device=DEVICE)
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in _leaves(params))
    print(f"  weights drawn on the card in {time.perf_counter() - t0:.1f} s:"
          f" {n / 1e9:.3f} B parameters ({n * 2 / 1e9:.2f} GB bf16; "
          f"param_count() {cfg.param_count() / 1e9:.3f} B)")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, k).astype(np.int32)
               for k in PROMPT_LENS]

    runs = {}
    inputs: dict = {}
    for tag in ("a", "b"):
        (batch, logits), toks, stats, counts = serve_run(
            cfg, params, prompts, inputs if tag == "a" else None)
        runs[tag] = (logits, toks, counts)
        print(f"  ({tag}) prefill {stats['prefill_s']:.4f} s, decode "
              f"{stats['decode_s'] / MAX_NEW * 1e3:.3f} ms/step, "
              f"{stats['tokens_per_s']:.1f} tokens/s; launches {counts}")
        check(tuple(logits.shape) == (len(prompts), cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"({tag}) prefill logits finite, shape {tuple(logits.shape)}")
        check(all(len(t) == MAX_NEW and all(0 <= x < cfg.vocab_size
                                            for x in t) for t in toks),
              f"({tag}) {MAX_NEW} tokens in the vocabulary per request")
        check(counts["flash_attention"] == 12 and counts["rglru_scan"] == 26
              and counts["gram"] == counts["schwarz_fwd"]
              == counts["schwarz_bwd"] == 0,
              f"({tag}) the prefill ran 12 flash_attention and 26 "
              f"rglru_scan launches, decode none")
    la, ta, ca = runs["a"]
    lb, tb, _ = runs["b"]
    check(torch.equal(la, lb) and ta == tb,
          "(a) and (b) prefill logits and generated tokens bitwise equal")
    print(f"  max memory allocated, weights and runs (a), (b): "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    lc, hc = prefill_trunk(cfg, params, batch, mode="plain")
    cc = ops.launch_counts()
    check(all(v == 0 for v in cc.values()), f"(c) ran no kernel: {cc}")
    print(f"  max memory allocated, weights and run (c): "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    rel = float((la.float() - lc.float()).abs().max()
                / lc.float().abs().max())
    agree = float((la.argmax(-1) == lc.argmax(-1)).float().mean())
    print(f"  (c) plain prefill: last-position logits max abs diff / max "
          f"abs {rel:.3e}; first tokens agree for {agree:.2f} of the "
          f"requests")
    check(rel <= 2e-2, f"(a) vs (c) relative logits difference {rel:.3e} "
          f"<= 2e-2")
    emb = transformer._embed_tokens(cfg, params, batch["tokens"]).float()
    tc = hc.float() - emb
    frob, rows = trunk_diff("(a) vs (c)", inputs.pop("h").float() - emb, tc)
    check(frob <= 2e-2, f"(a) vs (c) trunk difference, Frobenius over "
          f"Frobenius, {frob:.3e} <= 2e-2")
    check(rows <= TRUNK_ROW_TOL, f"(a) vs (c) trunk difference at the "
          f"worst position, norm over norm, {rows:.3e} <= {TRUNK_ROW_TOL:g}")

    # (e) The trunk gate catches a fault in one deep layer that the
    # logits gate misses: the last attention layer's output loses its
    # last 64 rows.
    def zero_tail(fn):
        calls = []

        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append(1)
            if len(calls) == ca["flash_attention"]:
                out = out.clone()
                out[:, -64:] = 0
            return out
        return run

    with wrapped(ops, "flash_attention", zero_tail):
        le, he = prefill_trunk(cfg, params, batch)
    rel_e = float((le.float() - lc.float()).abs().max()
                  / lc.float().abs().max())
    _, rows_e = trunk_diff("(e) faulted vs (c)", he.float() - emb, tc)
    check(rows_e > TRUNK_ROW_TOL, f"(e) a fault in the last attention "
          f"layer trips the trunk gate ({rows_e:.3e} > {TRUNK_ROW_TOL:g}; "
          f"logits rel {rel_e:.3e})")
    del emb, tc, hc, he

    errs: dict = {}
    with contextlib.ExitStack() as stack:
        for name in ("flash_attention", "rglru_scan"):
            stack.enter_context(wrapped(ops, name,
                                        compare_calls(errs, name)))
        prefill_trunk(cfg, params, batch)
    worst = {}
    for name, calls in errs.items():
        tol = LM_TOL[calls[0][2]]
        rel = max(r for _, r, _ in calls)
        worst[name] = max(e for e, _, _ in calls)
        check(rel <= tol, f"(d) {name} against its plain version on the "
              f"inputs of each of its {len(calls)} layers: worst rel "
              f"{rel:.3e} <= {tol:g}")
    return ca, params, cfg, batch, inputs, worst


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def phase_lm_profile(cfg, params, batch) -> None:
    """``torch.profiler`` over one full-width prefill and one decode step
    after it: the device's busy share and the operations with the most
    device time.  The decode step is also timed without the profiler."""
    from repro_torch.runtime import steps
    from torch.profiler import ProfilerActivity, profile

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        return out, prof, (t1 - t0) * 1e3

    print("== profile: one recurrentgemma-9b prefill (4 x 4096 tokens)")
    step = steps.make_prefill_step(cfg, max_seq=max(PROMPT_LENS) + MAX_NEW)
    (logits, cache), prof, wall_ms = profiled(lambda: step(params, batch))
    device_report(prof, wall_ms, 15)

    print("== profile: one decode step (4 tokens) after that prefill")
    serve = steps.make_serve_step(cfg)
    cur = logits.argmax(-1)[:, None]
    pos = batch["tokens"].shape[1]
    serve(params, cache, cur, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        serve(params, cache, cur, pos)
    torch.cuda.synchronize()
    print(f"  decode step without the profiler: "
          f"{(time.perf_counter() - t0) / 3 * 1e3:.3f} ms")
    _, prof, wall_ms = profiled(lambda: serve(params, cache, cur, pos))
    device_report(prof, wall_ms, 8)


def visible_scores(s: int, causal: bool, window: int) -> int:
    """Score entries a (BH = 1) attention leaves unmasked."""
    q = np.arange(s)
    lo = np.zeros(s, np.int64) if window <= 0 else np.maximum(q - window + 1,
                                                              0)
    hi = q + 1 if causal else np.full(s, s)
    return int((hi - lo).sum())


def lm_bound(name, args, kwargs):
    """(bound_ms, bound_by): bytes (inputs read once, output written
    once) over the HBM rate against flops over the dtype's peak; the
    attention's flops count the visible score entries only."""
    t = args[0]
    it = t.element_size()
    if name == "flash_attention":
        bh, s, d = t.shape
        flops = 4 * d * bh * visible_scores(s, kwargs["causal"],
                                            kwargs["window"])
        nbytes = 4 * t.numel() * it
    else:
        flops = 2 * t.numel()
        nbytes = 3 * t.numel() * it
    t_ops = flops / PEAK_FLOPS[t.dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def lm_kernel(name):
    from repro_torch.kernels import flash_attention, rglru_scan
    return {"flash_attention": flash_attention.flash_attention,
            "rglru_scan": rglru_scan.rglru_scan}[name]


def lm_plain(name):
    from repro_torch.kernels import ref
    return {"flash_attention": ref.attention_plain,
            "rglru_scan": ref.rglru_scan_plain}[name]


def lm_compare(name, args, kwargs, label):
    out_k = lm_kernel(name)(*args, **kwargs)
    out_p = lm_plain(name)(*args, **kwargs)
    torch.cuda.synchronize()
    err = float((out_k.float() - out_p.float()).abs().max())
    scale = float(out_p.float().abs().max()) or 1.0
    tol = LM_TOL[args[0].dtype]
    check(out_k.shape == out_p.shape and out_k.dtype == out_p.dtype
          and bool(torch.isfinite(out_k).all()) and err / scale <= tol,
          f"{name} {label} {str(args[0].dtype)[6:]}: max abs err "
          f"{err:.3e}, rel {err / scale:.3e} <= {tol:g}")
    return err


def sdpa_call(q, k, v, causal: bool, window: int, heads: int):
    """One ``scaled_dot_product_attention`` on the same (BH, S, D) inputs
    with the same causal-window boolean mask (timed as the library
    yardstick; the port never calls it)."""
    bh, s, d = q.shape
    pos = torch.arange(s, device=q.device)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    shape = (bh // heads, heads, s, d)
    qs, ks, vs = (t.view(shape) for t in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask)


def phase_lm_kernels(inputs: dict, layer_errs: dict, counts: dict,
                     heads: int) -> list:
    """Kernel vs plain at the prefill's own shapes: the first call of
    each op in run (a), random values at the same shapes (the JSON
    max_abs_err is the largest of these and of every layer of run (d),
    ``layer_errs``), two launches bitwise equal; then ragged shapes;
    then the timings of the main shape."""
    print("== kernels: LM")
    gen = torch.Generator(device=DEVICE).manual_seed(1)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

    rows = []
    for name in ("flash_attention", "rglru_scan"):
        args, kwargs = inputs[name]
        kwargs = {k: v for k, v in kwargs.items() if k != "mode"}
        shape, dtype = tuple(args[0].shape), args[0].dtype
        err = max(layer_errs[name],
                  lm_compare(name, args, kwargs, f"prefill input {shape}"))
        if name == "flash_attention":
            rand = tuple(randn(*shape, dtype=dtype) for _ in range(3))
        else:
            rand = (torch.rand(*shape, generator=gen, device=DEVICE)
                    .mul(0.3).add(0.7).to(dtype),
                    randn(*shape, dtype=dtype).mul(0.1))
        err = max(err, lm_compare(name, rand, kwargs, f"random {shape}"))
        k1 = lm_kernel(name)(*args, **kwargs)
        check(torch.equal(k1, lm_kernel(name)(*args, **kwargs)),
              f"{name}: two launches bitwise equal")
        bound, by = lm_bound(name, args, kwargs)
        row = {
            "name": name, "ok": True, "route": "cuda",
            "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": counts[name], "max_abs_err": err,
            "ms": time_ms(lambda: lm_kernel(name)(*args, **kwargs), 20),
            "plain_ms": time_ms(lambda: lm_plain(name)(*args, **kwargs), 2),
            "bound_ms": bound, "bound_by": by,
            "library_ms": (time_ms(sdpa_call(*args, heads=heads, **kwargs),
                                   10)
                           if name == "flash_attention" else None),
            "shape": list(shape), "dtype": str(dtype)[6:],
        }
        lib = row["library_ms"]
        print(f"  {name} {shape}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bound:.4f} ms ({by})")
        rows.append(row)

    for dtype in (torch.float32, torch.bfloat16):
        for s in (1000, 160):
            for d in (64, 128, 256):
                for causal, window in ((True, 0), (True, 64), (False, 0)):
                    qkv = tuple(randn(3, s, d, dtype=dtype)
                                for _ in range(3))
                    lm_compare("flash_attention", qkv,
                               {"causal": causal, "window": window},
                               f"ragged (3, {s}, {d}) causal={causal} "
                               f"window={window}")
        for shape in ((3, 77, 100), (2, 1, 33), (1, 33, 1)):
            ab = (torch.rand(*shape, generator=gen, device=DEVICE)
                  .mul(0.3).add(0.7).to(dtype),
                  randn(*shape, dtype=dtype).mul(0.1))
            lm_compare("rglru_scan", ab, {}, f"ragged {shape}")
    return rows


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

    phase_lm_small()
    counts_lm, params, cfg, batch, inputs, layer_errs = phase_lm_serve()
    phase_lm_profile(cfg, params, batch)
    rows += phase_lm_kernels(inputs, layer_errs, counts_lm, cfg.num_heads)
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
