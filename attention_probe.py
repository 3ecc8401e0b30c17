"""Probe of the bf16 flash_attention kernels on the card.

  python3 attention_probe.py check [--root DIR]
  python3 attention_probe.py time [--root DIR] [--tag NAME] [--only NAME]
  python3 attention_probe.py hashes [--root DIR] [--tag NAME]

`check` builds the kernels, prints their -Xptxas -v lines and holds the
forward and backward at ragged S, GQA, windows, non-causal and D 48 to
256 against the plain version (chip_smoke.py's gates), two launches
bitwise equal.  `time` times the forward at Yi-6B's and OLMoE-1B-7B's
prefill shapes, OLMoE's training shape, RecurrentGemma's prefill shape
and a non-causal Yi shape beside SDPA, and the backward at OLMoE's and
RecurrentGemma's training shapes beside SDPA's backward, with each
launch's device time and the host time of a call; one JSON line a row.
`hashes` prints the sha256 of the forward's out and lse and of the
backward's dQ, dK and dV, f32 and bf16, at D 64, 96, 128 and 256 on
seeded inputs with S_kv = S (the shapes of PERF.md rows 4, 7 and 10
among them), one JSON line a case: two commits whose lines are equal
compute those outputs bitwise alike.  --root names another checkout
(an unpacked `git archive` of another commit) whose chip_smoke.py and
src/ are imported instead, so that two commits are compared in one run:
parent, change, change, parent.  Needs a CUDA device; results also go
to chiprun_out/ beside this script."""
import argparse
import json
import os
import sys
import time
import traceback

ap = argparse.ArgumentParser()
ap.add_argument("role")
ap.add_argument("--root", default=".")
ap.add_argument("--tag", default="change")
ap.add_argument("--only", default="")
a = ap.parse_args()
root = os.path.abspath(a.root)
sys.path[:0] = [root, os.path.join(root, "src")]
os.chdir(root)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, flash_attention as fa  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "chiprun_out")
os.makedirs(OUT, exist_ok=True)
t0 = time.time()
_build.load()
print(f"[{a.tag}] build {time.time() - t0:.1f} s", flush=True)
dev = "cuda"
gen = torch.Generator(device=dev).manual_seed(5)
fails = []


def rnd(*shape):
    return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)


def guard(label, fn):
    try:
        return fn()
    except Exception as exc:   # noqa: BLE001
        fails.append(f"{label}: {type(exc).__name__}: {exc}"[:600])
        print(f"  FAIL {label}: {exc}"[:600], flush=True)
        traceback.print_exc(limit=2)
        torch.cuda.synchronize()
        return None


if a.role == "check":
    with open(f"{OUT}/build_{a.tag}.log", "w") as f:
        f.write("\n".join(_build.BUILD_LOG))
    for line in cs.ptxas_report(
            r"((?:flash_bf16_[a-z_]+|fa_bwd_[a-z]+)_kernel(?:ILi\d+E)?)"):
        print("  ptxas:", line)
    FWD = [(128, 8, 8, 1000, True, 0), (128, 8, 8, 4095, True, 0),
           (128, 16, 2, 1000, True, 0), (128, 32, 2, 4095, True, 0),
           (128, 2, 1, 8192, True, 512), (128, 2, 1, 8192, True, 4096),
           (128, 4, 4, 1000, False, 0), (128, 4, 1, 4095, False, 0),
           (128, 4, 2, 300, False, 64), (128, 3, 1, 77, True, 0),
           (128, 3, 3, 1, True, 0), (128, 2, 2, 129, True, 0),
           (128, 64, 64, 2048, True, 0), (96, 4, 2, 500, True, 0),
           (64, 4, 4, 1000, True, 0), (64, 8, 2, 300, True, 64),
           (64, 4, 4, 77, False, 0), (64, 2, 1, 4095, True, 0),
           (256, 4, 1, 1000, True, 0), (256, 3, 1, 4096, True, 2048)]
    for d, bh, bkv, s, causal, window in FWD:
        label = f"fwd D{d} ({bh},{bkv},{s}) causal={causal} window={window}"

        def one():
            qkv = (rnd(bh, s, d), rnd(bkv, s, d), rnd(bkv, s, d))
            kw = {"causal": causal, "window": window}
            cs.lm_compare("flash_attention", qkv, kw, label)
            o1, l1 = fa.flash_attention(*qkv, lse=True, **kw)
            o2, l2 = fa.flash_attention(*qkv, lse=True, **kw)
            cs.check(torch.equal(o1, o2) and torch.equal(l1, l2),
                     f"{label}: two launches bitwise equal")
        guard(label, one)
    BWD = [(128, 64, 64, 2048, True, 0), (128, 8, 2, 1000, True, 0),
           (128, 16, 1, 4095, True, 0), (128, 4, 4, 1000, False, 0),
           (128, 6, 3, 300, True, 512), (128, 4, 1, 160, True, 64),
           (128, 2, 1, 8192, True, 4096), (128, 2, 2, 8192, True, 512),
           (128, 3, 3, 77, True, 0),
           (64, 4, 4, 77, False, 0), (64, 8, 2, 300, True, 64),
           (48, 6, 2, 200, True, 64), (256, 8, 2, 1000, True, 0)]
    for d, bh, bkv, s, causal, window in BWD:
        label = f"bwd D{d} ({bh},{bkv},{s}) causal={causal} window={window}"

        def one():
            qkv = (rnd(bh, s, d), rnd(bkv, s, d), rnd(bkv, s, d))
            kw = {"causal": causal, "window": window}
            _, _, kernel, _, _, _ = cs.bwd_compare(
                "flash_attention", qkv, kw, gen, label, True)
            g1, g2 = kernel(), kernel()
            cs.check(all(torch.equal(x, y) for x, y in zip(g1, g2)),
                     f"{label}: two launches bitwise equal")
        guard(label, one)
        torch.cuda.empty_cache()
    print(json.dumps({"tag": a.tag, "fails": fails}))
    sys.exit(1 if fails else 0)

if a.role == "hashes":
    import hashlib

    # (dtype, D, BH, BH_kv, S, causal, window): Yi-6B's prefill and
    # OLMoE-1B-7B's training (bf16, D 128), RecurrentGemma-9B's prefill and
    # training (bf16, D 256; f32 at the f32 training shape), D 64 ragged,
    # GQA, windowed and non-causal, and D 96.
    HASH_CASES = [("bf16", 128, 128, 16, 4096, True, 0),
                  ("bf16", 128, 64, 64, 2048, True, 0),
                  ("bf16", 256, 64, 4, 4096, True, 2048),
                  ("bf16", 256, 32, 2, 4096, True, 2048),
                  ("bf16", 64, 16, 4, 1000, True, 64),
                  ("bf16", 64, 8, 8, 777, False, 0),
                  ("bf16", 96, 8, 8, 1000, True, 0),
                  ("f32", 256, 32, 2, 4096, True, 2048),
                  ("f32", 64, 8, 2, 1000, True, 64),
                  ("f32", 96, 8, 8, 1000, True, 0),
                  ("f32", 128, 6, 3, 300, False, 0)]

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                              .numpy().tobytes()).hexdigest()[:16]

    for i, (dt, d, bh, bkv, s, causal, window) in enumerate(HASH_CASES):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        g = torch.Generator(device=dev).manual_seed(100 + i)
        q, k, v, dout = (torch.randn(r, s, d, generator=g, device=dev)
                         .to(dtype) for r in (bh, bkv, bkv, bh))
        kw = {"causal": causal, "window": window}
        o, lse = fa.flash_attention(q, k, v, lse=True, **kw)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, dout, **kw)
        print(json.dumps({"tag": a.tag, "case": [dt, d, bh, bkv, s, causal,
                                                 window],
                          "out": digest(o), "lse": digest(lse),
                          "dq": digest(grads[0]), "dk": digest(grads[1]),
                          "dv": digest(grads[2])}), flush=True)
        del q, k, v, dout, o, lse, grads
        torch.cuda.empty_cache()
    sys.exit(0)

# role time
rows = []
FWD_T = [("yi_prefill", 128, 16, 4096, 128, True, 0, 32),
         ("olmoe_prefill", 64, 64, 4096, 128, True, 0, 16),
         ("olmoe_train", 64, 64, 2048, 128, True, 0, 16),
         ("rg_prefill", 64, 4, 4096, 256, True, 2048, 16),
         ("yi_noncausal", 128, 16, 4096, 128, False, 0, 32)]
for name, bh, bkv, s, d, causal, window, heads in FWD_T:
    if a.only and a.only not in name:
        continue
    qkv = (rnd(bh, s, d), rnd(bkv, s, d), rnd(bkv, s, d))
    kw = {"causal": causal, "window": window}
    kern = lambda: fa.flash_attention(*qkv, **kw)  # noqa: E731
    ms = cs.time_ms(kern, 20)
    ms2 = cs.time_ms(kern, 20)
    med = cs.median_ms(kern, 7)
    bound, _ = cs.lm_bound("flash_attention", qkv, kw)
    masked, causal_only = cs.sdpa_calls(*qkv, heads=heads, **kw)
    sd = cs.time_ms(causal_only if causal else masked, 10)
    torch.cuda.synchronize()
    th = time.perf_counter()
    for _ in range(20):
        kern()
    host_us = (time.perf_counter() - th) / 20 * 1e6
    torch.cuda.synchronize()
    row = {"tag": a.tag, "what": f"fwd {name}", "ms": ms, "ms2": ms2,
           "med": med, "bound": bound, "share": bound / min(ms, ms2),
           "sdpa_causal": sd, "host_us": host_us}
    print(json.dumps(row), flush=True)
    rows.append(row)
    del qkv, masked, causal_only
    torch.cuda.empty_cache()
BWD_T = [("olmoe_train", 64, 64, 2048, 128, True, 0, 16),
         ("rg_train", 32, 2, 4096, 256, True, 2048, 16)]
for name, bh, bkv, s, d, causal, window, heads in BWD_T:
    if a.only and a.only not in name:
        continue
    qkv = (rnd(bh, s, d), rnd(bkv, s, d), rnd(bkv, s, d))
    kw = {"causal": causal, "window": window}
    o, lse = fa.flash_attention(*qkv, lse=True, **kw)
    dout = rnd(bh, s, d)
    kern = lambda: fa.flash_attention_bwd(*qkv, o, lse, dout, **kw)  # noqa
    ms = cs.median_ms(kern, 7)
    b2b = cs.time_ms(kern, 10)
    torch.cuda.synchronize()
    th = time.perf_counter()
    for _ in range(20):
        kern()
    host_us = (time.perf_counter() - th) / 20 * 1e6
    torch.cuda.synchronize()
    bound, _ = cs.bwd_bound("flash_attention", qkv, kw)
    same = causal and window <= 0
    sd = cs.median_ms(cs.sdpa_backward(*qkv, dout, heads=heads,
                                       is_causal=same, **kw), 5)
    if name == "olmoe_train":
        # host time split: the C entry alone on ready arguments, the
        # wrapper's checks, plans and allocations alone
        import ctypes  # noqa: F401
        lib = _build.load()
        q, k, v = qkv
        ws = torch.empty(fa.bwd_plan(q.shape, k.shape, q.dtype)["ws_shape"],
                         dtype=torch.float32, device=q.device)
        g = [torch.empty_like(t) for t in (q, k, v)]
        cargs = [*(t.data_ptr() for t in (q, k, v, o, dout, lse, ws, *g)),
                 q.shape[0], k.shape[0], q.shape[1], k.shape[1], 128, 128,
                 1, 0, 0.0, torch.cuda.current_stream().cuda_stream]
        def host(fn, n=50):
            torch.cuda.synchronize()
            th = time.perf_counter()
            for _ in range(n):
                fn()
            out = (time.perf_counter() - th) / n * 1e6
            torch.cuda.synchronize()
            return out
        c_us = host(lambda: lib.repro_flash_attention_bwd_bf16(*cargs))
        def py_only():
            _build.check_inputs("x", {"q": q, "k": k, "v": v, "o": o,
                                      "do": dout}, dtypes=_build.LM_DTYPES)
            fa.launch_plan(q.shape, k.shape, v.shape, q.dtype)
            _build.check_shape("x", "o", o, q.shape)
            _build.check_shape("x", "do", dout, q.shape)
            _build.check_inputs("x", {"lse": lse}, dtypes=(torch.float32,))
            _build.check_shape("x", "lse", lse, (q.shape[0], q.shape[1]))
            _build.check_aligned("x", {"q": q, "k": k, "v": v, "o": o,
                                       "do": dout})
            plan = fa.bwd_plan(q.shape, k.shape, q.dtype)
            tmp = [torch.empty_like(t) for t in (q, k, v)]
            torch.empty(plan["ws_shape"], dtype=torch.float32,
                        device=q.device)
            torch.cuda.current_stream(q.device).cuda_stream
        py_us = host(py_only)
        fwd_c = lib.repro_flash_attention_bf16
        lse_buf = torch.empty(q.shape[0] * q.shape[1] + 4,
                              dtype=torch.float32, device=q.device)
        oo = torch.empty_like(q)
        fargs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), oo.data_ptr(),
                 lse_buf.data_ptr(), lse_buf.data_ptr() + 4 * q.shape[0] * q.shape[1],
                 q.shape[0], k.shape[0], q.shape[1], k.shape[1], 128, 128,
                 1, 0, 0.0, torch.cuda.current_stream().cuda_stream]
        fc_us = host(lambda: fwd_c(*fargs))
        print(json.dumps({"tag": a.tag, "host_split_us": {
            "bwd_c_entry": c_us, "bwd_python": py_us, "fwd_c_entry": fc_us}}), flush=True)
    parts = guard("launch_times", lambda: cs.launch_times(
        kern, cs.BWD_KERNELS["flash_attention"]))
    row = {"tag": a.tag, "what": f"bwd {name}", "ms": ms, "b2b": b2b,
           "bound": bound, "share": bound / ms, "sdpa": sd, "host_us": host_us,
           "parts": parts}
    print(json.dumps(row), flush=True)
    rows.append(row)
    del qkv, o, lse, dout
    torch.cuda.empty_cache()
with open(f"{OUT}/time_{a.tag}_{int(time.time())}.json", "w") as f:
    json.dump(rows, f)
