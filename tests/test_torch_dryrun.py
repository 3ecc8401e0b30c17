"""The dry run (``repro_torch.launch.dryrun``) and the kernels' ``meta``
routes, on the CPU, with no rank launched.

* The CLI's single-pod sweep of all ten archs' smoke configs at the 40
  cells' shapes on the 16 x 16 production mesh: 34 ``ok``, 6
  ``skipped`` (``cell_supported``), none ``fail``, each row with the
  reference's row keys (``trace_s`` for its ``compile_s``), into the
  ``--out`` path and never into the reference's report files.
* One cell at full width traced end to end.
* Each kernel op's ``meta`` route gives its plain version's output (and,
  through autograd, gradient) shapes and dtypes, records its
  ``kernels/cost.py`` work and counts no launch (a soft-capped attention
  call records the uncapped call's work); CPU tensors still take the
  plain versions and record nothing.
* ``kernels/cost.py``'s bounds at ``PERF.md`` §6's shapes.
* The pieces the trace rests on: ``sharding.gather`` places the parts as
  the per-rank loop it replaced did; a traced prefill gathers the rank's
  tensor-parallel share once, as a real step does; MemTracker's peak
  holds the step's inputs and the share at once, its kinds adding up to
  it, and ``fits`` reads it against the 80 GB card whatever the host.
* RecurrentGemma-9B's ``train_4k`` at full width fits a rank's 80 GB
  with tensor-parallel compute.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.kernels import cost, ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import sharding  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from repro_torch.runtime.mesh import TracedMesh, group_ranks_of  # noqa: E402
from repro_torch.runtime.sharding import AbstractMesh, NamedSharding, P  # noqa: E402,E501

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in dryrun.arch_ids() for s in shapes.SHAPES]


def _reference_row_keys() -> set:
    roof = jhlo.Roofline(flops=1.0, hbm_bytes=1.0, coll_bytes_per_device=1.0,
                         chips=1, compute_s=1.0, memory_s=1.0,
                         collective_s=1.0, model_flops=1.0, counts={})
    # repro.launch.dryrun.run_cell's row
    return {"status", "arch", "shape", "chips", "compile_s", "memory",
            *roof.to_dict()}


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The CLI's single-pod sweep of the smoke configs, into a path under
    tmp; the repo's results/ before and after."""
    results = ROOT / "results"
    listing = lambda: (sorted(p.name for p in results.iterdir())  # noqa: E731
                       if results.exists() else [])
    before = listing()
    out = tmp_path_factory.mktemp("dryrun") / "report.json"
    dryrun.main(["--smoke", "--out", str(out)])
    return json.loads(out.read_text()), before, listing()


def test_sweep_counts_and_keys(sweep):
    rows, _, _ = sweep
    assert len(rows) == 40
    status = [r["status"] for r in rows.values()]
    assert (status.count("ok"), status.count("skipped"),
            status.count("fail")) == (34, 6, 0)
    want = (_reference_row_keys() - {"compile_s"}) | {"trace_s"}
    for r in rows.values():
        if r["status"] == "ok":
            assert want <= set(r), want - set(r)
            assert {"peak_per_device", "fits"} <= set(r["memory"])


def test_cli_writes_no_reference_report(sweep):
    _, before, after = sweep
    assert before == after
    for name in ("dryrun_singlepod.json", "dryrun_multipod.json"):
        assert not (ROOT / "results" / name).exists()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_sweep_cell(sweep, arch, shape):
    rows, _, _ = sweep
    row = rows[f"{arch}|{shape}"]
    ok, _ = shapes.cell_supported(configs.get_smoke_config(arch), shape)
    if not ok:
        assert row["status"] == "skipped" and row["reason"]
        return
    assert row["status"] == "ok" and row["chips"] == 256
    assert row["memory"]["peak_per_device"] > 0 and row["memory"]["fits"]
    assert 0 < row["useful_flops_frac"] <= 1
    # every step gathers the whole params from the rank's blocks
    assert row["counts"]["all-gather"] >= 1
    assert row["coll_bytes_per_device"] > 0
    case = shapes.SHAPES[shape]
    if case.kind == "decode":
        assert not row["kernels"]       # decode runs no kernel
    else:
        assert row["kernels"]
        if case.kind == "train":
            assert any(k.endswith("_bwd") for k in row["kernels"])


def test_full_width_cell_traces():
    row = dryrun.run_cell("gemma3-1b", "prefill_32k",
                          lmesh.make_production_mesh(), False, verbose=False)
    cfg = configs.get_config("gemma3-1b")
    assert row["status"] == "ok" and row["memory"]["fits"]
    # one flash_attention call a layer, nothing else a kernel
    assert row["kernels"]["flash_attention"]["calls"] == cfg.num_layers
    assert set(row["kernels"]) == {"flash_attention"}
    assert row["model_flops"] == pytest.approx(
        jhlo.model_flops_train(cfg, 32768, 32) / 3.0)
    assert row["flops"] > row["model_flops"]


def test_traced_step_gathers_params_once():
    """A traced prefill gathers each leaf that an FSDP axis splits once
    into the rank's tensor-parallel share (and keeps it); its second call
    gathers no parameter, only what the first gathered besides (the
    logits)."""
    cfg = configs.get_smoke_config("yi-6b")
    mesh = TracedMesh(AbstractMesh((2, 2), ("data", "model")), rank=3)
    batch = shapes.input_specs(cfg, shapes.ShapeCase("p", 16, 4, "prefill"))
    step = steps.make_prefill_step(cfg, mesh, max_seq=16, batch_shapes=batch)
    plans = adamw.leaves(transformer.gather_plan(cfg, mesh, per_layer=False))
    params = dryrun._blocks(transformer.param_shapes(cfg), mesh,
                            transformer.param_specs, cfg)
    split = sum(1 for p in plans if p is not None)
    calls = []
    for _ in range(2):
        before = dict(mesh.counts)
        step(params, batch)
        calls.append(mesh.counts["all_gather"] - before["all_gather"])
    assert split and calls[1] >= 1 and calls == [split + calls[1], calls[1]]


def test_single_process_cell_has_no_collectives():
    cfg = configs.get_smoke_config("mamba2-1.3b")
    acc = dryrun.lower_cell(cfg, shapes.ShapeCase("t", 32, 4, "train"), None)
    assert acc["chips"] == 1 and acc["collectives"] == {}
    assert set(acc["kernels"]) == {"ssd_scan", "ssd_scan_bwd"}
    assert acc["flops"] > 0 and acc["op_bytes"] > 0


def _nbytes(tree) -> int:
    return sum(t.nbytes for t in dryrun._tensors(tree))


@pytest.mark.parametrize("arch,shape", [("yi-6b", "train_4k"),
                                        ("yi-6b", "decode_32k"),
                                        ("mamba2-1.3b", "prefill_32k")])
def test_peak_holds_inputs_and_whole_params(arch, shape):
    """MemTracker's peak holds the step's inputs (the rank's blocks and,
    by the step's kind, both f32 moments' blocks or the cache's) and, in
    serving, the rank's tensor-parallel share gathered from the blocks
    (the leaves an FSDP axis splits; no whole tree); its kinds add up to
    it."""
    cfg = configs.get_smoke_config(arch)
    mesh = TracedMesh(lmesh.make_production_mesh())
    full = transformer.param_shapes(cfg)
    blocks = dryrun._blocks(full, mesh, transformer.param_specs, cfg)
    held = _nbytes(blocks)
    case = shapes.SHAPES[shape]
    if case.kind == "train":
        held += 2 * _nbytes(dryrun._blocks(full, mesh, transformer.param_specs,
                                           cfg, dtype=torch.float32))
    else:
        plans = adamw.leaves(transformer.gather_plan(cfg, mesh,
                                                     per_layer=False))
        share = sum(p.forward(b).nbytes for b, p in zip(
            adamw.leaves(blocks), plans) if p is not None)
        assert 0 < share < _nbytes(full)
        held += share
    if case.kind == "decode":
        cache = shapes.decode_cache_specs(cfg, case)
        held += _nbytes(dryrun._blocks(cache, mesh, steps.cache_specs_tree,
                                       cfg, cache))
    mem = dryrun.lower_cell(cfg, shape, mesh, flops=False)["memory"]
    peak = mem.pop("peak_per_device")
    assert peak > held
    assert sum(mem.values()) == peak
    row = dryrun.run_cell(arch, shape, mesh, False, verbose=False,
                          analysis=False, smoke=True)
    assert row["memory"]["peak_per_device"] == peak
    assert row["memory"]["fits"] == (peak <= dryrun.CARD_BYTES)


def test_recurrentgemma_train_4k_fits_tensor_parallel():
    """RecurrentGemma-9B's train_4k on the production mesh, traced at
    full width: a rank fits one 80 GB card (91.03 GB when every rank held
    the whole tree) and computes its share (useful flops at least half of
    its flops; about 0.75 is ideal under remat "block")."""
    row = dryrun.run_cell("recurrentgemma-9b", "train_4k",
                          lmesh.make_production_mesh(), False, verbose=False)
    assert row["status"] == "ok" and row["memory"]["fits"]
    assert row["memory"]["peak_per_device"] <= dryrun.CARD_BYTES
    assert row["useful_flops_frac"] >= 0.5


# -- kernels' meta routes ------------------------------------------------------

def _rand(gen, *shape, dtype=torch.float32, lo=-1.0, hi=1.0):
    x = gen.uniform(lo, hi, size=shape)
    return torch.from_numpy(x).to(dtype)


def _kernel_cases():
    """(name, op, the CPU inputs, kwargs, differentiable input indices)."""
    gen = np.random.default_rng(31)
    f64 = torch.float64
    p, m, w = 3, 17, 5
    A = _rand(gen, p, m, w, dtype=f64)
    cases = [
        ("gram", ops.gram, (A, _rand(gen, p, m, dtype=f64, lo=0.5)), {}, ()),
        ("schwarz_fwd", ops.schwarz_fwd,
         (A, _rand(gen, p, w, dtype=f64), _rand(gen, p, w, dtype=f64)), {},
         ()),
        ("schwarz_bwd", ops.schwarz_bwd,
         (A, *(_rand(gen, m, dtype=f64) for _ in range(3)),
          _rand(gen, p, m, dtype=f64),
          *(_rand(gen, p, w, dtype=f64) for _ in range(3))), {}, ()),
    ]
    for dtype, (bh, bhkv, s, skv, d), kw in (
            (torch.bfloat16, (8, 2, 24, 24, 16), dict(causal=True, window=8)),
            (torch.float32, (4, 4, 12, 20, 8), dict(causal=False, window=0)),
            (torch.float32, (6, 3, 16, 16, 12), dict(causal=True, window=0))):
        qkv = (_rand(gen, bh, s, d, dtype=dtype),
               _rand(gen, bhkv, skv, d, dtype=dtype),
               _rand(gen, bhkv, skv, d, dtype=dtype))
        cases.append((f"flash_attention {dtype} {bh}x{s}x{d} kv {bhkv}x{skv}"
                      f" {kw}", ops.flash_attention, qkv, kw, (0, 1, 2)))
    for dtype in (torch.float32, torch.bfloat16):
        ab = (_rand(gen, 2, 70, 6, dtype=dtype, lo=0.0),
              _rand(gen, 2, 70, 6, dtype=dtype))
        cases.append((f"rglru_scan {dtype}", ops.rglru_scan, ab, {}, (0, 1)))
    bh, g, s, pp, n = 4, 2, 32, 8, 16
    ssd = (_rand(gen, bh, s, pp), _rand(gen, bh, s, lo=0.01, hi=0.1),
           _rand(gen, bh, lo=-1.0, hi=-0.1), _rand(gen, g, s, n),
           _rand(gen, g, s, n))
    cases.append(("ssd_scan", ops.ssd_scan, ssd, dict(chunk=8, state=True),
                  (0, 1, 2, 3, 4)))
    # a soft-capped attention call: the same work as the uncapped one
    qkv = (_rand(gen, 8, 24, 16, dtype=torch.bfloat16, lo=-3.0, hi=3.0),
           _rand(gen, 2, 24, 16, dtype=torch.bfloat16, lo=-3.0, hi=3.0),
           _rand(gen, 2, 24, 16, dtype=torch.bfloat16))
    cases.append(("flash_attention softcap 2.0", ops.flash_attention, qkv,
                  dict(causal=True, window=8, softcap=2.0), (0, 1, 2)))
    return cases


KERNEL_CASES = _kernel_cases()


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


def _sig(ts):
    return [(tuple(t.shape), t.dtype) for t in ts]


@pytest.mark.parametrize("i", range(len(KERNEL_CASES)),
                         ids=[c[0] for c in KERNEL_CASES])
def test_meta_route_shapes_and_cost(i):
    name, op, args, kw, diff = KERNEL_CASES[i]
    plain = _outs(op(*args, **kw, mode="plain"))
    meta_args = tuple(a.to("meta").requires_grad_(j in diff)
                      for j, a in enumerate(args))
    ops.reset_counts()
    rec = cost.Recorder()
    with cost.recording(rec):
        out = _outs(op(*meta_args, **kw))
        assert all(t.device.type == "meta" for t in out)
        assert _sig(out) == _sig(plain)
        if diff:
            # gradients through the meta backward against autograd through
            # the plain version on the CPU
            cpu_args = tuple(a.clone().requires_grad_(j in diff)
                             for j, a in enumerate(args))
            want = torch.autograd.grad(
                _outs(op(*cpu_args, **kw, mode="plain"))[0].float().sum(),
                [cpu_args[j] for j in diff])
            got = torch.autograd.grad(out[0].float().sum(),
                                      [meta_args[j] for j in diff])
            assert _sig(got) == _sig(want)
    assert not any(ops.launch_counts().values())
    kernel = name.split()[0]
    names = [n for n, _ in rec.calls]
    assert names == [kernel] + ([kernel + "_bwd"] if diff else [])
    work = rec.calls[0][1]
    if kernel == "flash_attention":
        q, k = args[0], args[1]
        assert work == cost.flash_attention(q.shape, k.shape, q.dtype, **kw)
        uncapped = {k: v for k, v in kw.items() if k != "softcap"}
        assert work == cost.flash_attention(q.shape, k.shape, q.dtype,
                                            **uncapped)
    elif kernel == "ssd_scan":
        assert work == cost.ssd_scan(args[0].shape, args[3].shape,
                                     kw["chunk"])
    elif kernel == "rglru_scan":
        assert work == cost.rglru_scan(args[0].shape, args[0].dtype)
    else:
        assert work == getattr(cost, kernel)(args[0].shape, args[0].dtype)


@pytest.mark.parametrize("i", [0, 3, 6, 8])
def test_cpu_tensors_take_the_plain_versions(i):
    name, op, args, kw, _ = KERNEL_CASES[i]
    rec = cost.Recorder()
    with cost.recording(rec):
        got = _outs(op(*args, **kw))
    want = _outs(op(*args, **kw, mode="plain"))
    assert not rec.calls
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_meta_route_keeps_the_kernels_checks():
    meta = lambda *s, dtype=torch.float32: torch.empty(  # noqa: E731
        s, dtype=dtype, device="meta")
    with pytest.raises(TypeError, match="dtype"):
        ops.ssd_scan(meta(4, 8, 8, dtype=torch.bfloat16),
                     meta(4, 8, dtype=torch.bfloat16),
                     meta(4, dtype=torch.bfloat16),
                     meta(2, 8, 16, dtype=torch.bfloat16),
                     meta(2, 8, 16, dtype=torch.bfloat16), chunk=8)
    with pytest.raises(ValueError, match="S_kv"):
        ops.flash_attention(meta(2, 8, 16), meta(2, 9, 16), meta(2, 9, 16),
                            causal=True)


# PERF.md §6's bounds (ms) and the shapes of its rows.
BOUNDS = [
    ("gram", lambda: cost.gram((8, 6094, 1553), torch.float64), 1.7561),
    ("schwarz_fwd",
     lambda: cost.schwarz_fwd((8, 6094, 1553), torch.float64), 0.1811),
    ("schwarz_bwd",
     lambda: cost.schwarz_bwd((8, 6094, 1553), torch.float64), 0.1811),
    ("flash_attention bf16", lambda: cost.flash_attention(
        (64, 4096, 256), (4, 4096, 256), torch.bfloat16, window=2048),
     0.4170),
    ("flash_attention f32", lambda: cost.flash_attention(
        (32, 4096, 256), (2, 4096, 256), torch.float32, window=2048),
     3.0775),
    ("ssd_scan", lambda: cost.ssd_scan((256, 4096, 64), (4, 4096, 128), 256),
     0.1690),
    ("rglru_scan prefill",
     lambda: cost.rglru_scan((4, 4096, 4096), torch.float32), 0.2404),
    ("rglru_scan training",
     lambda: cost.rglru_scan((2, 4096, 4096), torch.float32), 0.1202),
    ("flash_attention_bwd bf16", lambda: cost.flash_attention_bwd(
        (32, 4096, 256), (2, 4096, 256), torch.bfloat16, window=2048),
     0.5212),
    ("rglru_scan_bwd",
     lambda: cost.rglru_scan_bwd((2, 4096, 4096), torch.float32), 0.2003),
    ("ssd_scan_bwd",
     lambda: cost.ssd_scan_bwd((256, 2048, 64), (4, 2048, 128), 256),
     0.1739),
    ("flash_attention_bwd f32", lambda: cost.flash_attention_bwd(
        (32, 4096, 256), (2, 4096, 256), torch.float32, window=2048),
     7.6937),
]


@pytest.mark.parametrize("name,work,ms", BOUNDS, ids=[b[0] for b in BOUNDS])
def test_cost_bounds_match_perf_table(name, work, ms):
    bound, _ = work().bound()
    assert round(bound, 4) == pytest.approx(ms, abs=1e-12)


# -- sharding.gather -------------------------------------------------------------

class _PartsMesh:
    """A mesh rank whose all-gather returns each group rank's block of a
    known whole tensor, as raw bytes."""

    def __init__(self, sizes, names, whole, spec, rank):
        self.shape = dict(zip(names, sizes))
        self.axis_names = names
        self.coords = dict(zip(names, (int(c) for c in np.unravel_index(
            rank, sizes))))
        self.whole, self.spec = whole, spec

    def group_ranks(self, axes):
        return group_ranks_of(tuple(self.shape.values()), self.axis_names,
                              self.coords, axes)

    def all_gather(self, raw, axes):
        sh = NamedSharding(self, self.spec)
        return torch.cat([
            self.whole[sharding.block_slices(sh, self.whole.shape, r)]
            .contiguous()[None].view(torch.uint8)
            for r in self.group_ranks(axes)])


def _gather_by_parts(block, sh):
    """The per-rank placement ``sharding.gather`` did before."""
    mesh, axes = sh.mesh, sharding.spec_axes(sh.spec)
    shape = sharding.full_shape(block.shape, sh)
    parts = mesh.all_gather(block.contiguous()[None].view(torch.uint8),
                            axes).view(block.dtype)
    out = torch.empty(shape, dtype=block.dtype)
    for part, rank in zip(parts, mesh.group_ranks(axes)):
        out[sharding.block_slices(sh, shape, rank)] = part
    return out


GATHER_CASES = [
    ((2, 2), ("data", "model"), P("data")),
    ((2, 2), ("data", "model"), P(None, "model")),
    ((2, 2), ("data", "model"), P("model", "data")),
    ((2, 2), ("data", "model"), P(("model", "data"), None)),
    ((2, 3, 2), ("pod", "data", "model"), P(("data", "model"))),
    ((2, 3, 2), ("pod", "data", "model"), P(None, ("pod", "model"), "data")),
    ((2, 3, 2), ("pod", "data", "model"), P(("model", "pod"), None, "data")),
]


@pytest.mark.parametrize("sizes,names,spec", GATHER_CASES)
def test_gather_places_parts_as_the_rank_loop(sizes, names, spec):
    whole = torch.arange(12 * 12 * 6, dtype=torch.float64).reshape(12, 12, 6)
    for rank in range(int(np.prod(sizes))):
        mesh = _PartsMesh(sizes, names, whole, spec, rank)
        sh = NamedSharding(mesh, spec)
        block = sharding.local_block(whole, sh)
        got = sharding.gather(block, sh)
        assert torch.equal(got, _gather_by_parts(block, sh))
        assert torch.equal(got, whole)
