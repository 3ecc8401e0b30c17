"""Dry run: trace one rank's step of every (arch x shape) cell on the
production mesh, the counterpart of ``repro.launch.dryrun``.

For each cell this:
  1. builds ``meta`` inputs (no memory): this rank's blocks of the params
     (``param_shapes`` under ``param_specs``) and, for a training step,
     of both f32 AdamW moments (``opt_specs``), the global batch
     (``configs.shapes.input_specs``) and, for a decode step, this rank's
     blocks of the cache (``decode_cache_specs`` under
     ``cache_specs_tree``);
  2. builds the port's step as the reference's ``lower_cell`` does
     (``make_train_step(mesh=, batch_shapes=)``,
     ``make_prefill_step(mesh, max_seq=, batch_shapes=)``,
     ``make_serve_step(mesh, cache_shapes=)``) on a
     :class:`~repro_torch.runtime.mesh.TracedMesh`, rank 0 of the
     production mesh, and runs it once eagerly on those ``meta``
     tensors: every kernel op takes its ``meta`` route (outputs and
     workspaces allocated on ``meta``, its flops and bytes recorded from
     :mod:`repro_torch.kernels.cost`), every collective returns ``meta``
     and is recorded;
  3. reads the rank's peak of live bytes (``MemTracker``'s; its ``fits``
     against one H100's 80 GB is the fits-in-HBM proof), its
     flops (``torch.utils.flop_counter.FlopCounterMode`` for the plain
     PyTorch ops plus the kernels' recorded flops), the bytes its ops
     read and write (each tensor argument and result once; views and
     allocations none; plus the kernels' recorded bytes), its
     collectives, and the cell's model FLOPs, and appends the roofline
     row (:mod:`repro_torch.launch.hlo_analysis`) to
     ``results/dryrun_torch_<mesh>.json``.

The reference compiles XLA programs, whose cost analysis counts a loop
body once, so it extrapolates from unrolled lowerings at one and two
pattern periods (its ``_layer_counts`` and ``analyze_cell``).  The port
runs eagerly: a trace sees every layer, remat's recomputation and every
collective call, so each cell is counted at its full depth and nothing
is extrapolated.  Nothing here runs on the CPU or on the card, and no
card is read: every tensor is ``meta``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--multi-pod] \\
      [--arch yi-6b] [--shape train_4k] [--skip-done] [--no-analysis] \\
      [--smoke] [--out PATH]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs import shapes as shapes_mod
from repro_torch.kernels import cost
from repro_torch.launch import hlo_analysis, mesh as mesh_mod
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.runtime import sharding, steps as steps_mod
from repro_torch.runtime.mesh import TracedMesh

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results")
# One H100's memory, the card every rank is taken to have (the H100 SXM5
# data sheet's 80 GB).
CARD_BYTES = 80 * 10**9
META = torch.device("meta")


def _result_path(multi_pod: bool) -> str:
    name = ("dryrun_torch_multipod.json" if multi_pod
            else "dryrun_torch_singlepod.json")
    return os.path.join(RESULTS_DIR, name)


def _load_results(path):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _save_results(path, results):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Accounting.
# ---------------------------------------------------------------------------

# Ops that allocate and move no bytes.
_ALLOCATIONS = {torch.ops.aten.empty.memory_format,
                torch.ops.aten.empty_strided.default,
                torch.ops.aten.new_empty.default,
                torch.ops.aten.new_empty_strided.default,
                torch.ops.aten.empty_like.default}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


class OpBytes(TorchDispatchMode):
    """Counts the bytes the ops under it read and write (``nbytes``): each
    tensor argument and result once, views and allocations none."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _ALLOCATIONS:
            self.nbytes += sum(t.nbytes for t in
                               _tensors((args, kwargs or {}, out)))
        return out


@contextlib.contextmanager
def accounting(inputs, flops: bool = True):
    """Count what the enclosed code does with ``meta`` tensors.  Yields a
    dict that holds, once the block ends: ``memory`` (``MemTracker``'s
    peak of live bytes by its kinds, and ``peak_per_device``), ``flops``
    (the flop counter's and the kernels', or None without ``flops``),
    ``op_bytes`` (:class:`OpBytes`, plus the kernels' recorded bytes) and
    ``kernels`` (each kernel's calls, flops and bytes).  ``inputs`` are
    the trees of tensors that exist before the block and count toward
    its memory."""
    rec = cost.Recorder()
    tracker = MemTracker()
    ops = OpBytes()
    out: dict = {}
    counter = FlopCounterMode(display=False) if flops else None
    with contextlib.ExitStack() as stack:
        # the flop counter below the trackers: it decomposes some ops
        # into others whose intermediates a launch does not allocate
        if counter is not None:
            stack.enter_context(counter)
        tracker.track_external(*_tensors(inputs))
        stack.enter_context(tracker)
        stack.enter_context(ops)
        stack.enter_context(cost.recording(rec))
        yield out
    snap = tracker.get_tracker_snapshot("peak").get(META, {})
    memory = {getattr(k, "value", str(k)).lower(): int(v)
              for k, v in snap.items() if k != "Total"}
    memory["peak_per_device"] = int(snap.get("Total", 0))
    out["memory"] = memory
    out["flops"] = (None if counter is None
                    else counter.get_total_flops() + rec.flops)
    out["op_bytes"] = ops.nbytes + rec.nbytes
    out["kernels"] = rec.by_name()


# ---------------------------------------------------------------------------
# Cells.
# ---------------------------------------------------------------------------

def _blocks(full_tree, mesh, spec_fn=None, *args, dtype=None):
    """Fresh ``meta`` tensors of this rank's blocks of ``full_tree``
    under the specs ``spec_fn(*args)`` gives on ``mesh`` (the whole
    tensors without a mesh), in ``dtype`` or each leaf's own."""
    def block(full, spec=None):
        shape = full.shape if mesh is None else sharding.local_block(
            full, sharding.NamedSharding(mesh, spec)).shape
        return torch.empty(tuple(shape), dtype=dtype or full.dtype,
                           device=META)
    if mesh is None:
        return adamw.tree_map(block, full_tree)
    with sharding.use_mesh(mesh):
        specs = spec_fn(*args)
    return adamw.tree_map(block, full_tree, specs)


def lower_cell(cfg, shape, mesh, *, flops: bool = True) -> dict:
    """Trace one step of ``cfg`` at ``shape`` (a name of
    ``configs.shapes.SHAPES`` or a ``ShapeCase``) on one rank of
    ``mesh``: a :class:`TracedMesh` (its rank), an ``AbstractMesh`` (its
    rank 0), or None (a single process).  Returns ``memory``, ``flops``
    (None without ``flops``), ``op_bytes`` and ``kernels`` (of
    :func:`accounting`), ``collectives`` (the mesh's records, empty
    without one), ``chips`` and ``model_flops``."""
    case = shapes_mod.shape_case(shape)
    if mesh is not None and not isinstance(mesh, TracedMesh):
        mesh = TracedMesh(mesh)
    chips = 1 if mesh is None else math.prod(mesh.shape.values())
    bshapes = shapes_mod.input_specs(cfg, case)
    full = transformer.param_shapes(cfg)
    params = _blocks(full, mesh, transformer.param_specs, cfg)
    B, S = case.global_batch, case.seq_len
    if case.kind == "train":
        opt_cfg = adamw.AdamWConfig(accum_steps=cfg.train_accum)
        step = steps_mod.make_train_step(cfg, opt_cfg, mesh=mesh,
                                         batch_shapes=bshapes)
        opt = {k: _blocks(full, mesh, transformer.param_specs, cfg,
                          dtype=torch.float32) for k in ("m", "v")}
        opt["step"] = torch.empty((), dtype=torch.int32, device=META)
        inputs = (params, opt, bshapes)
        run = lambda: step(params, opt, bshapes)  # noqa: E731
        mf = hlo_analysis.model_flops_train(cfg, S, B)
    elif case.kind == "prefill":
        step = steps_mod.make_prefill_step(cfg, mesh, max_seq=S,
                                           batch_shapes=bshapes)
        if mesh is not None:
            # the plan's global cache is shapes, not memory: made before
            # the accounting starts
            step.plan(bshapes)
        inputs = (params, bshapes)
        run = lambda: step(params, bshapes)  # noqa: E731
        mf = hlo_analysis.model_flops_train(cfg, S, B) / 3.0
    else:  # decode
        cache_shapes = shapes_mod.decode_cache_specs(cfg, case)
        cache = _blocks(cache_shapes, mesh, steps_mod.cache_specs_tree,
                        cfg, cache_shapes)
        step = steps_mod.make_serve_step(cfg, mesh, cache_shapes=cache_shapes)
        tokens = bshapes["tokens"]
        inputs = (params, cache, tokens)
        run = lambda: step(params, cache, tokens, S - 1)  # noqa: E731
        mf = hlo_analysis.model_flops_decode(cfg, S, B)
    with accounting(inputs, flops=flops) as acc:
        run()
    acc["collectives"] = {} if mesh is None else dict(mesh.collectives)
    acc["chips"] = chips
    acc["model_flops"] = mf
    return acc


def run_cell(arch: str, shape_name: str, mesh, multi_pod: bool,
             verbose: bool = True, analysis: bool = True,
             smoke: bool = False):
    """The report row of one cell (``smoke``: the arch's smoke config at
    the cell's shapes): ``status`` ok, ``arch``, ``shape``, ``chips``,
    ``trace_s``, ``memory`` (the tracker's kinds, ``peak_per_device``,
    ``fits`` against :data:`CARD_BYTES`), each
    kernel's recorded calls, flops and bytes, and the roofline's fields;
    with ``analysis`` False the flop count is skipped (``flops`` 0).  A
    cell that ``cell_supported`` refuses is ``skipped``."""
    cfg = (configs.get_smoke_config(arch) if smoke
           else configs.get_config(arch))
    ok, reason = shapes_mod.cell_supported(cfg, shape_name)
    if not ok:
        return {"status": "skipped", "reason": reason}
    t0 = time.time()
    acc = lower_cell(cfg, shape_name, mesh, flops=analysis)
    trace_s = time.time() - t0
    chips = acc["chips"]
    roof = hlo_analysis.analyze(acc["flops"] or 0.0, acc["op_bytes"],
                                acc["collectives"], chips,
                                acc["model_flops"])
    memory = dict(acc["memory"])
    memory["fits"] = memory["peak_per_device"] <= CARD_BYTES
    row = {
        "status": "ok",
        "arch": arch, "shape": shape_name, "chips": chips,
        "trace_s": round(trace_s, 1),
        "memory": memory,
        "kernels": {k: {"calls": n, "flops": f, "bytes": b}
                    for k, (n, f, b) in acc["kernels"].items()},
        **roof.to_dict(),
    }
    if verbose:
        print(f"== {arch} x {shape_name} on {chips} chips "
              f"(trace {trace_s:.1f}s{', smoke config' if smoke else ''})")
        print(f"   memory: peak "
              f"{memory['peak_per_device'] / 1e9:.2f} GB a rank, fits "
              f"{memory['fits']}")
        print(f"   flops={roof.flops:.3e} bytes={roof.hbm_bytes:.3e} "
              f"coll/dev={roof.coll_bytes_per_device:.3e} {roof.counts}")
        print(f"   terms: compute={roof.compute_s*1e3:.2f}ms "
              f"memory={roof.memory_s*1e3:.2f}ms "
              f"collective={roof.collective_s*1e3:.2f}ms "
              f"-> {roof.dominant}-bound; useful={roof.useful_flops_frac:.2f} "
              f"roofline={roof.roofline_frac:.2f}")
    return row


def arch_ids() -> list:
    """One canonical dash-form id per architecture (no alias dupes):
    dotted ids first, ties broken by length (most specific)."""
    seen = {}
    for aid, mod in sorted(configs.ARCH_IDS.items()):
        if "-" not in aid:
            continue
        cur = seen.get(mod)
        if cur is None or ("." in aid, len(aid)) > ("." in cur, len(cur)):
            seen[mod] = aid
    return sorted(seen.values())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--arch", default=None, help="single arch id")
    ap.add_argument("--shape", default=None, help="single shape name")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--no-analysis", action="store_true",
                    help="skip the flop count (memory and collectives "
                         "only)")
    ap.add_argument("--smoke", action="store_true",
                    help="each arch's smoke config at the cells' shapes")
    ap.add_argument("--out", default=None,
                    help="the report's path (default "
                         "results/dryrun_torch_{singlepod,multipod}.json)")
    args = ap.parse_args(argv)

    mesh = mesh_mod.make_production_mesh(multi_pod=args.multi_pod)
    traced = TracedMesh(mesh)
    print(f"mesh: {dict(mesh.shape)} (rank {traced.rank} of "
          f"{len(traced.group_ranks(mesh.axis_names))} traced on meta; "
          f"a rank's memory {CARD_BYTES / 1e9:.1f} GB)")

    path = args.out or _result_path(args.multi_pod)
    results = _load_results(path)
    archs = [args.arch] if args.arch else arch_ids()
    shapes = [args.shape] if args.shape else list(shapes_mod.SHAPES)

    failures = []
    for arch in archs:
        for shape_name in shapes:
            key = f"{arch}|{shape_name}"
            if args.skip_done and key in results and \
                    results[key].get("status") in ("ok", "skipped"):
                continue
            try:
                row = run_cell(arch, shape_name, mesh, args.multi_pod,
                               analysis=not args.no_analysis,
                               smoke=args.smoke)
            except Exception as e:
                traceback.print_exc()
                row = {"status": "fail", "error": f"{type(e).__name__}: {e}"}
                failures.append(key)
            results[key] = row
            _save_results(path, results)

    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    n_skip = sum(1 for r in results.values() if r.get("status") == "skipped")
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, "
          f"{len(failures)} failed -> {path}")
    if failures:
        print("FAILED:", failures)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
