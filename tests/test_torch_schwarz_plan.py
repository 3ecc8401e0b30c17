"""The Schwarz step kernels' launch plans (``kernels/schwarz_step.py``).

A subdomain's bits from ``schwarz_fwd`` and ``schwarz_bwd`` depend only on
its own data and (m, w): the rows each sum runs over (the forward's
chunks, the backward's parts) must not move with p, the number of
subdomains launched together.  These tests hold the plans that restate
the CUDA launches to that at ex4_p8's (6094, 1553) and at chip_smoke.py's
ragged shapes (restated here), check the backward's scratch the wrapper
allocates, the row copies' 16-byte granules at every offset a view can
start at, and that CPU tensors still take the plain versions.
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import schwarz_step as sch

MAIN = (6094, 1553)                      # ex4_p8's (m, w)
# chip_smoke.py's RAGGED (p, m, w, pad): m and w off every tile, w = 1.
RAGGED = ((3, 1001, 77, 0), (2, 37, 1, 0), (2, 300, 130, 9),
          (1, 5, 300, 40), (2, 1003, 389, 0))
WIDE = ((33, 15000), (300, 2500))        # chip_smoke.py's SCHWARZ_WIDE
SHAPES = (MAIN,) + tuple((m, w) for _, m, w, _ in RAGGED) + WIDE
PS = (1, 3, 8, 32)
DTYPES = (torch.float64, torch.float32)
SMEM_SM = 233472     # an SM's shared memory; each CTA also holds 1 KB


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
@pytest.mark.parametrize("mw", SHAPES, ids=[f"{m}x{w}" for m, w in SHAPES])
def test_row_split_is_the_same_for_every_p(mw, dtype):
    m, w = mw
    fwd = [sch.fwd_plan((p, m, w), dtype) for p in PS]
    bwd = [sch.bwd_plan((p, m, w), dtype) for p in PS]
    # the forward's whole launch but the grid's p; the backward's rows
    # and parts (its row segments may be cut finer at small p: no sum
    # runs across columns)
    for plan in fwd[1:]:
        assert {k: v for k, v in plan.items() if k != "grid"} == \
            {k: v for k, v in fwd[0].items() if k != "grid"}
    assert len({(b["rows"], b["parts"]) for b in bwd}) == 1
    for p, f, b in zip(PS, fwd, bwd):
        assert f["grid"] == (f["chunks"], p)
        assert b["grid"] == (b["parts"], b["tiles"], p)
        assert b["scratch"] == (p, b["parts"], w)
    for split, rows, n in ((sch.row_chunks(m), fwd[0]["rows"],
                            fwd[0]["chunks"]),
                           (sch.bwd_parts(m), bwd[0]["rows"],
                            bwd[0]["parts"])):
        assert len(split) == n
        assert split[0][0] == 0 and split[-1][1] == m
        assert all(a[1] == b[0] for a, b in zip(split, split[1:]))
        assert all(e - s == rows for s, e in split[:-1])
        assert 0 < split[-1][1] - split[-1][0] <= rows
    assert sch.chunk_rows(m) == fwd[0]["rows"]
    assert sch.part_rows(m) == bwd[0]["rows"]


def test_one_subdomain_fills_the_card_and_eight_keep_whole_rows():
    sms = _build.NUM_SMS
    f1 = sch.fwd_plan((1,) + MAIN, torch.float64)
    b1 = sch.bwd_plan((1,) + MAIN, torch.float64)
    b8 = sch.bwd_plan((8,) + MAIN, torch.float64)
    assert (f1["rows"], f1["chunks"]) == (23, 265)
    assert f1["chunks"] >= 2 * sms
    assert (b1["rows"], b1["parts"], b1["tiles"], b1["cols"]) == \
        (191, 32, 8, 195)
    assert b1["parts"] * b1["tiles"] >= 1.9 * sms
    assert (b8["tiles"], b8["cols"]) == (1, MAIN[1])
    for plan in (f1, b1, b8):
        assert plan["stages"] == sch.STAGES and plan["stage_rows"] >= 1
        assert 2 * (plan["smem_bytes"] + 1024) <= SMEM_SM
    # the forward's xs and 4 stages of one 12424-byte row: three an SM
    assert f1["stage_x"] and f1["smem_bytes"] == 74768
    assert 3 * (f1["smem_bytes"] + 1024) <= SMEM_SM


def test_every_width_the_earlier_kernels_took_still_launches():
    # the earlier forward staged 2 w values in at most 232448 bytes; the
    # earlier backward took any w
    for dtype, w in ((torch.float64, 14528), (torch.float32, 29056)):
        plan = sch.fwd_plan((2, 33, w), dtype)
        assert plan["stages"] >= 1 and not plan["stage_x"]
        assert plan["smem_bytes"] <= sch.SMEM_MAX
    assert sch.fwd_plan((1, 8, 40000), torch.float64)["stages"] == 0
    for dtype in DTYPES:
        plan = sch.bwd_plan((1, 8, 10 ** 6), dtype)
        size = torch.empty((), dtype=dtype).element_size()
        assert plan["stages"] >= 1 and plan["smem_bytes"] <= sch.SMEM_MAX
        assert plan["cols"] * size <= sch.TILE_BYTES
        assert plan["tiles"] * plan["cols"] >= 10 ** 6


def _granules(addr: int, n: int, size: int) -> tuple:
    """The kernels' copy of n elements at byte address addr: the first
    byte and length of the 16-byte granules that hold them."""
    lo = addr & ~15
    return lo, ((addr + n * size + 15) & ~15) - lo


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
@pytest.mark.parametrize("mw", SHAPES, ids=[f"{m}x{w}" for m, w in SHAPES])
def test_row_copies_fit_their_slot_at_every_offset(mw, dtype):
    """Each row segment, from a view starting at any element past a
    16-byte boundary, is copied whole into its stride of the stage and
    read back from its offset there; the copy reaches at most 15 bytes
    past the segment on either side."""
    m, w = mw
    size = torch.empty((), dtype=dtype).element_size()
    rng = np.random.default_rng(0)
    for plan in (sch.fwd_plan((1, m, w), dtype),
                 sch.bwd_plan((1, m, w), dtype)):
        rows = min(m, 4)
        for offset in range(0, 16, size):
            mem = rng.integers(0, 256, 64 + (rows * w + 1) * size + 64,
                               dtype=np.uint8)
            base = 64 + offset
            for k in range(rows):
                for c0 in range(0, w, plan["cols"]):
                    n = min(plan["cols"], w - c0)
                    addr = base + (k * w + c0) * size
                    lo, length = _granules(addr, n, size)
                    assert lo % 16 == 0 and length % 16 == 0
                    assert addr - 15 <= lo and lo + length <= addr + \
                        n * size + 15
                    assert length <= plan["stride"]
                    slot = mem[lo:lo + length]
                    got = slot[addr & 15:(addr & 15) + n * size]
                    assert np.array_equal(got, mem[addr:addr + n * size])
        assert plan["stage_rows"] * plan["stride"] * plan["stages"] <= \
            plan["smem_bytes"]


def test_backward_scratch_is_the_plan_s(monkeypatch):
    """The wrapper allocates the (p, parts, w) scratch of ``bwd_plan`` and
    passes ``parts`` to the C entry, which refuses any other (run here
    with the library and the device checks stood in for)."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(repro_schwarz_bwd_f64=entry)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "check_inputs",
                        lambda name, tensors: torch.float64)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    made = []
    empty = torch.empty

    def record(*args, **kwargs):
        t = empty(*args, **kwargs)
        made.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", record)
    for p, m, w in ((1,) + MAIN, (8,) + MAIN, (3, 1001, 77), (2, 37, 1)):
        A = empty((p, m, w), dtype=torch.float64)
        mv, pm, pw = (empty(s, dtype=torch.float64)
                      for s in ((m,), (p, m), (p, w)))
        made.clear()
        calls.clear()
        before = sch.bwd_launches
        out = sch.schwarz_bwd(A, mv, mv, mv, pm, pw, pw, pw)
        plan = sch.bwd_plan((p, m, w), torch.float64)
        assert made == [plan["scratch"], (p, w)]
        assert tuple(out.shape) == (p, w)
        assert calls[0][10:14] == (p, m, w, plan["parts"])
        assert sch.bwd_launches == before + 1
    assert sch.bwd_plan((8,) + MAIN, torch.float64)["scratch"] == \
        (8, 32, MAIN[1])


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_ops_sends_cpu_tensors_to_the_plain_versions(dtype):
    gen = torch.Generator().manual_seed(0)
    p, m, w = 3, 1001, 77

    def v(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype)

    A, x, wdiv = v(p, m, w), v(p, w), v(p, w).abs()
    r, b, Ax, u, muov, mask = (v(m).abs(), v(m), v(m), v(p, m),
                               v(p, w).abs(), torch.ones(p, w, dtype=dtype))
    ops.reset_counts()
    y, uu = ops.schwarz_fwd(A, x, wdiv)
    y_p, u_p = ref.schwarz_fwd_plain(A, x, wdiv)
    rhs = ops.schwarz_bwd(A, r, b, Ax, u, x, muov, mask)
    assert torch.equal(y, y_p) and torch.equal(uu, u_p)
    assert torch.equal(rhs, ref.schwarz_bwd_plain(A, r, b, Ax, u, x, muov,
                                                  mask))
    counts = ops.launch_counts()
    assert counts["schwarz_fwd"] == counts["schwarz_bwd"] == 0
