"""The port's roofline layer (``repro_torch.launch.hlo_analysis``) and the
collective records of its meshes against the JAX package's.

* ``model_flops_train`` and ``model_flops_decode`` equal the reference's
  for all 40 (arch, shape) cells at full size (prefill: a third of the
  training count, as the reference's ``lower_cell`` has it).
* ``collective_bytes`` of recorded calls, (kind, result bytes, group
  size) as a mesh records them, gives the reference parser's ``counts``,
  ``bytes_by_kind`` and ``per_device_bytes`` on the five collectives of
  ``tests/test_launch.py``'s HLO sample.
* ``Roofline``'s ``dominant``, ``bound_s`` and ``useful_flops_frac``
  equal the reference's on the same fields; the port's ``roofline_frac``
  and ``analyze`` use the H100 constants.
* A ``TracedMesh`` records every collective as a ``ProcessMesh`` does:
  its kind, the bytes of its result and its group size, the results
  ``meta`` tensors of the real results' shapes.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.launch import hlo_analysis as thlo  # noqa: E402
from repro_torch.launch import mesh as tlmesh  # noqa: E402
from repro_torch.runtime import mesh as tmesh  # noqa: E402
from repro_torch.runtime.sharding import AbstractMesh  # noqa: E402

import test_launch  # noqa: E402

CELLS = [(a, s) for a in tconfigs.ARCHS for s in tshapes.SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_match_reference(arch, shape):
    case = tshapes.SHAPES[shape]
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    B, S = case.global_batch, case.seq_len
    if case.kind == "decode":
        got = thlo.model_flops_decode(tcfg, S, B)
        want = jhlo.model_flops_decode(jcfg, S, B)
    else:
        got = thlo.model_flops_train(tcfg, S, B)
        want = jhlo.model_flops_train(jcfg, S, B)
    assert got == want and got > 0


# The five collectives of test_launch.HLO_SAMPLE as a mesh records them:
# (kind, result bytes on one rank, group size); the tuple all-reduce is
# one call whose result is both f32[8,8].
RECORDED = [("all-gather", 16 * 4096 * 6144 * 4, 16),
            ("all-reduce", 128 * 256 * 2, 16),
            ("all-reduce", 2 * 8 * 8 * 4, 128),
            ("collective-permute", 4 * 128 * 2, 2),
            ("reduce-scatter", 2 * 8 * 4, 64)]


def test_collective_bytes_match_reference_parser():
    ref = jhlo.collective_bytes(test_launch.HLO_SAMPLE)
    got = thlo.collective_bytes(collections.Counter(RECORDED))
    assert got.counts == ref.counts
    assert got.bytes_by_kind.keys() == ref.bytes_by_kind.keys()
    for k, v in ref.bytes_by_kind.items():
        assert got.bytes_by_kind[k] == pytest.approx(v, rel=1e-15)
    assert got.per_device_bytes == pytest.approx(ref.per_device_bytes,
                                                 rel=1e-15)


@pytest.mark.parametrize("i", range(len(RECORDED)))
def test_collective_bytes_counts_repeated_calls(i):
    one = thlo.collective_bytes({RECORDED[i]: 1})
    three = thlo.collective_bytes({RECORDED[i]: 3})
    assert three.counts == {RECORDED[i][0]: 3}
    assert three.per_device_bytes == pytest.approx(3 * one.per_device_bytes)


ROOFS = [
    # the reference's own test (memory-bound)
    dict(flops=1e15, hbm_bytes=1e13, coll_bytes_per_device=1e9, chips=256,
         model_flops=5e14),
    dict(flops=8.1e17, hbm_bytes=2.3e15, coll_bytes_per_device=1.4e10,
         chips=256, model_flops=3.7e16),
    dict(flops=2.5e13, hbm_bytes=2.3e13, coll_bytes_per_device=1.2e10,
         chips=512, model_flops=3.7e12),
    dict(flops=0.0, hbm_bytes=1e9, coll_bytes_per_device=0.0, chips=1,
         model_flops=1e9),
]


def _roofs(fields, peak, hbm, link):
    kw = dict(fields, compute_s=fields["flops"] / (fields["chips"] * peak),
              memory_s=fields["hbm_bytes"] / (fields["chips"] * hbm),
              collective_s=fields["coll_bytes_per_device"] / link,
              counts={})
    return thlo.Roofline(**kw), jhlo.Roofline(**kw)


@pytest.mark.parametrize("i", range(len(ROOFS)))
@pytest.mark.parametrize("consts", ["reference", "h100"])
def test_roofline_terms_match_reference(i, consts):
    mod = jhlo if consts == "reference" else thlo
    port, ref = _roofs(ROOFS[i], mod.PEAK_FLOPS, mod.HBM_BW, mod.LINK_BW)
    assert port.dominant == ref.dominant
    assert port.bound_s == ref.bound_s
    assert port.useful_flops_frac == ref.useful_flops_frac
    # the compute roofline's share at the port's own (H100) peak
    ideal = ROOFS[i]["model_flops"] / (ROOFS[i]["chips"] * thlo.PEAK_FLOPS)
    assert port.roofline_frac == pytest.approx(
        ideal / port.bound_s if port.bound_s else 0.0)
    assert set(port.to_dict()) == set(ref.to_dict())


def test_h100_constants():
    assert (thlo.PEAK_FLOPS, thlo.HBM_BW, thlo.LINK_BW) == (989e12, 3.35e12,
                                                          450e9)


def test_analyze_scales_one_rank_to_the_chips():
    records = collections.Counter(RECORDED)
    roof = thlo.analyze(2e12, 3e10, records, 256, 1e14)
    stats = thlo.collective_bytes(records)
    assert roof.flops == 2e12 * 256 and roof.hbm_bytes == 3e10 * 256
    assert roof.compute_s == pytest.approx(2e12 / thlo.PEAK_FLOPS)
    assert roof.memory_s == pytest.approx(3e10 / thlo.HBM_BW)
    assert roof.collective_s == pytest.approx(stats.per_device_bytes
                                              / thlo.LINK_BW)
    assert roof.counts == stats.counts


# -- TracedMesh ---------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("rank", [0, 37, 255])
def test_traced_mesh_groups(multi_pod, rank):
    mesh = tmesh.TracedMesh(tlmesh.make_production_mesh(multi_pod=multi_pod),
                            rank=rank)
    sizes = tuple(mesh.shape.values())
    assert mesh.device == torch.device("meta")
    for axes in (("model",), ("data",), ("data", "model"), mesh.axis_names):
        ranks = mesh.group_ranks(axes)
        assert len(ranks) == int(torch.tensor(
            [mesh.shape[a] for a in axes]).prod())
        assert ranks[mesh.index(axes)] == rank
        # the group's ranks differ from this rank only on ``axes``, in the
        # row-major order of the mesh
        coords = [dict(zip(mesh.axis_names, np.unravel_index(r, sizes)))
                  for r in ranks]
        assert all(c[a] == mesh.coords[a] for c in coords
                   for a in mesh.axis_names if a not in axes)
        assert ranks == sorted(ranks)


def test_traced_mesh_records_each_collective():
    mesh = tmesh.TracedMesh(AbstractMesh((2, 4), ("data", "model")), rank=5)
    x = _meta(8, 3)
    got = {
        "psum": mesh.psum(x, "model"),
        "pmax": mesh.pmax(x, ("data", "model")),
        "all_gather": mesh.all_gather(x, "data"),
        "reduce_scatter": mesh.reduce_scatter(x, "model"),
        "ppermute": mesh.ppermute(x, [(0, 1), (1, 0)], "data"),
    }
    want = {"psum": (8, 3), "pmax": (8, 3), "all_gather": (16, 3),
            "reduce_scatter": (2, 3), "ppermute": (8, 3)}
    for k, t in got.items():
        assert t.device.type == "meta" and tuple(t.shape) == want[k], k
        assert t.dtype == x.dtype
    assert dict(mesh.collectives) == {
        ("all-reduce", 96, 4): 1, ("all-reduce", 96, 8): 1,
        ("all-gather", 192, 2): 1, ("reduce-scatter", 24, 4): 1,
        ("collective-permute", 96, 2): 1}
    assert mesh.counts == {"psum": 1, "pmax": 1, "reduce_scatter": 1,
                           "all_gather": 1, "ppermute": 1, "objects": 0}
    with pytest.raises(ValueError, match="does not split"):
        mesh.reduce_scatter(_meta(6, 3), "model")


def test_traced_mesh_axis_allreduce_records_its_parts():
    mesh = tmesh.TracedMesh(AbstractMesh((2, 4), ("data", "model")))
    out = mesh.axis_allreduce(_meta(8, dtype=torch.float64),
                              ("data", "model"))
    assert tuple(out.shape) == (8,) and out.dtype == torch.float64
    assert dict(mesh.collectives) == {("all-reduce", 64, 2): 1,
                                      ("reduce-scatter", 16, 4): 1,
                                      ("all-gather", 64, 4): 1}


def test_traced_mesh_host_decisions():
    mesh = tmesh.TracedMesh(AbstractMesh((2, 4), ("data", "model")), rank=3)
    assert mesh.gather_objects("x", "model") == ["x"] * 4
    assert mesh.gather_objects(1) == [1] * 8
    assert mesh.counts["objects"] == 2 and not mesh.collectives
    mesh.raise_any(None)
    with pytest.raises(KeyError, match="mine"):
        mesh.raise_any(KeyError("mine"))
    with pytest.raises(ValueError, match="not on the mesh"):
        tmesh.TracedMesh(AbstractMesh((2, 4), ("data", "model")), rank=8)


def test_kinds_are_the_reference_hlo_names():
    assert set(tmesh.KINDS.values()) <= {
        "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
        "all-to-all"}
    assert set(tmesh.KINDS) | {"objects"} == set(
        tmesh.TracedMesh(AbstractMesh((1,), ("data",))).counts)
