"""The port's sharding layer's host logic against the JAX package's,
bitwise, for all ten architectures.

For each arch of ``repro_torch.configs.PORTED`` at full size, in its own
sharding profile and in the other one, outside any mesh (the production
mesh's sizes) and under the ("data", "model") meshes (2, 2), (4, 1) and
(1, 2) and the ("pod", "data", "model") mesh (2, 16, 16) — the port's
``sharding.use_mesh(AbstractMesh(...))`` against the reference's
``jax.sharding.use_abstract_mesh(AbstractMesh(...))``, in this process —
each of these equals the reference's, specs compared as tuples:
``param_specs``, ``opt_specs``, ``batch_specs`` of every (arch, shape)
cell's ``input_specs`` and ``cache_specs_tree`` of every supported
decode cell's ``decode_cache_specs``.  Mesh-free: ``param_shapes`` and
``input_specs`` (shapes and dtypes), the decode caches' shapes and
dtypes, and ``cell_supported`` of every cell.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.launch import mesh as tlmesh  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.runtime import sharding as tsharding  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

MESHES = {"production": None,
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts (specs, tensors and shape structs are
    leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _same_specs(got, want) -> None:
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert isinstance(spec, PartitionSpec), k
        assert isinstance(got[k], tsharding.P), k
        assert tuple(got[k]) == tuple(spec), (k, got[k], spec)


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _same_shapes(got, want) -> None:
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, s in want.items():
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(s.shape), k
        assert _dtype(got[k]) == str(np.dtype(s.dtype)), k


def _cfgs(arch: str):
    """(reference, port) full-size configs in the arch's profile and in
    the other."""
    cj, ct = jconfigs.get_config(arch), tconfigs.get_config(arch)
    other = "tp" if cj.sharding_profile == "dp" else "dp"
    return [(cj, ct), (dataclasses.replace(cj, sharding_profile=other),
                       dataclasses.replace(ct, sharding_profile=other))]


@functools.lru_cache(maxsize=None)
def _decode_caches(arch: str) -> dict:
    """{shape: (reference cache structs, port meta cache)} of the arch's
    supported decode cells."""
    cj, ct = jconfigs.get_config(arch), tconfigs.get_config(arch)
    return {shape: (jshapes.decode_cache_specs(cj, shape),
                    tshapes.decode_cache_specs(ct, shape))
            for shape, case in jshapes.SHAPES.items()
            if case.kind == "decode" and jshapes.cell_supported(cj,
                                                                shape)[0]}


def _under(mesh):
    """(reference context, port context) of one entry of MESHES."""
    if mesh is None:
        import contextlib
        return contextlib.nullcontext(), contextlib.nullcontext()
    sizes, names = mesh
    return (jax.sharding.use_abstract_mesh(
                jax.sharding.AbstractMesh(sizes, names)),
            tsharding.use_mesh(tsharding.AbstractMesh(sizes, names)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", tconfigs.PORTED)
def test_specs_match_reference(arch, mesh):
    caches = _decode_caches(arch)
    for cj, ct in _cfgs(arch):
        ref_ctx, port_ctx = _under(MESHES[mesh])
        with ref_ctx:
            want = {"params": jtransformer.param_specs(cj),
                    "opt": jsteps.opt_specs(cj),
                    "batch": {s: jsteps.batch_specs(
                        cj, jshapes.input_specs(cj, s))
                        for s in jshapes.SHAPES},
                    "cache": {s: jsteps.cache_specs_tree(cj, c[0])
                              for s, c in caches.items()}}
        with port_ctx:
            got = {"params": ttransformer.param_specs(ct),
                   "opt": tsteps.opt_specs(ct),
                   "batch": {s: tsteps.batch_specs(
                       ct, tshapes.input_specs(ct, s))
                       for s in tshapes.SHAPES},
                   "cache": {s: tsteps.cache_specs_tree(ct, c[1])
                             for s, c in caches.items()}}
        _same_specs(got, want)


@pytest.mark.parametrize("arch", tconfigs.PORTED)
def test_shapes_and_cells_match_reference(arch):
    cj, ct = jconfigs.get_config(arch), tconfigs.get_config(arch)
    _same_shapes(ttransformer.param_shapes(ct),
                 jtransformer.param_shapes(cj))
    _same_shapes(ttransformer.param_shapes(ct, dtype=torch.float32),
                 jtransformer.param_shapes(cj, dtype=np.float32))
    for shape in jshapes.SHAPES:
        assert tshapes.cell_supported(ct, shape) == \
            jshapes.cell_supported(cj, shape)
        _same_shapes(tshapes.input_specs(ct, shape),
                     jshapes.input_specs(cj, shape))
    for shape, (want, got) in _decode_caches(arch).items():
        _same_shapes(got, want)
    assert tshapes.LONG_CONTEXT_OK == jshapes.LONG_CONTEXT_OK
    assert {k: dataclasses.astuple(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_reference(multi_pod):
    """The reference's production mesh needs 256 or 512 devices; its
    sizes and names are held here, and its specs through an abstract
    mesh of them."""
    got = tlmesh.make_production_mesh(multi_pod=multi_pod)
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert got.shape == dict(zip(names, sizes))
    # the reference's mesh of those sizes gives the same specs
    cj, ct = jconfigs.get_config("yi-6b"), tconfigs.get_config("yi-6b")
    with jax.sharding.use_abstract_mesh(jax.sharding.AbstractMesh(sizes,
                                                                  names)):
        want = jtransformer.param_specs(cj)
    with tsharding.use_mesh(got):
        _same_specs(ttransformer.param_specs(ct), want)


def test_rules_and_fallbacks_match_reference():
    from repro.runtime import sharding as jsharding
    for name in ("PARAM_RULES_TP", "PARAM_RULES_DP", "ACT_RULES_TP",
                 "ACT_RULES_DP", "_DEFAULT_SIZES"):
        assert getattr(tsharding, name) == getattr(jsharding, name), name
    sizes = {"data": 2, "model": 4}
    for shape in ((1, 8), (2, 8), (8, 8), (8, 3), (6, 12)):
        for profile in ("tp", "dp"):
            with jsharding.profile(profile), tsharding.profile(profile):
                for axes in (("batch", "vocab"), ("batch", "kv_seq"),
                             ("loss_batch", "ff")):
                    assert tuple(tsharding._resolve(
                        axes, tsharding._act_rules(), sizes, shape)) == \
                        tuple(jsharding._resolve(
                            axes, jsharding._act_rules(), sizes, shape))
                assert tuple(tsharding._resolve(
                    ("embed", "heads"), tsharding._param_rules(), sizes,
                    shape)) == tuple(jsharding._resolve(
                        ("embed", "heads"), jsharding._param_rules(), sizes,
                        shape))
    assert tsharding.current_profile() == jsharding.current_profile() == "tp"
