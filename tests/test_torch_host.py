"""The port's host modules (numpy copies) against the JAX package's, bitwise.

DyDD results, domain counts/rebalances/state, decompositions and their
halo schedules, the CLS operators, every registered stream and the comm
model must come out identical — these decide what the device solves.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.assim import streams as j_streams  # noqa: E402
from repro.core import cls as j_cls  # noqa: E402
from repro.core import ddkf as j_ddkf  # noqa: E402
from repro.core import dydd as j_dydd  # noqa: E402
from repro.core import dydd2d as j_dydd2d  # noqa: E402
from repro.core import domain as j_domain  # noqa: E402
from repro.core import kdtree as j_kdtree  # noqa: E402
from repro.data import observations as j_obs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.assim import streams as t_streams  # noqa: E402
from repro_torch.core import cls as t_cls  # noqa: E402
from repro_torch.core import ddkf as t_ddkf  # noqa: E402
from repro_torch.core import dydd as t_dydd  # noqa: E402
from repro_torch.core import dydd2d as t_dydd2d  # noqa: E402
from repro_torch.core import domain as t_domain  # noqa: E402
from repro_torch.core import kdtree as t_kdtree  # noqa: E402
from repro_torch.data import observations as t_obs  # noqa: E402


def assert_same(a, b, where="value"):
    """Recursive bitwise equality of results (dataclasses, containers,
    numpy arrays with their dtypes, scalars)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    else:
        assert a == b or (a != a and b != b), f"{where}: {a!r} != {b!r}"


@pytest.mark.parametrize("case", ["beta", "tied", "warm_offsets"])
def test_dydd_1d_bitwise(case):
    rng = np.random.default_rng(5)
    kw = {}
    if case == "beta":
        obs = np.sort(rng.beta(2, 5, 400))
    elif case == "tied":
        obs = np.sort(np.round(rng.uniform(0, 1, 300), 1))
    else:
        obs = np.sort(rng.beta(5, 2, 500))
        kw = dict(boundaries=np.linspace(0, 1, 9) ** 1.3,
                  cost_offsets=rng.integers(0, 20, 8).astype(float))
    assert_same(j_dydd.dydd_1d(obs, 8, **kw), t_dydd.dydd_1d(obs, 8, **kw))


def test_dydd_2d_bitwise():
    rng = np.random.default_rng(6)
    pts = rng.beta(2, 5, (600, 2))
    pts = pts[np.lexsort((pts[:, 0], pts[:, 1]))]
    assert_same(j_dydd2d.dydd_2d(pts, 2, 4), t_dydd2d.dydd_2d(pts, 2, 4))
    quant = np.round(pts, 1) * 0.999
    quant = quant[np.lexsort((quant[:, 0], quant[:, 1]))]
    assert_same(j_dydd2d.dydd_2d(quant, 3, 2),
                t_dydd2d.dydd_2d(quant, 3, 2))


def _domains(kind):
    if kind == "interval":
        return (j_domain.Interval1D(n=96, p=6),
                t_domain.Interval1D(n=96, p=6), "storm_front")
    if kind == "shelf":
        return (j_domain.ShelfTiling2D(nx=16, ny=12, pr=2, pc=3),
                t_domain.ShelfTiling2D(nx=16, ny=12, pr=2, pc=3),
                "rotating_swarm")
    return (j_kdtree.KDTreeDomain(nx=16, ny=12, p=6),
            t_kdtree.KDTreeDomain(nx=16, ny=12, p=6), "satellite_track")


@pytest.mark.parametrize("kind", ["interval", "shelf", "kdtree"])
def test_domain_stream_bitwise(kind):
    jd, td, scenario = _domains(kind)
    for obs in j_streams.make_stream(scenario, 300, 4, seed=2):
        assert_same(jd.counts(obs), td.counts(obs), "counts")
        assert_same(jd.rebalance(obs), td.rebalance(obs), "rebalance")
        assert_same(jd.state_dict(), td.state_dict(), "state_dict")
        assert_same(jd.counts(obs), td.counts(obs), "counts after")
        assert_same(jd.obs_positions(obs), td.obs_positions(obs))
        assert_same(jd.describe(), td.describe())
        for overlap in (0, 1, 2):
            jdec = jd.decomposition(overlap=overlap)
            tdec = td.decomposition(overlap=overlap)
            assert_same(jdec.col_sets, tdec.col_sets, "col_sets")
            assert_same(jdec.column_multiplicity, tdec.column_multiplicity)
            assert_same(jdec.halo_sizes, tdec.halo_sizes)
            assert jdec.halo_fraction == tdec.halo_fraction
            jh, th = jdec.halo_exchange, tdec.halo_exchange
            for f in ("p", "w", "h", "rounds", "edges", "shared",
                      "send_slots", "perms", "pack_idx", "unpack_idx"):
                assert_same(getattr(jh, f), getattr(th, f), f"halo.{f}")
    # The converted state rebuilds the same domain.
    rebuilt = convert.domain_from_state(jd.describe(), jd.state_dict())
    assert_same(rebuilt.state_dict(), jd.state_dict())
    assert_same(rebuilt.counts(obs), jd.counts(obs))


def test_operators_bitwise():
    rng = np.random.default_rng(7)
    obs = rng.uniform(0, 1, 120)
    assert_same(j_cls.state_operator(50, smooth=0.3),
                t_cls.state_operator(50, smooth=0.3))
    for block in (None, 10):
        assert_same(j_cls.observation_operator(50, obs, block=block),
                    t_cls.observation_operator(50, obs, block=block))
    for kind in ("beta", "uniform", "clustered"):
        assert_same(j_obs.make_observations(200, kind=kind, seed=3),
                    t_obs.make_observations(200, kind=kind, seed=3))


def test_every_stream_bitwise():
    assert j_streams.available() == t_streams.available()
    for name in j_streams.available():
        assert (j_streams.get(name).ndim == t_streams.get(name).ndim)
        j_draws = list(j_streams.make_stream(name, 150, 4, seed=1))
        t_draws = list(t_streams.make_stream(name, 150, 4, seed=1))
        assert_same(j_draws, t_draws, name)


def test_comm_model_bitwise():
    jd = j_domain.ShelfTiling2D(nx=16, ny=12, pr=2, pc=3)
    td = t_domain.ShelfTiling2D(nx=16, ny=12, pr=2, pc=3)
    halo_j = jd.decomposition(overlap=2).halo_exchange
    halo_t = td.decomposition(overlap=2).halo_exchange
    for comm, mesh in (("allreduce", None), ("allreduce", (2, 3)),
                       ("neighbour", (2, 3))):
        assert_same(
            j_ddkf.comm_model(192, 500, 6, 8, halo=halo_j, comm=comm,
                              mesh_shape=mesh),
            t_ddkf.comm_model(192, 500, 6, 8, halo=halo_t, comm=comm,
                              mesh_shape=mesh), comm)
