"""The port's kernels build from an installed package, not only from a
checkout: the wheel ships every CUDA source as package data, and the
build goes to the user's cache directory when the package lies outside
a checkout (to the checkout's git-ignored ``build/`` inside one).  The
wrappers' shared alignment check is tested here too, that concurrent
builds compile once, and that the ctypes signatures match the C
launchers the sources export."""
import ctypes
import pathlib
import re
import tomllib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def test_package_data_ships_every_cuda_source():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = meta["tool"]["setuptools"]["package-data"]["repro_torch"]
    shipped = {p for g in globs for p in PKG.glob(g)}
    sources = set(_build.CSRC.glob("*.cu"))
    assert sources and sources <= shipped
    # and every file they include: a header, or a source (the soft-capped
    # instantiations' sources include the main ones)
    headers = set(_build.CSRC.glob("*.cuh"))
    assert headers and headers <= shipped
    for src in sources:
        for name in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert _build.CSRC / name in headers | sources, (src.name, name)


def test_library_hash_covers_the_headers(tmp_path, monkeypatch):
    """An edited header, which no source's bytes show, builds a new
    library; an unchanged tree maps to the same one."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    assert _build.library_path() == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path() != first
    assert [p.name for p in _build._sources()] == ["a.cu"]


def test_concurrent_builds_compile_once(tmp_path, monkeypatch):
    """Processes or threads that find no library build it one at a time:
    the first compiles, the others wait on the lock and load its library
    (the ranks of a distributed run on one card)."""
    import threading
    import time

    lib = tmp_path / "h" / "librepro_torch_kernels.so"
    monkeypatch.setattr(_build, "library_path", lambda: lib)
    compiled = []

    def compile_once(path):
        compiled.append(path)
        time.sleep(0.2)
        path.write_bytes(b"lib")

    monkeypatch.setattr(_build, "_compile", compile_once)
    got = []
    workers = [threading.Thread(target=lambda: got.append(_build.build()))
               for _ in range(6)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in workers)
    assert compiled == [lib] and got == [lib] * 6


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_check_aligned_refuses_a_view_off_16_bytes(dtype):
    # The f64 gram, ssd_scan and flash_attention wrappers call this before
    # they launch; a view one element into its storage starts 8 (f64) or
    # 4 (f32) bytes past a 16-byte boundary.
    base = torch.zeros(64, dtype=dtype)
    _build.check_aligned("gram", {"A": base[:32], "r": base[4:36]})
    with pytest.raises(ValueError, match="gram: r must be 16-byte aligned"):
        _build.check_aligned("gram", {"A": base[:32], "r": base[1:33]})


def test_build_root_in_a_checkout_is_its_build_dir():
    assert _build.build_root() == ROOT / "build" / "repro_torch_kernels"
    assert _build.library_path().is_relative_to(_build.build_root())


def test_build_root_of_an_installed_package_is_the_cache(tmp_path,
                                                          monkeypatch):
    kernels = tmp_path / "lib" / "site-packages" / "repro_torch" / "kernels"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_root(kernels) == (tmp_path / "cache"
                                          / "repro_torch_kernels")
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.build_root(kernels) == (tmp_path / "home" / ".cache"
                                          / "repro_torch_kernels")
    # a src/ layout without a pyproject.toml is not a checkout either
    stray = tmp_path / "src" / "repro_torch" / "kernels"
    assert _build.build_root(stray).parent == tmp_path / "home" / ".cache"


def _exported(source: str) -> dict:
    """{name: C parameter types} of every ``extern "C" int`` function of a
    .cu source, each parameter as "P" (a pointer), "F" (a float) or "I"
    (an int)."""
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', source):
        params = [p.strip() for p in m.group(2).split(",") if p.strip()]
        out[m.group(1)] = tuple("P" if "*" in p else
                                "F" if p.startswith("float ") else "I"
                                for p in params)
    return out


def test_signatures_cover_every_exported_function():
    """Every launcher the sources export is bound with its C parameter
    list (the three backward kernels' entries included), and every bound
    name is exported."""
    exported = {}
    for src in _build.CSRC.glob("*.cu"):
        exported.update(_exported(src.read_text()))
    for name in ("repro_flash_attention_bwd_bf16",
                 "repro_flash_attention_bwd_f32", "repro_rglru_scan_bwd_f32",
                 "repro_rglru_scan_bwd_bf16",
                 "repro_rglru_scan_bwd_carry_f32",
                 "repro_rglru_scan_bwd_carry_bf16", "repro_ssd_scan_bwd_f32"):
        assert name in exported and name in _build.SIGNATURES
    assert set(exported) == set(_build.SIGNATURES)
    kind = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F"}
    for name, params in exported.items():
        assert tuple(kind[t] for t in _build.SIGNATURES[name]) == params, \
            name


def test_backward_sources_ship_as_package_data():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = meta["tool"]["setuptools"]["package-data"]["repro_torch"]
    shipped = {p.name for g in globs for p in PKG.glob(g)}
    assert {"flash_attention_bwd.cu", "flash_attention_bwd_f32.cu",
            "ssd_scan_bwd.cu", "rglru_scan.cu"} <= shipped
    # every source the build compiles ships
    assert {p.name for p in _build.CSRC.glob("*.cu")} <= shipped


def test_kernel_constants_match_their_python_copies():
    """The rglru_scan backward's chunk length, which the plain copy and the
    workspace's shape take from ``ref.RGLRU_BWD_CHUNK``, the rglru_scan
    forward's TMA boxes and stages, which ``rglru_scan.fwd_plan``
    restates, the f32
    attention forward's tiles, which ``flash_attention.launch_plan``
    restates, and the f32 attention backward's tiles, stages and
    query-head groups, which ``flash_attention.bwd_plan`` restates, and
    the Schwarz kernels' chunks, parts, stages and row segments, which
    ``schwarz_step.fwd_plan`` and ``bwd_plan`` restate, are the sources'
    own."""
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.kernels import ref as t_ref
    from repro_torch.kernels import rglru_scan as t_rg

    def const(source, name):
        text = (_build.CSRC / source).read_text()
        return int(re.search(rf"constexpr int {name} = (\d+);", text)
                   .group(1))

    assert const("rglru_scan.cu", "kChunk") == t_ref.RGLRU_BWD_CHUNK \
        == t_rg.BWD_CHUNK
    assert t_rg.bwd_workspace_shape((2, 4096, 4096)) == (2, 2, 64, 4096)
    assert tuple(const("rglru_scan.cu", name) for name in (
        "kTmaCh", "kTmaSteps", "kTmaStages", "kTmaOut")) == (
        t_rg.TMA_CH, t_rg.TMA_STEPS, t_rg.TMA_STAGES, t_rg.TMA_OUT)
    assert t_rg.bwd_workspace_shape((3, 65, 5)) == (2, 3, 2, 5)
    fwd = {name: const("flash_attention.cu", name)
           for name in ("kBQ32", "kBK32", "kStages32", "kT32")}
    plan = t_fa.launch_plan((32, 4096, 256), (2, 4096, 256),
                            (2, 4096, 256), torch.float32)
    assert (fwd["kBQ32"], fwd["kBK32"], fwd["kStages32"], fwd["kT32"]) \
        == (t_fa.F32_BQ, t_fa.F32_BK, t_fa.F32_STAGES, 256) \
        == (plan["bq"], plan["bk"], plan["stages"], plan["threads"])
    bwd = {name: const("flash_attention_bwd_f32.cu", name)
           for name in ("kBQ", "kBK", "kBKV", "kBQT", "kStages", "kThreads")}
    plan = t_fa.bwd_plan((32, 4096, 256), (2, 4096, 256), torch.float32)
    assert (bwd["kBQ"], bwd["kBK"], bwd["kBKV"], bwd["kBQT"],
            bwd["kStages"]) == (t_fa.F32_BWD_BQ, t_fa.F32_BWD_BK,
                                t_fa.F32_BWD_BKV, t_fa.F32_BWD_BQT,
                                t_fa.F32_BWD_STAGES)
    assert (plan["bq"], plan["bk"], plan["bkv"], plan["bqt"], plan["stages"],
            plan["threads"]) == (bwd["kBQ"], bwd["kBK"], bwd["kBKV"],
                                 bwd["kBQT"], bwd["kStages"],
                                 bwd["kThreads"])
    # the dkdv launch's query-head groups: two while the kv blocks of the
    # kv heads are fewer than two waves of the card's SMs, as bwd_plan
    text = (_build.CSRC / "flash_attention_bwd_f32.cu").read_text()
    rule = re.search(r"return rep >= 2 && n_kv_blocks < 2 \* (\d+) \? 2 : 1;",
                     text)
    assert rule and int(rule.group(1)) == _build.NUM_SMS
    assert plan["groups"] == 2 and plan["dkdv_ctas"] == 128 * 2 * 2
    # the Schwarz kernels' rows a chunk and a part, CTAs a launch aims at,
    # stages and row segments, which schwarz_step.fwd_plan and bwd_plan
    # restate
    from repro_torch.kernels import schwarz_step as t_sch
    sch = {name: const("schwarz_step.cu", name)
           for name in ("kWarps", "kFill", "kParts", "kMinRows", "kMaxRows",
                        "kMinCols", "kStageBytes", "kStages", "kTileBytes",
                        "kFinishThreads", "kSmemMax", "kHead")}
    assert sch == {"kWarps": t_sch.WARPS, "kFill": t_sch.FILL,
                   "kParts": t_sch.PARTS, "kMinRows": t_sch.MIN_ROWS,
                   "kMaxRows": t_sch.MAX_ROWS, "kMinCols": t_sch.MIN_COLS,
                   "kStageBytes": t_sch.STAGE_BYTES,
                   "kStages": t_sch.STAGES, "kTileBytes": t_sch.TILE_BYTES,
                   "kFinishThreads": t_sch.FINISH_THREADS,
                   "kSmemMax": t_sch.SMEM_MAX, "kHead": t_sch.HEAD}
    assert sch["kFill"] == 2 * _build.NUM_SMS
    assert t_sch.THREADS == 32 * sch["kWarps"] + 32
