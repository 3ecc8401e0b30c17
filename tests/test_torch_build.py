"""The port's kernels build from an installed package, not only from a
checkout: the wheel ships every CUDA source as package data, and the
build goes to the user's cache directory when the package lies outside
a checkout (to the checkout's git-ignored ``build/`` inside one).  The
wrappers' shared alignment check is tested here too."""
import pathlib
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
