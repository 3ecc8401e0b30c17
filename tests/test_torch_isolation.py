"""The port stands alone: no JAX, nothing of ``repro``, the card by default.

* In a subprocess whose import system refuses ``jax`` and ``repro``,
  every module of ``repro_torch`` still imports.
* No import statement anywhere in ``src/repro_torch`` or in
  ``chip_smoke.py`` (including those inside functions) names ``jax`` or
  ``repro``.
* Entry points built without a device want the card and raise here.
* The CUDA kernel wrappers refuse CPU tensors instead of falling back.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.assim import engine as t_engine  # noqa: E402
from repro_torch.kernels import gram as t_gram  # noqa: E402
from repro_torch.kernels import schwarz_step as t_sch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
assert not bad, bad
print(len(names))
"""


def test_every_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_import_statement_names_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    for f in files:
        assert not _imported_roots(f) & {"jax", "jaxlib", "repro"}, f


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_engine.AssimilationEngine(t_engine.EngineConfig())


def test_kernel_wrappers_refuse_cpu_tensors():
    A = torch.zeros(2, 8, 3, dtype=torch.float64)
    v, m, pw = torch.zeros(8), torch.zeros(2, 8), torch.zeros(2, 3)
    v, m, pw = (t.double() for t in (v, m, pw))
    before = (t_gram.launches, t_sch.fwd_launches, t_sch.bwd_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_gram.gram(A, m)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_sch.schwarz_fwd(A, pw, pw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_sch.schwarz_bwd(A, v, v, v, m, pw, pw, pw)
    with pytest.raises(TypeError, match="float64 or float32"):
        t_gram.gram(A.half(), m.half())
    assert (t_gram.launches, t_sch.fwd_launches,
            t_sch.bwd_launches) == before
