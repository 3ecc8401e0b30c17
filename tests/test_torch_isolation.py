"""The port stands alone: no JAX, nothing of ``repro``, the card by default.

* In a subprocess whose import system refuses ``jax`` and ``repro``,
  every module of ``repro_torch`` still imports.
* No import statement anywhere in ``src/repro_torch``, in
  ``chip_smoke.py``, ``attention_probe.py``, ``schwarz_probe.py`` or the
  port's examples (``examples/*_torch.py``; including those inside
  functions) names ``jax`` or ``repro``.
* Entry points built without a device want the card and raise here:
  the assimilation engines (sequential and Parareal), the ranks'
  launcher, the fleet server,
  the engine's restore and elastic resume, the assimilation CLI, the LM
  weights (and so ``serve_batch``), the serving CLI, the trainer
  (``train`` and its CLI) and the port's four examples.
* The CUDA kernel wrappers, the backward kernels' among them, refuse CPU
  tensors instead of falling back.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import convert as t_convert  # noqa: E402
from repro_torch.assim import engine as t_engine  # noqa: E402
from repro_torch.assim import serving as t_serving  # noqa: E402
from repro_torch.runtime import elastic as t_elastic  # noqa: E402
from repro_torch.assim import timepar as t_timepar  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import transformer as t_transformer  # noqa: E402
from repro_torch.runtime import steps as t_steps  # noqa: E402
from repro_torch.kernels import flash_attention as t_fa  # noqa: E402
from repro_torch.kernels import gram as t_gram  # noqa: E402
from repro_torch.kernels import rglru_scan as t_rg  # noqa: E402
from repro_torch.kernels import schwarz_step as t_sch  # noqa: E402
from repro_torch.kernels import ssd_scan as t_ssd  # noqa: E402

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
for name in ("repro_torch.core.kalman", "repro_torch.assim.timepar",
             "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
             "repro_torch.runtime.chaos", "repro_torch.runtime.elastic",
             "repro_torch.assim.fleet", "repro_torch.assim.serving",
             "repro_torch.optim.adamw", "repro_torch.optim.schedule",
             "repro_torch.optim.compress", "repro_torch.core.balance",
             "repro_torch.data.pipeline", "repro_torch.launch.train",
             "repro_torch.runtime.sharding", "repro_torch.runtime.steps",
             "repro_torch.configs.shapes", "repro_torch.launch.mesh"):
    assert name in names, name
print(len(names))
"""


def test_every_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_import_statement_names_jax_or_repro():
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(examples) == 4
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "attention_probe.py",
                                          ROOT / "schwarz_probe.py"]
    assert len(files) > 25
    for f in files + examples:
        assert not _imported_roots(f) & {"jax", "jaxlib", "repro"}, f


@pytest.mark.parametrize("name,argv", [
    ("quickstart_torch", []), ("serve_lm_torch", []),
    ("train_lm_torch", ["--tiny", "--steps", "1"]),
    ("dydd_assimilation_torch", ["--n", "64", "--m", "100", "--cycles", "1",
                                 "--scenarios", "drifting_swarm"])])
def test_examples_default_to_the_card(name, argv, tmp_path):
    """Without ``--device cpu`` each port example wants the card and
    raises before any work, naming the way out."""
    import importlib.util
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    spec = importlib.util.spec_from_file_location(
        f"_isolation_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if name == "train_lm_torch":
        argv = argv + ["--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_engine.AssimilationEngine(t_engine.EngineConfig())


def test_timepar_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_timepar.TimeParEngine(t_engine.EngineConfig(time_windows=4))


def test_rank_launch_defaults_to_the_card():
    """``runtime.mesh.launch`` puts its ranks on the card unless asked
    for the CPU, and raises before it spawns any."""
    from repro_torch.runtime import mesh as t_mesh
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_mesh.launch(print, 2, backend="gloo")


def test_fleet_server_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serving.FleetServer()


def test_restore_and_resume_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    eng = t_engine.AssimilationEngine(t_engine.EngineConfig(n=32, p=2),
                                      device="cpu")
    path = eng.save_checkpoint(str(tmp_path), step=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_engine.AssimilationEngine.restore(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_elastic.resume_assim_engine(path)
    back, _ = t_elastic.resume_assim_engine(path, device="cpu")
    assert back.device.type == "cpu"


def test_assim_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.assim", "--n", "64", "--m",
         "100", "--cycles", "2", "--time-windows", "4", "--scenarios",
         "drifting_swarm"], env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr


def test_lm_serving_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = t_configs.get_smoke_config("recurrentgemma-9b")
    reqs = [t_serve.Request(rid=0, prompt=np.arange(1, 9, dtype=np.int32),
                            max_new=2)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.serve_batch(cfg, t_transformer.init_params(cfg), reqs,
                            max_seq=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_transformer.init_decode_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_convert.lm_params_from_numpy({"embed": np.zeros((4, 2))})


def test_serving_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "recurrentgemma-9b", "--smoke", "--batch", "1", "--prompt-len",
         "8", "--max-new", "1"], env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr


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
    # the backward kernels' wrappers
    q = torch.zeros(2, 16, 16, dtype=torch.bfloat16)
    lse = torch.zeros(2, 16)
    a = torch.zeros(1, 4, 8)
    x, dt, A1 = torch.zeros(2, 16, 8), torch.zeros(2, 16), torch.zeros(2)
    B = torch.zeros(1, 16, 8)
    saved = (torch.zeros(2, 16, dtype=torch.float64),
             torch.zeros(1, 2, 8, 8), torch.zeros(2, 2, 8, 8))
    bwd_before = (t_fa.bwd_launches, t_rg.bwd_launches, t_ssd.bwd_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_fa.flash_attention_bwd(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_rg.rglru_scan_bwd(a, a, a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_ssd.ssd_scan_bwd(x, dt, A1, B, B, x, saved, chunk=8)
    # the f32 entry takes f32 on the card only, and one dtype throughout
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_fa.flash_attention_bwd(*(t.float() for t in (q, q, q, q)), lse,
                                 q.float())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_fa.flash_attention_bwd(*(t.half() for t in (q, q, q, q)), lse,
                                 q.half())
    with pytest.raises(TypeError, match="expected torch.float32"):
        t_fa.flash_attention_bwd(q.float(), q, q, q, lse, q)
    assert (t_fa.bwd_launches, t_rg.bwd_launches,
            t_ssd.bwd_launches) == bwd_before
    assert (t_gram.launches, t_sch.fwd_launches,
            t_sch.bwd_launches) == before


def test_training_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = t_configs.get_smoke_config("mamba2-1.3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.train(cfg, steps=1, seq=16, global_batch=2, dp=2,
                      ckpt_dir=None)


@pytest.mark.parametrize("arch,dtype,device,refused", [
    ("recurrentgemma-9b", torch.float32, "cuda", False),
    ("recurrentgemma-9b", torch.bfloat16, "cuda", False),
    ("recurrentgemma-9b", torch.float32, "cpu", False),
    ("mamba2-1.3b", torch.float32, "cuda", False),
    ("mamba2-1.3b", torch.bfloat16, "cuda", False),
    ("recurrentgemma-9b", torch.float16, "cpu", False),
    ("recurrentgemma-9b", torch.float16, "cuda", True),
    ("recurrentgemma-9b", torch.float64, "cuda", True),
    ("mamba2-1.3b", torch.float16, "cuda", True),
])
def test_training_refuses_f32_attention_on_the_card(arch, dtype, device,
                                                    refused):
    # What check_trainable accepts and refuses before a step runs.  The
    # name is the refusal this case table once pinned, when the
    # flash_attention backward kernel took bf16 only; it has an f32 entry
    # now, so f32 and bf16 train on the card with or without attention
    # layers, and only a dtype that no kernel takes is refused there,
    # naming the kernels.  The CPU runs the plain versions in any dtype.
    cfg = t_configs.get_smoke_config(arch)
    if refused:
        kernels = ("ssd_scan" if cfg.attention_free
                   else "flash_attention and rglru_scan")
        with pytest.raises(TypeError, match=f"the {kernels} kernels"):
            t_steps.check_trainable(cfg, dtype, torch.device(device))
    else:
        t_steps.check_trainable(cfg, dtype, torch.device(device))


def test_training_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "recurrentgemma-9b", "--smoke", "--steps", "1", "--seq", "16",
         "--batch", "2", "--dp", "2"], env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
