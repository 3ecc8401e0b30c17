"""The port's examples (``examples/*_torch.py``) on the CPU, against the
reference's examples where they share host logic.

Each example's ``main`` runs in-process with ``--device cpu`` at its CI
flags:

* ``quickstart_torch``: the static loads, the DyDD loads, rounds and
  observations moved print the same lines as ``examples/quickstart.py``
  (numpy host logic, bitwise), and error_DD-DA < 1e-8;
* ``serve_lm_torch``: the request plan (numpy, seed 0) prints the same
  line as ``examples/serve_lm.py``'s, and every request gets its
  ``max_new`` tokens;
* ``train_lm_torch --tiny --steps 20``: the loss falls, and a second run
  with the same ``--ckpt-dir`` resumes from step 20;
* ``dydd_assimilation_torch`` at ``--n 64 --m 150 --p 4 --cycles 6
  --iters 80 --scenarios drifting_swarm``: each cycle's imbalances, E,
  repartition and migrated observations print as the reference
  example's table does (bitwise), and every err_DD-DA < 1e-10.

The reference examples run only as far as the lines compared: the
quickstart stops before its solve and serve_lm before its decode (a
stand-in raises where each would start).
"""
import importlib.util
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Stop(Exception):
    """Raised by a stand-in where a reference example's remaining work
    would start."""


def _stop(*args, **kwargs):
    raise _Stop


def _lines(text: str, *prefixes) -> list:
    return [line for line in text.splitlines()
            if line.startswith(prefixes)]


def test_quickstart_prints_the_references_loads_and_solves(capsys,
                                                           monkeypatch):
    ref = _load("quickstart")
    monkeypatch.setattr(ref.dd, "decompose_1d", _stop)
    with pytest.raises(_Stop):
        ref.main()
    want = _lines(capsys.readouterr().out, "static DD loads:", "after DyDD:")
    assert len(want) == 2
    err = _load("quickstart_torch").main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert _lines(got, "static DD loads:", "after DyDD:") == want
    assert err < 1e-8 and "error_DD-DA" in got


def test_serve_lm_plans_the_references_requests(capsys, monkeypatch):
    ref = _load("serve_lm")
    monkeypatch.setattr(ref, "serve_batch", _stop)
    monkeypatch.setattr(sys, "argv", ["serve_lm.py"])
    with pytest.raises(_Stop):
        ref.main()
    want = _lines(capsys.readouterr().out, "4 requests")
    assert len(want) == 1
    reqs = _load("serve_lm_torch").main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert _lines(got, "4 requests") == want
    assert len(reqs) == 4
    assert all(len(r.out) == r.max_new for r in reqs)


def test_train_lm_loss_falls_and_resumes(capsys, tmp_path):
    example = _load("train_lm_torch")
    flags = ["--tiny", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    losses = example.main(flags + ["--steps", "20"])
    assert len(losses) == 20 and losses[-1] < losses[0]
    assert "resumed" not in capsys.readouterr().out
    more = example.main(flags + ["--steps", "30"])
    assert "resumed from step 20" in capsys.readouterr().out
    assert len(more) == 10


DYDD_FLAGS = ["--n", "64", "--m", "150", "--p", "4", "--cycles", "6",
              "--iters", "80", "--scenarios", "drifting_swarm"]


def _table(text: str) -> list:
    """The cycle rows: (cycle, imb_in, imb_out, E, rep, moved) as printed,
    and err_DD-DA."""
    rows = []
    for line in text.splitlines():
        cols = line.split()
        if len(cols) == 8 and cols[0].isdigit():
            rows.append((tuple(cols[:6]), float(cols[7])))
    return rows


def test_dydd_assimilation_prints_the_references_table(capsys,
                                                       monkeypatch):
    monkeypatch.setattr(sys, "argv", ["dydd_assimilation.py"] + DYDD_FLAGS)
    _load("dydd_assimilation").main()
    want = _table(capsys.readouterr().out)
    assert len(want) == 6
    _load("dydd_assimilation_torch").main(DYDD_FLAGS + ["--device", "cpu"])
    got = _table(capsys.readouterr().out)
    assert [r for r, _ in got] == [r for r, _ in want]
    assert all(err < 1e-10 for _, err in got)
    assert any(r[4] == "yes" for r, _ in got)   # DyDD repartitioned
