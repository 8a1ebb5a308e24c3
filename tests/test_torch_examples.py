"""The port's examples (``examples/torch/``) on the CPU: ``quickstart`` and
``chiles_pipeline`` give the reference examples' results in the same
process (the CHILES cube bit for bit, its source in band 2), and
``serve_batch`` and ``train_lm`` run with ``--device cpu``."""
import importlib.util
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main_reading(monkeypatch, mod, drop: str):
    """``mod.main()``, with the value of the drop ``drop`` read from the
    session of the example's pipeline as it closes."""
    got = []

    class Reading(mod.Pipeline):
        def __exit__(self, *exc):
            got.append(self.session.drops[drop].read())
            return super().__exit__(*exc)

    monkeypatch.setattr(mod, "Pipeline", Reading)
    mod.main()
    assert len(got) == 1
    return got[0]


@pytest.mark.parametrize("example, drop", [("quickstart", "result"),
                                           ("chiles_pipeline", "final")])
def test_example_gives_the_reference_result(monkeypatch, example, drop):
    ref = load(ROOT / "examples" / f"{example}.py", f"ref_{example}")
    port = load(ROOT / "examples" / "torch" / f"{example}.py",
                f"port_{example}")
    assert port.register_app.__module__.startswith("repro_torch.")
    want = run_main_reading(monkeypatch, ref, drop)
    got = run_main_reading(monkeypatch, port, drop)
    if example == "quickstart":
        assert got == want == sum(i * i for i in range(8))
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
        assert got.max(axis=(1, 2)).argmax() == 2


def run_script(monkeypatch, name: str, *args: str) -> None:
    monkeypatch.setattr(sys, "argv", [name, *args])
    runpy.run_path(str(ROOT / "examples" / "torch" / name),
                   run_name="__main__")


def test_serve_batch_runs_on_the_cpu(monkeypatch, capsys):
    run_script(monkeypatch, "serve_batch.py", "--device", "cpu")
    assert "[example] OK" in capsys.readouterr().out


def test_train_lm_runs_on_the_cpu(monkeypatch, capsys, tmp_path):
    # the example asserts that the loss falls; tiny needs more than the
    # first 8 steps of its schedule for that (6.029 -> 6.098 at 8 steps,
    # -> 5.882 at 24)
    run_script(monkeypatch, "train_lm.py", "--device", "cpu", "--preset",
               "tiny", "--steps", "24", "--ckpt-dir", str(tmp_path / "ckpt"))
    assert "[example] OK" in capsys.readouterr().out
    assert any((tmp_path / "ckpt").iterdir())
