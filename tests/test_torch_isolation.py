"""The port stands alone: it and its examples (``examples/torch/``) import
neither JAX nor the JAX package, and its engine, data pipeline and config
files are verbatim copies of the JAX package's."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
COPIED = ([f"core/{p.name}" for p in sorted((SRC / "repro" / "core")
                                            .glob("*.py"))]
          + ["dsl.py"]
          + [f"data/{p.name}" for p in sorted((SRC / "repro" / "data")
                                              .glob("*.py"))]
          + [f"configs/{p.name}" for p in sorted((PORT / "configs")
                                                 .glob("*.py"))
             if p.name != "__init__.py"])

_PROBE = r"""
import importlib, importlib.util, json, pathlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
for p in sorted(pathlib.Path("examples/torch").glob("*.py")):
    spec = importlib.util.spec_from_file_location("example_" + p.stem, p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(str(p))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": len(names), "bad": bad}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_importing_every_module_loads_no_jax_and_no_repro():
    out = subprocess.run([sys.executable, "-c", _PROBE], env=_env(),
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    seen = json.loads(out.stdout.splitlines()[-1])
    assert seen["modules"] >= 20
    assert seen["bad"] == [], f"port imported {seen['bad']}"


_IMPORT = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b)",
                     re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PORT.rglob("*.py"))
    + list((ROOT / "examples" / "torch").rglob("*.py"))
    + [ROOT / "chip_smoke.py"]))
def test_no_absolute_import_of_jax_or_repro(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT.search(text), path


@pytest.mark.parametrize("rel", COPIED)
def test_copied_file_is_byte_identical(rel):
    assert (PORT / rel).read_bytes() == (SRC / "repro" / rel).read_bytes()


def test_core_copy_is_complete():
    assert sorted(p.name for p in (PORT / "core").glob("*.py")) == \
        sorted(p.name for p in (SRC / "repro" / "core").glob("*.py"))


def test_port_has_its_own_app_registry():
    from repro.core import managers as jax_managers
    from repro_torch.core import managers as port_managers
    assert port_managers._APP_REGISTRY is not jax_managers._APP_REGISTRY


def test_chip_smoke_without_cuda_exits_nonzero_with_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for script in (ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py"):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=300,
                             cwd=str(script.parent))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
