"""The harness loads neither JAX nor the JAX package, and its reference
nothing of the program; names are compared whole, so the port
(``fedmlp_tpu_torch``) is no JAX package."""

import json
import subprocess
import sys

from fedbench import run
from fedbench.cell import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fedmlp_tpu")


def _loaded(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, check=True)
    return json.loads(out.stdout.splitlines()[-1])


def test_the_harness_loads_no_jax():
    mods = _loaded("import fedbench.run, fedbench.harness, fedbench.calibrate\n"
                   "import fedmlp_tpu_torch.train")
    assert "fedmlp_tpu_torch" in mods
    assert [m for m in mods if m.split(".")[0] in FORBIDDEN] == []


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("import fedbench.reference.fedmlp, fedbench.reference.views\n"
                   "import fedbench.reference.models.efficient_b0\n"
                   "import fedbench.reference.models.resnet18")
    assert [m for m in mods if m.split(".")[0] in FORBIDDEN + ("fedmlp_tpu_torch",)] == []


def test_the_run_names_what_it_finds(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "fedmlp_tpu_torch_like", object())
    assert run.forbidden_modules() == ["jaxlib.xla_client"]
