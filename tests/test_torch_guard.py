"""Guards of the port's boundary: it imports nothing of JAX or of the
reference package, and its entry points run on the GPU unless told
otherwise."""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("*.py")))
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports_in_source(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path.name} imports {hits}"


_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"imported": len(names), "bad": bad}))
"""


def test_importing_the_port_loads_no_jax_or_reference_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["imported"] >= 20 and out["bad"] == []


def test_entry_points_default_to_the_gpu():
    """Where there is no GPU, the default device raises instead of falling
    back to the CPU; where there is one, it is used."""
    from repro_torch.configs import get_config
    from repro_torch.core.profiler import Elana
    from repro_torch.models.model import Model

    cfg = get_config("llama3.2-1b", smoke=True)
    if torch.cuda.is_available():
        assert Elana("llama3.2-1b").device.type == "cuda"
        assert Model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no GPU"):
            Elana("llama3.2-1b")
        with pytest.raises(RuntimeError, match="no GPU"):
            Model(cfg)
    assert Elana("llama3.2-1b", device="cpu").device.type == "cpu"


def test_serving_entry_points_default_to_the_gpu():
    """``ServingEngine`` and ``launch.serve`` take ``cuda`` unless told
    otherwise, and raise where there is no GPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("tinyllama-1.1b", smoke=True)
    model = model_lib.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert ServingEngine(model, device="cpu").device.type == "cpu"
    assert serve.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            ServingEngine(model)
        with pytest.raises(RuntimeError, match="no GPU"):
            serve.main(["--smoke", "--arch", "tinyllama-1.1b"])
