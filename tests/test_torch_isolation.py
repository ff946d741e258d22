"""The port stands alone: no jax, no ``repro`` module, no quiet CPU fallback.

``repro_torch`` and ``chip_smoke.py`` must import neither jax nor anything
of the reference package ``repro`` (the parity tests are the only place the
two meet), and an entry point called without ``device=`` must not carry on
on the CPU when there is no card.
"""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.graph import Graph
from repro_torch.device import resolve
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import Engine, ServeConfig

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_MODULES = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))

# `import jax...`, `from jax...`, `import repro`, `from repro...` where the
# module is the reference (repro or repro.x), not repro_torch
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax\b|repro(\.|\s|$))", re.MULTILINE)


def test_port_modules_import_no_jax_and_no_reference():
    code = (
        "import sys\n"
        f"for name in {PORT_MODULES!r}:\n"
        "    __import__(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(PORT_MODULES) >= 27


def test_no_source_file_names_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"
    assert _FORBIDDEN.search("from repro.core import engine")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from repro_torch.core import engine")


def test_no_device_means_the_card_or_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve()
    with pytest.raises(RuntimeError):
        Graph.from_edges(np.asarray([0], np.int32), np.asarray([1], np.int32))
    g = Graph.from_edges(np.asarray([0], np.int32), np.asarray([1], np.int32),
                         device="cpu")
    assert g.device.type == "cpu" and resolve("cpu") == torch.device("cpu")


def test_model_and_engine_without_device_need_the_card(monkeypatch):
    cfg = reduced(get_config("qwen2.5-3b"))
    model = Transformer.init_params(cfg, device="cpu")
    arrays = model.to_arrays()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer.from_arrays(cfg, arrays)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, model, ServeConfig())
    eng = Engine(cfg, model, ServeConfig(batch=1, max_seq=8), device="cpu")
    assert len(eng.generate([[1, 2]], max_new_tokens=2)[0]) == 4


def test_chip_smoke_fails_without_a_card_or_the_repository(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
