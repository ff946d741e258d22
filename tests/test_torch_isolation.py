"""The port stands alone: no jax, no ``repro`` module, no quiet CPU fallback.

``repro_torch`` and ``chip_smoke.py`` must import neither jax nor anything
of the reference package ``repro`` (the parity tests are the only place the
two meet), nor may a script that the port's ``export_script`` emits, since
the port executes that text; and an entry point called without ``device=``
must not carry on on the CPU when there is no card.
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
from repro_torch.core import algorithms as A
from repro_torch.core import provenance as P
from repro_torch.core import relational as R
from repro_torch.core.convert import table_from_map, to_graph
from repro_torch.core.graph import Graph
from repro_torch.core.table import INT, STR, Table
from repro_torch.device import resolve
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.graph_service import GraphService

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
    assert len(PORT_MODULES) >= 50
    for name in ("repro_torch.obs", "repro_torch.obs.report",
                 "repro_torch.serve.policy", "repro_torch.serve.scheduler",
                 "repro_torch.serve.graph_service", "repro_torch.serve.wire",
                 "repro_torch.serve.server", "repro_torch.serve.client",
                 "repro_torch.examples.stackoverflow_experts",
                 "repro_torch.examples.remote_analytics",
                 "repro_torch.configs.ringo_graph",
                 "repro_torch.launch.dryrun", "repro_torch.launch.hlo_cost",
                 "repro_torch.launch.ringo_cells",
                 "repro_torch.train.zero"):
        assert name in PORT_MODULES, name


def test_no_source_file_names_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"
    assert _FORBIDDEN.search("from repro.core import engine")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from repro_torch.core import engine")


def test_exported_script_imports_only_the_port():
    t = Table.from_columns({"a": INT, "b": INT, "tag": STR},
                           {"a": [0, 1, 2, 2], "b": [1, 2, 0, 3],
                            "tag": ["x", "y", "x", "x"]}, device="cpu")
    g = to_graph(R.select(t, "tag", "==", "x"), "a", "b")
    ranked = table_from_map(g, A.pagerank(g, n_iter=3), "node", "pr")
    for embed in (True, False):
        script = P.export_script(ranked, embed_roots=embed)
        assert "from repro_torch.core" in script
        hits = _FORBIDDEN.findall(script)
        assert not hits, f"exported script imports {hits}"
        assert "jax" not in script


def test_no_device_means_the_card_or_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve()
    with pytest.raises(RuntimeError):
        Graph.from_edges(np.asarray([0], np.int32), np.asarray([1], np.int32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Table.from_columns({"a": INT}, {"a": [1]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Table.empty({"a": INT})
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


def test_service_entry_points_without_device_need_the_card(monkeypatch):
    from repro_torch.examples import remote_analytics, stackoverflow_experts
    from repro_torch.obs import report
    from repro_torch.serve.client import RemoteService
    from repro_torch.serve.server import GraphServer
    svc = GraphService(device="cpu")
    assert svc.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (GraphService, GraphServer,
                 lambda: RemoteService(port=1),
                 lambda: stackoverflow_experts.main([]),
                 lambda: report.main(["--port", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    # the remote example spawns a server that exits with the same error
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(RuntimeError, match="exited early"):
        remote_analytics.main([])


def test_server_process_without_a_card_exits_non_zero():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.server", "--port", "0"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "RINGO-SERVE LISTENING" not in out.stdout
    assert "device='cpu'" in out.stderr
