"""The port stands alone: no JAX, nothing of ``repro``, CUDA by default.

* A subprocess that cannot import ``jax`` or any ``repro`` module imports
  every ``repro_torch`` module and ``chip_smoke.py``.
* An AST scan of the port and of ``chip_smoke.py`` finds no such import.
* Without a CUDA card, the entry points refuse to run unless the caller
  passes ``device="cpu"``.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PORT.rglob("*.py"))

_CHILD = r"""
import importlib, importlib.abc, sys
sys.modules["jax"] = None

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "repro" or name.startswith("repro."):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
for mod in sys.argv[2:]:
    importlib.import_module(mod)
assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules)
assert sys.modules.get("jax") is None
print("ok", len(sys.argv) - 2)
"""


def test_imports_without_jax_or_reference():
    mods = MODULES + ["chip_smoke"]
    out = subprocess.run([sys.executable, "-c", _CHILD, str(ROOT), *mods],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", str(len(mods))]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_entry_points_default_to_cuda():
    from repro_torch.configs import get_arch
    from repro_torch.core.lsh import LSH, LSHParams, get_lsh
    from repro_torch.core.reuse_store import ReuseStore
    from repro_torch.device import resolve_device
    from repro_torch.models import DecoderLM, build_model
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    from repro_torch.serving import AsyncServingEngine, ServingFleet
    from repro_torch.serving.engine import ReplicaEngine, ReuseRouter

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    p = LSHParams(dim=8, num_tables=2)
    cfg = get_arch("qwen3-1.7b").reduced()
    cpu_replicas = [ReplicaEngine(0, p, list, device="cpu")]
    for make in (lambda: ReuseStore(p), lambda: LSH(p), lambda: get_lsh(p),
                 lambda: ReplicaEngine(0, p, list), lambda: ReuseRouter(p, 2),
                 lambda: resolve_device("cuda"), lambda: build_model(cfg),
                 lambda: DecoderLM(cfg), lambda: AsyncServingEngine(p, cpu_replicas),
                 lambda: ServingFleet(p, cpu_replicas), lambda: serve_main(["--requests", "1"]),
                 lambda: train_main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1"]),
                 lambda: make_host_mesh(), lambda: make_production_mesh()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert ReuseStore(p, device="cpu").device.type == "cpu"
    assert build_model(cfg, device="cpu").embed.device.type == "cpu"
    assert AsyncServingEngine(p, cpu_replicas, device="cpu").router.lsh.device.type == "cpu"


LAYOUT_MODULES = ("repro_torch.models.partitioning", "repro_torch.models.blocked_attention",
                  "repro_torch.launch.mesh", "repro_torch.launch.shardings")


@pytest.mark.parametrize("mod", LAYOUT_MODULES)
def test_layout_modules_are_checked(mod):
    """The parallel layout's modules are among those the checks above import
    and scan, and import without touching a device or a process group."""
    import importlib

    import torch.distributed as dist

    assert mod in MODULES
    started = dist.is_available() and dist.is_initialized()
    importlib.import_module(mod)
    assert (dist.is_available() and dist.is_initialized()) == started
