"""The port stands alone: no module of `repro_torch` (nor `chip_smoke.py`)
imports jax or anything of the JAX package `repro`."""
import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _module_name(path: pathlib.Path) -> str:
    rel = path.relative_to(ROOT / "src").with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_banned_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _banned(n)]
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_every_module_imports_with_jax_and_repro_blocked():
    """Import every module in a fresh interpreter whose import system
    refuses ``jax``, ``jax.*``, ``repro`` and ``repro.*`` (exactly those:
    ``repro_torch`` must pass)."""
    mods = [_module_name(p) for p in sorted(PKG.rglob("*.py"))]
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        for m in {mods!r}:
            importlib.import_module(m)
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not leaked, leaked
        print("OK", len({mods!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_blocker_is_exact():
    """The blocker's rule refuses the JAX package but not the port."""
    assert _banned("repro") and _banned("repro.core.formats")
    assert _banned("jax") and _banned("jax.numpy")
    assert not _banned("repro_torch") and not _banned("repro_torch.core")


def test_sources_cover_every_subpackage():
    """The checks above walk every module of the port, the training
    substrate's subpackages and modules among them."""
    mods = {_module_name(p) for p in SOURCES if PKG in p.parents}
    for name in ("repro_torch.optim.adamw", "repro_torch.optim.compression",
                 "repro_torch.optim.schedules",
                 "repro_torch.checkpoint.checkpointer",
                 "repro_torch.distributed.partitioning",
                 "repro_torch.train.step", "repro_torch.train.trainer",
                 "repro_torch.launch.train", "repro_torch._tree"):
        assert name in mods, name
