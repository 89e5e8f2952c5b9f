"""The port stands alone: no module of `repro_torch` (nor `chip_smoke.py`,
nor the port's examples `examples/torch_*.py`) imports jax or anything of
the JAX package `repro`."""
import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES


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


_BLOCKER = textwrap.dedent("""
    import importlib, importlib.abc, importlib.util, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
""")
_NO_LEAK = textwrap.dedent("""
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not leaked, leaked
    print("OK")
""")


def _run_blocked(body: str) -> None:
    """Run ``body`` in a fresh interpreter whose import system refuses
    ``jax``, ``jax.*``, ``repro`` and ``repro.*`` (exactly those:
    ``repro_torch`` must pass); fail if it raises or leaves one of them
    loaded."""
    code = _BLOCKER + textwrap.dedent(body) + _NO_LEAK
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_every_module_imports_with_jax_and_repro_blocked():
    """Import every module with the JAX package blocked (`_run_blocked`)."""
    mods = [_module_name(p) for p in sorted(PKG.rglob("*.py"))]
    _run_blocked(f"""
        for m in {mods!r}:
            importlib.import_module(m)
    """)


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_every_example_loads_with_jax_and_repro_blocked(path):
    """Each port example loads (its imports run, its `main` does not) with
    the JAX package blocked (`_run_blocked`)."""
    _run_blocked(f"""
        spec = importlib.util.spec_from_file_location("example",
                                                      {str(path)!r})
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.main)
    """)


def test_examples_are_found():
    """The port's four examples are among the checked sources."""
    assert [p.name for p in EXAMPLES] == [
        "torch_doc_retrieval.py", "torch_quickstart.py",
        "torch_train_moe_sinkhorn.py", "torch_wmd_query_service.py"]


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
