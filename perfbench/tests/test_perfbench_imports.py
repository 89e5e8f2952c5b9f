"""A run loads neither JAX nor the JAX package, finds its card or fails,
and needs the program beside it."""
import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import perfbench_tiny

ROOT = perfbench_tiny.ROOT
PB = ROOT / "perfbench"

_DRIVE = """
import json, sys
sys.path[:0] = [{tests!r}]
import perfbench_tiny
from perfbench import run
for name in ("paper_5k.bulk_q64", "prod_5m_shard4.serve_top10"):
    c = perfbench_tiny.tiny(name, docs=80, vocab=512, dim=8, pool=64)
    run.run_cell(c, seed=3, seconds=0.5, trace=True, device="cpu")
print(json.dumps(run.forbidden_modules()))
"""


def _tops(path: pathlib.Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add((node.module or "").split(".")[0])
    return tops


def test_no_source_under_perfbench_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        bad = _tops(path) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, (path, bad)


def test_a_run_loads_no_jax_module():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _DRIVE.format(tests=str(PB / "tests"))],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_whole_top_level_names():
    from perfbench import run
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_x"] = sys
        sys.modules["jaxtyping_like"] = sys
        assert run.forbidden_modules() == sorted(
            m for m in saved if m.split(".")[0] in run.FORBIDDEN)
        sys.modules["repro.core"] = sys
        assert "repro.core" in run.forbidden_modules()
    finally:
        for k in ("repro_torch_x", "jaxtyping_like", "repro.core"):
            sys.modules.pop(k, None)


def _run_cli(cwd, env):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "paper_5k.bulk_q64", "--seed", str(2 ** 31 + 9), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=cwd, env=env,
        timeout=300)


def test_without_a_card_it_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run_cli(ROOT, env)
    assert out.returncode == 2
    assert out.stdout.strip() == ""


def test_without_the_program_it_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = _run_cli(tmp_path, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
