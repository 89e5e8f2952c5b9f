"""Find a cell's pieces by name: its entry and metrics in BENCHMARK.json,
and the data files of its configuration, traffic mix and cell under
``perfbench/``. Nothing here names a cell, a mix or a metric: a later
change adds one by adding files and entries."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
# the axes a cell file's "mesh" may name: those of the service's meshes
# (`repro_torch.launch.mesh.make_mesh`; "pod" and "data" shard the docs,
# "model" the vocabulary)
MESH_AXES = (("data", "model"), ("pod", "data", "model"))


def _load_json(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    config: dict              # perfbench/configs/<config>.json
    traffic: dict             # perfbench/traffic/<traffic>.json
    spec: dict                # perfbench/workloads/<cell>.json
    chips: int
    end_to_end: list          # BENCHMARK.json metrics this cell reports
    per_layer: list

    @property
    def mesh(self) -> tuple[tuple[int, ...], tuple[str, ...]] | None:
        """(shape, axes) of the cell file's ``mesh``; None: one card, no
        mesh."""
        m = self.spec.get("mesh")
        return None if m is None else (tuple(m["shape"]), tuple(m["axes"]))


def _applies(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def check_mesh(name: str, spec: dict, chips: int) -> None:
    """Raise ValueError unless the cell file's optional ``mesh``
    (``{"shape": [D, S], "axes": ["data", "model"]}``, or with a leading
    "pod" axis) lays the service out on exactly its ``chips`` cards; a
    cell without one is a 1 x 1 layout on one card."""
    m = spec.get("mesh", {"shape": [1, 1], "axes": ["data", "model"]})
    shape, axes = (m.get("shape"), m.get("axes")) if isinstance(m, dict) \
        else (None, None)
    if not isinstance(axes, list) or tuple(axes) not in MESH_AXES:
        raise ValueError(f"{name}: mesh axes {axes!r} are none of "
                         f"{[list(a) for a in MESH_AXES]}")
    if not isinstance(shape, list) or len(shape) != len(axes) or not all(
            isinstance(n, int) and not isinstance(n, bool) and n >= 1
            for n in shape):
        raise ValueError(f"{name}: mesh shape {shape!r} is not one "
                         f"positive size an axis of {axes}")
    if math.prod(shape) != chips:
        raise ValueError(f"{name}: a mesh of shape {shape} has "
                         f"{math.prod(shape)} positions; BENCHMARK.json "
                         f"gives the cell {chips} chips")


def load(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    spec = _load_json("workloads", name)
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {spec[key]!r} in its cell "
                             f"file and {entry[key]!r} in BENCHMARK.json")
    check_mesh(name, spec, int(entry["chips"]))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, names)]
    return Cell(name=name, config=_load_json("configs", entry["config"]),
                traffic=_load_json("traffic", entry["traffic"]), spec=spec,
                chips=int(entry["chips"]), end_to_end=e2e,
                per_layer=per_layer)


def reader(metric: str):
    """The ``read`` function of perfbench/metrics/<metric>.py."""
    if not NAME.match(metric):
        raise ValueError(f"bad metric name {metric!r}")
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
