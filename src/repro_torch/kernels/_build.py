"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface (pointers and the
stream as ``void*``, sizes as ``int``, the launch's ``cudaGetLastError()``
as the return value), so the build includes no PyTorch header and takes
seconds. Libraries go to ``build/repro_torch/`` at the repository root,
named by a hash of the source and flags, so an edited source rebuilds and an
unchanged one is reused. Nothing is built at import: the first launch (or
`build`) compiles.

``--use_fast_math`` is deliberately absent: approximate division and
reciprocals would break the exact-zero contracts of the pad conventions
(``v = val / 1e-30`` times a zero K column must give exactly 0).

A launch takes its stream from `stream`, which first holds every tensor
operand to the current card (`check_devices`): with peer access on, a
kernel launched on one card with another card's pointers reads them over
the link between the cards, so its results come out right, only slowly,
and nothing but this check shows it.

``launches`` counts kernel launches by name; each wrapper adds one where it
launches its kernel and nowhere else, so a run can show which kernels its
main path went through. ``builds`` counts what `build` did: ``compiles``
(nvcc runs) and ``loads`` (libraries found in ``BUILD_DIR``, loaded
without a compile), each with its seconds (`serving.warmup.
measure_compiles` reads it). `set_build_dir` moves ``BUILD_DIR``
(`serving.warmup.enable_compilation_cache`, the launcher's
``--cache-dir``).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("sddmm_spmm", "kexp", "rwmd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: collections.Counter = collections.Counter()
builds = {"compiles": 0, "compile_s": 0.0, "loads": 0, "load_s": 0.0}
ptxas_log: dict[str, str] = {}       # name -> nvcc's -Xptxas -v report

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    launches.clear()


def build_counts() -> dict:
    """A snapshot of ``builds``."""
    with _lock:
        return dict(builds)


def set_build_dir(path) -> pathlib.Path:
    """Build and look up the libraries in ``path`` from now on (created if
    missing); libraries already loaded stay loaded."""
    global BUILD_DIR
    with _lock:
        BUILD_DIR = pathlib.Path(path)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        return BUILD_DIR


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built at first use and need the CUDA toolkit")


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source that is not built yet, one nvcc process
    per source, all started together; load the libraries. Returns the
    seconds each compile took (0.0 for a library already built)."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            if name in _libs:
                continue
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True),
                           tmp, out, time.perf_counter())
        seconds = {name: 0.0 for name in names}
        failed = []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            ptxas_log[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
        for name in names:
            if name not in _libs:
                t0 = time.perf_counter()
                _libs[name] = ctypes.CDLL(str(_target(name)))
                if name in procs:
                    builds["compiles"] += 1
                    builds["compile_s"] += seconds[name]
                else:
                    builds["loads"] += 1
                    builds["load_s"] += time.perf_counter() - t0
        return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = _libs[name]
    return lib


def function(source: str, name: str, argtypes: list):
    """The C entry point ``name`` of ``csrc/<source>.cu`` with its argument
    types set (once: a launch then pays only for the call) and an int
    return value (the launch's cudaError)."""
    fn = _fns.get((source, name))
    if fn is None:
        fn = getattr(library(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(source, name)] = fn
    return fn


def check_devices(name: str, devices, current: int) -> None:
    """Raise unless each of ``devices`` (one an operand of a launch of
    ``name``, in argument order) is card ``current``."""
    off = [f"operand {i} on cuda:{d.index}" for i, d in enumerate(devices)
           if d.index != current]
    if off:
        raise RuntimeError(f"CUDA kernel {name} launched on cuda:{current} "
                           f"with {', '.join(off)}: make the operands' card "
                           f"current first (launch.mesh.on_device)")


def stream(name: str, *tensors) -> int:
    """The current CUDA stream's handle for a launch of ``name`` on
    ``tensors``, once `check_devices` holds them to the current card."""
    import torch
    check_devices(name, [t.device for t in tensors],
                  torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream


def check_launch(name: str, err: int) -> None:
    """Raise if the C launcher reported a CUDA error; else count the launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    launches[name] += 1
