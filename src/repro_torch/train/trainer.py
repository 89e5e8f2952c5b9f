"""Fault-tolerant training loop: checkpoint/restart, straggler accounting.

Port of `repro.train.trainer`. The loop is deliberately boring -- that is
the point of fault tolerance:
  * deterministic data indexed by global step (restart-safe),
  * async checkpoint every ``ckpt_every`` steps, atomic on disk,
  * automatic resume from the latest checkpoint (``restore_or_init``; the
    restore target's structure comes from a ``meta``-device init, so no
    full-size state is made to be thrown away),
  * a failure-injection hook used by the integration tests to prove the
    restart path end-to-end (simulated node failure mid-run; once per
    process, through the ``REPRO_FAILED_ONCE`` environment variable, as the
    reference's),
  * per-step wall-time tracking with a straggler monitor (steps slower than
    ``straggler_factor`` x median are counted and logged).

``mesh`` is a `launch.mesh.Mesh` of the port: the state is placed by
`train.step.state_shardings` (restored onto it whatever mesh wrote the
checkpoint), each batch by `partitioning.batch_shardings`, and the step
runs inside ``activation_sharding(mesh)``. The checkpoints hold logical
tensors and record the mesh's signature.
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed import partitioning
from repro_torch.models.registry import ModelAPI
from repro_torch.models.sharding_hints import activation_sharding
from repro_torch.optim import AdamW
from repro_torch.train import step as train_step_mod


class Trainer:
    def __init__(self, model: ModelAPI, optimizer: AdamW, mesh,
                 pipeline: TokenPipeline, *, ckpt_dir: str,
                 microbatches: int = 1, grad_compression: bool = False,
                 ckpt_every: int = 50, straggler_factor: float = 2.0,
                 log_fn: Callable[[str], None] = print):
        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh
        self.pipeline = pipeline
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.log = log_fn
        self.grad_compression = grad_compression
        self.step_fn = train_step_mod.build_train_step(
            model, optimizer, mesh, microbatches=microbatches,
            grad_compression=grad_compression)
        self.async_ckpt = ckpt.AsyncCheckpointer(ckpt_dir)
        self.step_times: list[float] = []
        self.stragglers = 0

    # -- state ------------------------------------------------------------
    def _mesh_signature(self) -> str:
        return "x".join(f"{n}={s}" for n, s in
                        zip(self.mesh.axis_names, self.mesh.devices.shape))

    def restore_or_init(self, key) -> tuple[Any, int]:
        state_struct = train_step_mod.state_struct(
            self.model, self.optimizer,
            grad_compression=self.grad_compression)
        shardings = train_step_mod.state_shardings(self.mesh, state_struct)
        last = ckpt.latest_step(self.ckpt_dir)
        if last is not None:
            self.log(f"[trainer] restoring step {last} from {self.ckpt_dir}")
            state = ckpt.restore(self.ckpt_dir, last, state_struct,
                                 shardings=shardings)
            return state, last
        state = train_step_mod.init_state(
            self.model, self.optimizer, key,
            grad_compression=self.grad_compression)
        return train_step_mod.place(state, shardings), 0

    # -- loop ---------------------------------------------------------------
    def run(self, key, num_steps: int, *,
            fail_at: Optional[int] = None) -> dict:
        """Train to ``num_steps`` global steps (resuming if checkpoints
        exist). ``fail_at`` raises a simulated failure at that step once."""
        state, start = self.restore_or_init(key)
        metrics_hist = []
        for step_idx in range(start, num_steps):
            if fail_at is not None and step_idx == fail_at \
                    and not os.environ.get("REPRO_FAILED_ONCE"):
                os.environ["REPRO_FAILED_ONCE"] = "1"
                raise RuntimeError(f"injected node failure at step {step_idx}")
            host_batch = self.pipeline.batch_at(step_idx)
            batch = train_step_mod.place(
                host_batch,
                partitioning.batch_shardings(self.mesh, host_batch))
            t0 = time.perf_counter()
            with activation_sharding(self.mesh):
                state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self._track_straggler(dt)
            metrics_hist.append({"step": step_idx, "loss": loss,
                                 "sec": dt})
            if (step_idx + 1) % self.ckpt_every == 0 \
                    or step_idx + 1 == num_steps:
                self.async_ckpt.save(step_idx + 1, state,
                                     mesh_signature=self._mesh_signature())
                self.log(f"[trainer] step {step_idx + 1} "
                         f"loss={loss:.4f} ckpt queued")
        self.async_ckpt.wait()
        return {"history": metrics_hist, "stragglers": self.stragglers,
                "final_state": state}

    def _track_straggler(self, dt: float) -> None:
        self.step_times.append(dt)
        if len(self.step_times) >= 8:
            med = float(np.median(self.step_times[-50:]))
            if dt > self.straggler_factor * med:
                self.stragglers += 1
                self.log(f"[trainer] straggler step: {dt:.3f}s "
                         f"(median {med:.3f}s)")
