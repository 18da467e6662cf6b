"""Fault-tolerant training supervisor and elastic mesh planning, the port of
``repro/runtime/fault_tolerance.py``.

Supervisor: periodic asynchronous checkpoints (through the staging path),
restart from the last committed checkpoint on a step failure (bounded
restarts), failure injection for tests and examples. Where the reference
catches ``jax.errors.JaxRuntimeError``, the port catches the CUDA runtime's
error type (``torch.AcceleratorError``) and the injected failure, never a
bare ``RuntimeError``. A sticky CUDA error (an illegal address, a trap)
leaves the process's CUDA context unusable, so restoring in the same
process cannot recover from it: the restore itself fails and the error
reaches the caller; only a new process can resume from the checkpoint.

On a mesh each rank runs its own Supervisor over the same steps, with a
``CheckpointManager`` laid out for the mesh: saves are collective, and an
injected failure (the same ``fail_at`` on every rank) and its restore
happen on every rank at the same step, the checkpoint's ``wait`` a barrier
before the restore reads. A device error on one rank alone is not
recovered there: the other ranks wait in the next collective until gloo's
timeout.

``plan_mesh`` is the reference's, copied: it re-derives a (pod, data,
model) factorization from the healthy device count.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch.checkpoint.checkpointing import CheckpointManager

# the CUDA runtime's error type, where the installed torch has one
DEVICE_ERRORS: tuple[type[BaseException], ...] = tuple(
    t for t in (getattr(torch, "AcceleratorError", None),) if t is not None)


class InjectedFailure(RuntimeError):
    pass


class RestartBudgetExceeded(RuntimeError):
    """The supervisor burned through ``max_restarts``; carries enough to
    resume by hand (the last committed checkpoint step)."""

    def __init__(self, restarts: int, max_restarts: int,
                 last_checkpoint_step: Optional[int], cause: BaseException):
        self.restarts = restarts
        self.max_restarts = max_restarts
        self.last_checkpoint_step = last_checkpoint_step
        at = ("no checkpoint committed" if last_checkpoint_step is None
              else f"last checkpoint at step {last_checkpoint_step}")
        super().__init__(
            f"supervisor exceeded max_restarts={max_restarts} "
            f"({restarts} restarts; {at}): {cause}")


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_every: int = 50
    max_restarts: int = 3


class Supervisor:
    def __init__(self, step_fn: Callable, ckpt: CheckpointManager,
                 cfg: SupervisorConfig = SupervisorConfig()):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.cfg = cfg
        self.restarts = 0
        self.metrics_log: list[dict] = []

    def run(self, state: Any, batches: Iterator[dict], n_steps: int,
            abstract_state: Any = None, device: str | torch.device = "cuda",
            fail_at: Optional[set[int]] = None) -> Any:
        """Runs n_steps; on failure restores the last committed checkpoint
        onto ``device`` in the layout of ``abstract_state`` and continues.
        fail_at injects failures (tests/examples)."""
        step_idx = int(state["step"]) \
            if isinstance(state, dict) and "step" in state else 0
        while step_idx < n_steps:
            batch = next(batches)
            try:
                if fail_at and step_idx in fail_at:
                    fail_at.discard(step_idx)
                    raise InjectedFailure(f"injected at step {step_idx}")
                state, metrics, egress = self.step_fn(state, batch)
                step_idx += 1
            except (InjectedFailure, *DEVICE_ERRORS) as e:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RestartBudgetExceeded(
                        self.restarts, self.cfg.max_restarts,
                        self.ckpt.latest_step(), e) from e
                self.ckpt.wait()
                if abstract_state is None:
                    raise RuntimeError("no abstract_state for restore") from e
                state = self.ckpt.restore(abstract_state, device=device)
                step_idx = int(state["step"])
                continue
            if step_idx % self.cfg.ckpt_every == 0:
                self.ckpt.save(state, step_idx)
            self.metrics_log.append(
                {k: float(v) for k, v in metrics.items()
                 if isinstance(v, torch.Tensor) and v.dim() == 0})
        self.ckpt.save(state, step_idx)
        self.ckpt.wait()
        return state


# ---------------------------------------------------------------------------
# Elastic mesh planning
# ---------------------------------------------------------------------------


def plan_mesh(n_devices: int, *, model_parallel: int = 16,
              pod_size: int = 256) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Largest coherent (pod, data, model) mesh for the surviving devices.

    model_parallel is fixed by the model's sharding (must divide n);
    whole pods are preferred; a degraded partial pod falls back to a
    single-pod mesh of the remaining chips.
    """
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"model_parallel={model_parallel}")
    n_pods = n_devices // pod_size
    if n_pods >= 2 and n_devices % pod_size == 0:
        return ((n_pods, pod_size // model_parallel, model_parallel),
                ("pod", "data", "model"))
    return ((n_devices // model_parallel, model_parallel),
            ("data", "model"))
