"""Fault-tolerant training controller (``repro.runtime.fault_tolerance``).

What it does for a run on one card, as for the JAX package's SPMD job:

  1. Every step is a deterministic function of (params, opt_state,
     step_idx): batches come from the deterministic pipeline
     (``data/pipeline.py``), so a restarted run regenerates the batch of
     any step.
  2. Periodic atomic checkpoints (``ckpt/checkpoint.py``) and
     resume-from-latest: a failed run restarts, reloads step N and replays
     from N+1 with identical batches.  With a model config the state is
     kept in the JAX package's stored training form (readable by either
     package); without one (toy states) as the tree it is.
  3. Step retry with bounded attempts for transient faults, on the shared
     retry policy (``runtime/retry.py``) that the serving engine's step
     guard also runs.
  4. Anomaly guard: a non-finite loss skips the update (params and
     opt_state are kept) and the run goes on with the next batch.

The port's step updates its state in place, so it checks the loss before
it writes: on a non-finite loss it returns the state untouched
(``train/step.py``), and the guard here only counts and logs the skip.

On a grid of PE processes (``grid=``, a
:class:`~repro_torch.core.pe_grid.PeGrid`) every PE runs the controller
on its own blocks.  A checkpoint is the collective
``ckpt.save_grid_state`` (every PE writes its blocks, PE 0 commits, no PE
goes on before the commit); a resume reads each PE's blocks of the latest
step, which every PE takes from PE 0 (``ckpt.restore_grid_state``).  The
retry and skip rules decide alike on every PE (the fault injector is a
function of the step, and every PE sees the same loss bits), and each PE
meets the others at a barrier tagged with what it decided: a PE that
decided otherwise raises ``CollectiveMismatch`` instead of waiting in
another collective.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.runtime.retry import RetryPolicy, retry_with_backoff

log = logging.getLogger("repro_torch.runtime")
# src/repro_torch/runtime/fault_tolerance.py -> the checkout's build/
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build"
                       / "train_ckpt")


@dataclasses.dataclass
class FaultConfig:
    ckpt_dir: str = DEFAULT_CKPT_DIR
    ckpt_every: int = 50
    keep: int = 3
    max_retries: int = 3
    backoff_s: float = 0.01
    fail_injector: Optional[Callable[[int], None]] = None   # tests, drills
    skip_nonfinite: bool = True

    @property
    def retry_policy(self) -> RetryPolicy:
        """The shared bounded-retry policy (``repro_torch.runtime.retry``);
        the serving engine's step guard consumes the same class."""
        return RetryPolicy(max_retries=self.max_retries,
                           backoff_s=self.backoff_s)


class TrainController:
    """Drives ``step_fn`` over the deterministic data pipeline with
    checkpoint / restart / retry semantics.  ``cfg`` (a model config)
    keeps checkpoints in the JAX stored training form; ``device`` is where
    a resumed state is placed.  With ``grid`` the controller runs on one
    PE of a grid of PE processes, its state that PE's blocks in
    ``storage`` (module docstring).  ``fcfg.ckpt_dir`` None: no
    checkpoints.  On a grid ``saves`` lists each checkpoint written
    (step, directory, bytes, seconds); ``restored`` is the one resumed
    from (step, seconds)."""

    def __init__(self, step_fn, make_batch_fn, fcfg: FaultConfig,
                 cfg=None, device=None, grid=None, storage=None):
        self.step_fn = step_fn
        self.make_batch = make_batch_fn        # (step) -> device batch
        self.fcfg = fcfg
        self.cfg = cfg
        self.device = device
        self.grid = grid if grid is not None and not grid.local else None
        self.storage = storage
        self.metrics_log: list = []
        self.retries = 0
        self.skipped = 0
        self.saves: list = []
        self.restored: Optional[dict] = None

    def _agree(self, what: str) -> None:
        """Meet every PE at a barrier tagged ``what`` (on a grid)."""
        if self.grid is not None:
            self.grid.comm.barrier(what)

    def _latest(self) -> Optional[int]:
        if not self.fcfg.ckpt_dir:
            return None
        last = ckpt.latest_step(self.fcfg.ckpt_dir)
        if self.grid is not None:          # PE 0's reading, on every PE
            last = self.grid.comm.all_gather_object(last)[0]
        return last

    def resume_or_init(self, params, opt_state):
        last = self._latest()
        if last is None:
            return 0, params, opt_state
        t0 = time.perf_counter()
        if self.grid is not None:
            from repro_torch.partition import grid_plan
            step, params, opt_state = ckpt.restore_grid_state(
                self.fcfg.ckpt_dir, self.cfg,
                grid_plan(self.grid.q, self.grid.r), self.grid.pe,
                self.storage, step=last, device=self.device)
        elif self.cfg is not None:
            step, params, opt_state = ckpt.restore_train_state(
                self.fcfg.ckpt_dir, step=last, device=self.device)
        else:
            step, state = ckpt.restore(
                self.fcfg.ckpt_dir, last,
                like={"params": params, "opt": opt_state},
                device=self.device)
            params, opt_state = state["params"], state["opt"]
        self.restored = {"step": step, "seconds": time.perf_counter() - t0}
        self._agree(f"resumed from step {step}")
        log.info("resumed from step %d", step)
        return step + 1, params, opt_state

    def _save(self, step, params, opt_state):
        if self.grid is not None:
            self.saves.append(dict(step=step, **ckpt.save_grid_state(
                self.fcfg.ckpt_dir, step, params, opt_state, grid=self.grid,
                storage=self.storage, keep=self.fcfg.keep)))
        elif self.cfg is not None:
            ckpt.save_train_state(self.fcfg.ckpt_dir, step, params,
                                  opt_state, keep=self.fcfg.keep)
        else:
            ckpt.save(self.fcfg.ckpt_dir, step,
                      {"params": params, "opt": opt_state},
                      keep=self.fcfg.keep)

    def _attempt_step(self, params, opt_state, batch, step: int):
        """One (possibly retried) training step.  Returns the new
        (params, opt_state), the old values when the anomaly guard skipped
        a non-finite loss."""
        if self.fcfg.fail_injector is not None:
            try:
                self.fcfg.fail_injector(step)
            except _TRANSIENT:
                self._agree(f"step {step}: transient failure")
                raise
        new_p, new_o, metrics = self.step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        if self.fcfg.skip_nonfinite and not np.isfinite(loss):
            self.skipped += 1
            self._agree(f"step {step}: non-finite loss skipped")
            log.warning("non-finite loss at step %d; skipping", step)
            return params, opt_state      # keep old params/opt_state
        self._agree(f"step {step}: done")
        self.metrics_log.append((step, loss))
        return new_p, new_o

    def run(self, params, opt_state, n_steps: int, start_step: int = 0):
        """Steps ``start_step`` .. ``n_steps - 1``; a step that fails past
        the retry budget re-raises (``self.step`` names it)."""
        step = self.step = start_step
        while step < n_steps:
            batch = self.make_batch(step)

            def _count(attempt, e, step=step):
                self.retries += 1
                log.warning("step %d failed (%s); retry %d", step, e, attempt)

            try:
                params, opt_state = retry_with_backoff(
                    lambda: self._attempt_step(params, opt_state, batch,
                                               step),
                    policy=self.fcfg.retry_policy, transient=_TRANSIENT,
                    on_retry=_count)
            except _TRANSIENT:
                self._agree(f"step {step}: stopped past the retry budget")
                raise
            if self.fcfg.ckpt_dir and self.fcfg.ckpt_every \
                    and (step + 1) % self.fcfg.ckpt_every == 0:
                self._save(step, params, opt_state)
            step = self.step = step + 1
        return params, opt_state


class TransientWorkerFailure(RuntimeError):
    """Raised by the fail injector to model preemption / link flap."""


_TRANSIENT = (TransientWorkerFailure,)


def mismatch_drill(grid, pe: int) -> int:
    """A probe target: the controller on every PE of ``grid``, its fault
    injector failing step 0 on PE ``pe`` alone (a drill that decides
    otherwise on one PE); every PE must raise ``CollectiveMismatch`` at
    the next barrier instead of waiting there."""
    def step_fn(params, opt_state, batch):
        grid.barrier_all()
        return params, opt_state, {"loss": 1.0}

    def injector(step):
        if grid.pe == pe:
            raise TransientWorkerFailure(f"PE {pe} alone fails step {step}")

    ctrl = TrainController(step_fn, lambda step: None,
                           FaultConfig(ckpt_dir=None, backoff_s=0.0,
                                       fail_injector=injector), grid=grid)
    ctrl.run({}, {}, 2)
    return grid.pe
