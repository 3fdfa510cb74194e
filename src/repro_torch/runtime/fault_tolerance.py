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
"""

from __future__ import annotations

import dataclasses
import logging
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
    a resumed state is placed."""

    def __init__(self, step_fn, make_batch_fn, fcfg: FaultConfig,
                 cfg=None, device=None):
        self.step_fn = step_fn
        self.make_batch = make_batch_fn        # (step) -> device batch
        self.fcfg = fcfg
        self.cfg = cfg
        self.device = device
        self.metrics_log: list = []
        self.retries = 0
        self.skipped = 0

    def resume_or_init(self, params, opt_state):
        last = ckpt.latest_step(self.fcfg.ckpt_dir)
        if last is None:
            return 0, params, opt_state
        if self.cfg is not None:
            step, params, opt_state = ckpt.restore_train_state(
                self.fcfg.ckpt_dir, step=last, device=self.device)
        else:
            step, state = ckpt.restore(
                self.fcfg.ckpt_dir, last,
                like={"params": params, "opt": opt_state},
                device=self.device)
            params, opt_state = state["params"], state["opt"]
        log.info("resumed from step %d", step)
        return step + 1, params, opt_state

    def _save(self, step, params, opt_state):
        if self.cfg is not None:
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
            self.fcfg.fail_injector(step)
        new_p, new_o, metrics = self.step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        if self.fcfg.skip_nonfinite and not np.isfinite(loss):
            self.skipped += 1
            log.warning("non-finite loss at step %d; skipping", step)
            return params, opt_state      # keep old params/opt_state
        self.metrics_log.append((step, loss))
        return new_p, new_o

    def run(self, params, opt_state, n_steps: int, start_step: int = 0):
        step = start_step
        while step < n_steps:
            batch = self.make_batch(step)

            def _count(attempt, e, step=step):
                self.retries += 1
                log.warning("step %d failed (%s); retry %d", step, e, attempt)

            params, opt_state = retry_with_backoff(
                lambda: self._attempt_step(params, opt_state, batch, step),
                policy=self.fcfg.retry_policy, transient=_TRANSIENT,
                on_retry=_count)
            if self.fcfg.ckpt_every and (step + 1) % self.fcfg.ckpt_every == 0:
                self._save(step, params, opt_state)
            step += 1
        return params, opt_state


class TransientWorkerFailure(RuntimeError):
    """Raised by the fail injector to model preemption / link flap."""


_TRANSIENT = (TransientWorkerFailure,)
