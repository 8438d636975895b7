"""Fault-tolerant training loop (the JAX package's ``train/loop.py``).

  * auto-restore: on start, the latest committed checkpoint (params + opt
    state + step) is restored and the data pipeline resumes at that step
    (batches are pure functions of the step — no iterator state);
  * async keep-N checkpointing every ``ckpt_every`` steps (atomic rename
    commit; a crash mid-write is invisible to restore);
  * preemption: SIGTERM/SIGINT trigger one final synchronous checkpoint
    before exit;
  * straggler watchdog: a step slower than ``straggler_factor`` × the
    rolling median is logged with its index (detection only).

Batches move to the device of the params.
"""
from __future__ import annotations

import signal
import statistics
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.optimizer import tree_leaves


class TrainLoop:
    def __init__(self, train_step: Callable, params, opt_state,
                 pipeline, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 100, straggler_factor: float = 2.0,
                 log_every: int = 10):
        self.train_step = train_step
        self.params, self.opt_state = params, opt_state
        self.pipeline = pipeline
        self.device = tree_leaves(params)[0].device
        self.step = 0
        self.ckpt = CheckpointManager(ckpt_dir, ckpt_every) if ckpt_dir else None
        self.straggler_factor = straggler_factor
        self.log_every = log_every
        self.step_times: list = []
        self.stragglers: list = []
        self.history: list = []
        self._preempted = False

        if self.ckpt and self.ckpt.latest_step() is not None:
            state = {"params": self.params, "opt": self.opt_state}
            restored, step = self.ckpt.restore_latest(state)
            self.params, self.opt_state = restored["params"], restored["opt"]
            self.step = step
            print(f"[loop] restored checkpoint at step {step}", flush=True)

    def _handle_preemption(self, signum, frame):
        print(f"[loop] signal {signum}: checkpoint-and-exit", flush=True)
        self._preempted = True

    def run(self, num_steps: int, install_signal_handlers: bool = True):
        if install_signal_handlers:
            try:
                signal.signal(signal.SIGTERM, self._handle_preemption)
                signal.signal(signal.SIGINT, self._handle_preemption)
            except ValueError:
                pass  # not the main thread (tests)

        target = self.step + num_steps
        while self.step < target and not self._preempted:
            batch = self.pipeline.batch_at(self.step)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch.items()}
            t0 = time.time()
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])         # waits → true step time
            dt = time.time() - t0
            self.step += 1
            self.step_times.append(dt)
            self.history.append(loss)

            if len(self.step_times) >= 5:
                med = statistics.median(self.step_times[-50:])
                if dt > self.straggler_factor * med and self.step > 5:
                    self.stragglers.append((self.step, dt, med))
                    print(f"[loop] straggler: step {self.step} took "
                          f"{dt:.2f}s (median {med:.2f}s)", flush=True)

            if self.step % self.log_every == 0:
                flips = float(metrics.get("flips", 0.0))
                print(f"[loop] step {self.step} loss {loss:.4f} "
                      f"flips {flips:.0f} {dt*1000:.0f}ms", flush=True)
            if self.ckpt:
                self.ckpt.maybe_save(self.step,
                                     {"params": self.params,
                                      "opt": self.opt_state})

        if self.ckpt:
            self.ckpt.save_now(self.step, {"params": self.params,
                                           "opt": self.opt_state})
        return self.history
