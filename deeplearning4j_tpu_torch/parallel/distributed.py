"""Multi-process initialization and checkpoint-restart training.

Counterpart of ``deeplearning4j_tpu/parallel/distributed.py``. Reference
analog: the Spark TrainingMaster and parameter-server stack (worker
membership, retry). What remains of it here is (a) joining the ranks'
process group from the environment and (b) checkpoint-based restart: a
crashed job relaunches, re-initializes, restores the newest step and
continues.

:func:`initialize_distributed` joins the default ``torch.distributed``
group through :mod:`.launch` (NCCL on the card, gloo when the caller asks
for the CPU), as ``jax.distributed.initialize`` joins the JAX package's
hosts; its connect runs under a ``faults.RetryPolicy``.

:class:`FaultTolerantTrainer` checkpoints through the port's
``TrainingCheckpointer`` (one directory a step, per process). Under ranks
every rank constructs the trainer and calls it at the same steps, and the
checkpoint directory is one that every rank sees:

- **replicated** models (a plain network, or a ``ParallelWrapper``'s:
  every rank holds the same params) are written by rank 0 alone, and
  ``fit`` ends with a barrier behind rank 0's last write; every rank
  restores the same newest valid step from the directory;
- **sharded** models (a ``TensorParallel``'s: each rank holds its own
  shards) are written by every rank, each into its own subdirectory
  ``shard-<rank>-of-<ranks>``; at restore the ranks agree on the newest
  step that every rank's shard holds and validates, and restore that.
"""

from __future__ import annotations

import json
import os
import threading
import warnings
from typing import Callable, Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel import launch


def _world() -> tuple:
    """(rank, ranks) of the default group, (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _parse_address(address: str) -> tuple:
    host, _, port = address.replace("tcp://", "").rpartition(":")
    return host or "localhost", int(port)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           retry=None, device: str = "cuda") -> dict:
    """Join the default process group, env-driven like the reference's
    parameter-server configuration (``COORDINATOR_ADDRESS`` as
    ``host:port``, ``NUM_PROCESSES``, ``PROCESS_ID``).

    The group's rendezvous is a ``TCPStore`` at the coordinator's address
    (process 0 serves it), or, for one process and no address, a store in
    this process; the rank then joins through ``launch.init_rank``: the
    rank's card and NCCL, or gloo with ``device="cpu"``. The connect runs
    under a :class:`faults.RetryPolicy` (``retry`` overrides the default 5
    attempts, 0.2-5 s backoff, 120 s deadline): a coordinator still coming
    up after a relaunch refuses a few connects before it accepts. Fault
    class ``coord_connect`` injects that refusal.

    Returns {process_index, process_count, local_devices, global_devices}:
    one device a process. With no coordinator and no process count
    configured it starts nothing and returns the single-process summary.
    """
    from datetime import timedelta

    from deeplearning4j_tpu_torch import faults

    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    if coordinator_address is not None or num_processes is not None:
        n = 1 if num_processes is None else int(num_processes)
        rank = 0 if process_id is None else int(process_id)
        if coordinator_address is None and n > 1:
            raise ValueError(f"{n} processes need a COORDINATOR_ADDRESS")
        policy = retry or faults.RetryPolicy(
            max_attempts=5, base_delay_s=0.2, max_delay_s=5.0,
            deadline_s=120.0)

        def _connect():
            plan = faults.active()
            if plan is not None and plan.fires("coord_connect"):
                raise faults.CoordinatorConnectFault(
                    f"injected connection refusal to coordinator "
                    f"{coordinator_address}")
            if coordinator_address is None:
                store = dist.HashStore()
            else:
                host, port = _parse_address(coordinator_address)
                store = dist.TCPStore(host, port, n, is_master=rank == 0,
                                      timeout=timedelta(
                                          seconds=policy.deadline_s))
            launch.init_rank(rank, n, device, store)

        policy.call(_connect, component="distributed")
    rank, n = _world()
    return {"process_index": rank, "process_count": n,
            "local_devices": 1, "global_devices": n}


class FaultTolerantTrainer:
    """Checkpoint-restart training loop.

    Wraps any model exposing ``fit_batch`` / params with a
    ``TrainingCheckpointer``: on construction it restores the newest
    checkpoint if one exists (the relaunch path), and during training it
    saves every ``save_every`` steps, and on an exception. A crash at any
    point loses at most ``save_every`` steps. Who writes under ranks is in
    the module docstring.

        trainer = FaultTolerantTrainer(model, ckpt_dir, save_every=50)
        trainer.fit(iterator, epochs=3)    # safe to kill and rerun
    """

    def __init__(self, model, checkpoint_dir: str, save_every: int = 100,
                 keep_last: int = 3, on_restore: Optional[Callable] = None,
                 max_restarts_without_progress: int = 3):
        from deeplearning4j_tpu_torch.parallel.data_parallel import (
            ParallelWrapper,
        )
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
            TensorParallel,
        )
        from deeplearning4j_tpu_torch.util.checkpoints import (
            TrainingCheckpointer,
        )

        self.model = model
        # a parallel facade trains, but its .model owns params, updater
        # state and step_count: train through the facade, checkpoint the
        # owner. The unwrap is narrow (isinstance, not any .model) so an
        # unrelated object with a .model attribute is checkpointed as
        # itself
        self._target = (model.model
                        if isinstance(model, (ParallelWrapper, TensorParallel))
                        else model)
        self.rank, self.ranks = _world()
        self.sharded = isinstance(model, TensorParallel) and self.ranks > 1
        self.save_every = max(1, save_every)
        self.checkpoint_dir = str(checkpoint_dir)
        directory = self.checkpoint_dir
        if self.sharded:
            directory = os.path.join(
                directory, f"shard-{self.rank}-of-{self.ranks}")
        self.writes = self.sharded or self.rank == 0
        if self.sharded:
            model.place()   # the checkpoint holds this rank's shards
        self.checkpointer = TrainingCheckpointer(directory,
                                                 keep_last=keep_last)
        self.restored_step = (self._restore_agreed() if self.sharded
                              else self.checkpointer.restore_latest(
                                  self._target))
        self._saved = {self.restored_step}
        self._check_crash_loop(max_restarts_without_progress)
        if self.restored_step is not None and on_restore:
            on_restore(self.restored_step)
        # set whenever no fit() loop is mid-step: the preemption drain's
        # emergency save waits on it so that it never snapshots the trees
        # a step is replacing
        self._parked = threading.Event()
        self._parked.set()

    def _restore_agreed(self) -> Optional[int]:
        """The newest step every rank's shard holds and validates, restored
        on every rank (None if there is none)."""
        from deeplearning4j_tpu_torch.util.checkpoints import (
            CheckpointCorrupt,
        )

        mine = self.checkpointer.all_steps()
        steps = [None] * self.ranks
        dist.all_gather_object(steps, mine)
        common = sorted(set.intersection(*(set(s) for s in steps)),
                        reverse=True)
        for step in common:
            try:
                self.checkpointer.restore(step, self._target)
                ok = 1
            except (CheckpointCorrupt, OSError, ValueError):
                ok = 0
            flag = torch.tensor([ok], device=self._target.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
            if int(flag[0]):
                return step
        return None

    def _barrier(self) -> None:
        if self.ranks > 1:
            dist.barrier()

    def _save(self, step: int, wait: bool = False) -> None:
        """Save ``step`` (the writing ranks), once: a step already saved
        or restored is not written again, as the JAX package's checkpoint
        manager skips a step it holds."""
        if self.writes and step not in self._saved:
            self._saved.add(step)
            self.checkpointer.save(step, self._target)
        if self.writes and wait:
            self.checkpointer.wait()

    # --------------------------------------------------- crash-loop bound
    def _crashloop_path(self) -> str:
        return os.path.join(self.checkpoint_dir, ".crashloop.json")

    def _check_crash_loop(self, bound: int) -> None:
        """A relaunch that restores the same step as the relaunch before it
        made no progress: the crash is deterministic (a bad batch, poisoned
        state), and restarting forever burns the job. After ``bound``
        restarts at one step, fail loud instead of looping. The count lives
        in a marker file (rank 0 writes it, after every rank has read it),
        so it survives the process boundary the way the crashes do."""
        if self.restored_step is None or bound <= 0:
            return
        path = self._crashloop_path()
        count = 1
        try:
            with open(path) as f:
                prev = json.load(f)
            if int(prev.get("step", -1)) == int(self.restored_step):
                count = int(prev.get("count", 0)) + 1
        except (OSError, ValueError):
            pass
        self._barrier()
        if self.rank == 0:
            try:
                with open(path, "w") as f:
                    json.dump({"step": int(self.restored_step),
                               "count": count}, f)
            except OSError:
                pass
        if count > bound:
            from deeplearning4j_tpu_torch import monitoring

            mon = monitoring.recovery_monitor()
            if mon is not None:
                mon.recovery_total.labels(component="trainer",
                                          outcome="crash_loop").inc()
            raise RuntimeError(
                f"crash loop detected: {count} consecutive relaunches "
                f"restored step {self.restored_step} without progressing "
                f"past it (bound {bound}). The failure is likely "
                f"deterministic: inspect the step, the data at it, and "
                f"{path} before relaunching (delete the file to override).")

    # ------------------------------------------------------- preemption
    def register_lifecycle(self, manager) -> "FaultTolerantTrainer":
        """Register the emergency checkpoint with a
        ``serving.lifecycle.LifecycleManager``: on SIGTERM (or an injected
        ``preempt`` fault) the drain saves the current step inside the
        grace budget, so the relaunch loses no step instead of up to
        ``save_every``."""
        manager.register_checkpoint(self._emergency_save)
        return self

    def _emergency_save(self) -> None:
        self._parked.wait(timeout=30.0)
        self._save(self._target.step_count, wait=True)
        from deeplearning4j_tpu_torch import monitoring

        mon = monitoring.recovery_monitor()
        if mon is not None:
            mon.recovery_total.labels(component="trainer",
                                      outcome="preempt_save").inc()

    @staticmethod
    def _preempting() -> bool:
        """A managed preemption drain is in progress (the fit loop exits
        between batches so that the emergency save captures settled
        state)."""
        from deeplearning4j_tpu_torch.serving import lifecycle

        mgr = lifecycle.manager()
        return mgr is not None and mgr.reason is not None

    def fit_batch(self, ds):
        from deeplearning4j_tpu_torch import faults

        plan = faults.active()
        if plan is not None and plan.fires("preempt",
                                           step=self._target.step_count):
            # in-process SIGTERM: managed, the lifecycle drain starts (this
            # call returns and the fit loop exits at the next batch);
            # unmanaged, PreemptionFault propagates (into fit()'s
            # save-on-exception path)
            from deeplearning4j_tpu_torch.serving import lifecycle

            lifecycle.deliver_preemption(source="trainer",
                                         step=self._target.step_count)
            if self._preempting():
                # managed: the grace budget pays for the checkpoint, not
                # another train step; the drain saves the current one
                return float("nan")
        loss = self.model.fit_batch(ds)
        step = self._target.step_count
        if step % self.save_every == 0:
            self._save(step)
        return loss

    def fit(self, data, epochs: int = 1):
        self._parked.clear()
        try:
            for _ in range(epochs):
                for ds in data:
                    self.fit_batch(ds)
                    if self._preempting():
                        # the drain's checkpoint callback (see
                        # register_lifecycle) saves this step
                        return self.model
                if hasattr(data, "reset"):
                    data.reset()
                self._target.epoch_count += 1
        except Exception:
            # save-on-exception: capture the last good in-memory state so
            # that the relaunch resumes from here, not save_every steps
            # back. Best effort: the original failure always propagates
            try:
                self._save(self._target.step_count, wait=True)
                from deeplearning4j_tpu_torch import monitoring

                mon = monitoring.recovery_monitor()
                if mon is not None and self.writes:
                    mon.recovery_total.labels(
                        component="trainer", outcome="save_on_error").inc()
            except Exception as save_err:  # noqa: BLE001 (never mask the
                # original failure with a checkpoint error)
                warnings.warn(f"save-on-exception failed: {save_err}")
            raise
        finally:
            self._parked.set()
        self._save(self._target.step_count, wait=True)
        self._barrier()
        return self.model

    def close(self):
        self.checkpointer.close()
