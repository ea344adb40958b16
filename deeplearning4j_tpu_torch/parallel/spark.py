"""Spark-API compatibility shims.

Counterpart of ``deeplearning4j_tpu/parallel/spark.py``. Reference analog:
deeplearning4j-scaleout/spark, ``SparkDl4jMultiLayer`` with
``ParameterAveragingTrainingMaster`` / ``SharedTrainingMaster``. Those
classes exist because the reference needs Spark to place replicas on
executors and a parameter server to reconcile them. Here the "SparkContext"
slot takes a ``DeviceMesh``, the cluster is the ranks of its "data" axis
(one process a rank, every rank calling ``fit`` with the same stream), and
the shims keep the reference's surface (a builder with batchSizePerWorker
and averagingFrequency):

- ``averaging_frequency`` 1 trains through :class:`ParallelWrapper`: sync
  data parallelism, the model's own step on each rank's slice, is exact
  averaging every step. The stream is re-batched to
  ``batch_size_per_worker`` x the data-parallel degree.
- ``averaging_frequency`` K > 1 runs local SGD: K local steps a replica,
  then one average of the params and updater state
  (:class:`ParameterAveragingTrainer`), over the model's functional loss
  (``as_loss_fn``) with the network's own updater selection
  (:class:`PerEntryUpdater`: NoOp for frozen layers, per-layer overrides),
  its ``max_grad_norm`` clip, frozen entries left out of the average, and
  rounds that pool global batches across epoch boundaries. The averaged
  params and state are written back into the network, and its updater
  state restarts, as the reference master's does.
- :class:`RoundSupervisor` drops a faulted replica from a round's average
  and re-admits it after. Its decision comes from the fault plan and the
  round number only, so every rank, consulting the same plan in the same
  order, drops the same replica; its recovery counts go to
  ``dl4j_recovery_total{component="localsgd"}``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import warnings
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh


@dataclasses.dataclass
class ParameterAveragingTrainingMaster:
    """Config carrier (ParameterAveragingTrainingMaster.Builder analog).

    ``straggler_timeout_s`` (> 0 enables it) is the per-round straggler
    budget of K > 1 local SGD: a worker whose round overruns it has its
    contribution dropped and the average renormalized over the survivors
    (it re-enters synced the next round). 0 keeps the classic behavior:
    every round waits for every worker."""

    batch_size_per_worker: int = 32
    averaging_frequency: int = 1  # > 1 routes fit() to local SGD
    worker_prefetch_num_batches: int = 2
    straggler_timeout_s: float = 0.0

    class Builder:
        def __init__(self, rdd_data_set_num_examples: int = 1):
            self._batch = 32
            self._freq = 1
            self._prefetch = 2
            self._straggler = 0.0

        def batch_size_per_worker(self, n: int):
            self._batch = n
            return self

        def averaging_frequency(self, n: int):
            self._freq = n
            return self

        def worker_prefetch_num_batches(self, n: int):
            self._prefetch = n
            return self

        def straggler_timeout_s(self, s: float):
            self._straggler = float(s)
            return self

        def build(self) -> "ParameterAveragingTrainingMaster":
            return ParameterAveragingTrainingMaster(
                batch_size_per_worker=self._batch,
                averaging_frequency=self._freq,
                worker_prefetch_num_batches=self._prefetch,
                straggler_timeout_s=self._straggler)


class RoundSupervisor:
    """Host-side failure detector for local-SGD rounds.

    The failure signal comes from the fault plan (``worker_crash`` /
    ``collective_delay``), standing in for the heartbeat a cluster
    controller watches; the response is real: the flagged replica's
    contribution is dropped from the round, the average renormalizes over
    the survivors (the trainer's ``fit_round(lost=...)``), and the worker is
    re-admitted, synced to the survivors' average, the round after its
    fault clears. A straggler over the budget costs the round the budget
    (the survivors' wait), one within it (or with no budget) its whole
    delay. Every action lands in ``dl4j_recovery_total{component=
    "localsgd"}``."""

    def __init__(self, dp: int, straggler_timeout_s: float = 0.0):
        self.dp = max(1, int(dp))
        self.timeout_s = float(straggler_timeout_s)
        self.round = 0
        self._lost_last: set = set()
        self.dropped = 0
        self.readmitted = 0

    def _record(self, outcome: str, n: int = 1):
        from deeplearning4j_tpu_torch import monitoring

        mon = monitoring.recovery_monitor()
        if mon is not None:
            mon.recovery_total.labels(component="localsgd",
                                      outcome=outcome).inc(n)

    def lost_for_round(self):
        """Consult the fault plan for this round; returns the sorted list
        of replica indices to drop (usually empty)."""
        from deeplearning4j_tpu_torch import faults

        lost = set()
        plan = faults.active()
        if plan is not None:
            rnd = self.round
            if plan.fires("worker_crash", round=rnd):
                lost.add(rnd % self.dp)        # deterministic victim
                self._record("dropped_worker")
            if plan.fires("collective_delay", round=rnd):
                victim = (rnd + 1) % self.dp
                if self.timeout_s > 0 and plan.delay_s > self.timeout_s:
                    # the straggler overran the round budget: survivors
                    # wait only the budget, then drop its contribution
                    time.sleep(self.timeout_s)
                    lost.add(victim)
                    self._record("dropped_straggler")
                else:
                    # no budget (or within it): the whole round waits
                    time.sleep(plan.delay_s)
        back = self._lost_last - lost
        if back:
            self.readmitted += len(back)
            self._record("readmitted", len(back))
        self.dropped += len(lost)
        self._lost_last = set(lost)
        self.round += 1
        return sorted(lost)


# SharedTrainingMaster (gradient sharing over Aeron) trains the same way;
# the name stays so that reference users find it
SharedTrainingMaster = ParameterAveragingTrainingMaster


class SparkDl4jMultiLayer:
    """SparkDl4jMultiLayer(sc, conf, trainingMaster) analog.

    The "SparkContext" slot takes a DeviceMesh (None: every rank on
    "data", on the network's device type; a configuration is then
    initialized on the card); ``fit`` trains data-parallel over its "data"
    axis, every rank calling it with the same stream."""

    def __init__(self, mesh: Optional[DeviceMesh], network_or_conf,
                 training_master: Optional[
                     ParameterAveragingTrainingMaster] = None):
        from deeplearning4j_tpu_torch.nn.conf.builders import (
            MultiLayerConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        if isinstance(network_or_conf, MultiLayerConfiguration):
            self.network = MultiLayerNetwork(network_or_conf).init(
                device=mesh.device_type if mesh is not None else "cuda")
        else:
            self.network = network_or_conf
        self.training_master = (training_master
                                or ParameterAveragingTrainingMaster())
        self._wrapper = ParallelWrapper(
            self.network, mesh,
            prefetch_buffer=self.training_master.worker_prefetch_num_batches)

    def fit(self, data, epochs: int = 1):
        """fit(rdd-like iterator of DataSets).

        The stream is re-batched to batch_size_per_worker x the
        data-parallel degree (the reference re-splits the RDD to
        batchSizePerWorker an executor). averaging_frequency > 1 runs local
        SGD (see the module docstring)."""
        dp = self._wrapper.mesh.shape["data"]
        global_batch = self.training_master.batch_size_per_worker * dp
        K = int(self.training_master.averaging_frequency)
        if K <= 1:
            # a MultiDataSet stream needs the slot-aware rebatcher
            multi, data = self._peek_multi(data)
            rebatcher = (_RebatchingMultiIterator if multi
                         else _RebatchingIterator)
            self._wrapper.fit(rebatcher(data, global_batch, dp),
                              epochs=epochs)
            return self.network
        return self._fit_local_sgd(data, epochs, global_batch, dp, K)

    def _peek_multi(self, data):
        """(is_multidataset_stream, stream): peeks at the first item of a
        ComputationGraph stream without losing it (a resettable source is
        reset; a one-shot generator gets the item stitched back). A
        MultiLayerNetwork stream is never multi and is not peeked at."""
        if hasattr(self.network, "layers"):          # MultiLayerNetwork
            return False, data
        it = iter(data)
        peek = next(it, None)
        multi = isinstance(getattr(peek, "features", None),
                           (list, tuple, dict))
        if hasattr(data, "reset"):
            data.reset()
            return multi, data
        if peek is None:
            return multi, data
        return multi, itertools.chain([peek], it)

    def _fit_local_sgd(self, data, epochs, global_batch, dp, K):
        from deeplearning4j_tpu_torch.nn.multilayer import _unpack
        from deeplearning4j_tpu_torch.optimize.updaters import (
            NoOp, PerEntryUpdater,
        )
        from deeplearning4j_tpu_torch.parallel.param_averaging import (
            ParameterAveragingTrainer, step_seed,
        )

        self._check_local_sgd_supported(K)
        net = self.network
        loss_fn, (params0, state0) = net.as_loss_fn(train=True)
        ups = net._updaters
        per_entry = dict(ups) if isinstance(ups, dict) else list(ups)
        # frozen entries never diverge: leave them out of the average, so
        # they stay bit-identical through local SGD
        skip = ({k: isinstance(u, NoOp) for k, u in per_entry.items()}
                if isinstance(per_entry, dict)
                else [isinstance(u, NoOp) for u in per_entry])
        trainer = ParameterAveragingTrainer(
            loss_fn, PerEntryUpdater(per_entry), self._wrapper.mesh,
            averaging_frequency=K, stateful=True,
            max_grad_norm=getattr(net.conf, "max_grad_norm", 0.0),
            skip_average=skip)
        carry = trainer.init(params0, state=state0,
                             rng=step_seed(net.conf.seed, net.step_count))
        # one round consumes K global batches; the pool carries across
        # epoch boundaries (a small dataset may hold fewer than K batches
        # an epoch: rounds still complete, as the reference master carries
        # its iteration count across RDD passes)
        conf = net.conf
        supervisor = RoundSupervisor(
            dp, self.training_master.straggler_timeout_s)
        self._round_supervisor = supervisor     # introspectable after fit
        # the multi path serves ComputationGraphs fed MultiDataSets:
        # dispatch on the stream's shape, not the graph's arity alone
        multi = False
        if not hasattr(net, "layers"):     # ComputationGraph
            multi = (len(conf.network_inputs) > 1
                     or len(conf.network_outputs) > 1)
            if not multi:
                multi, data = self._peek_multi(data)
        if multi:
            carry, have, dropped_tail = self._run_multi_rounds(
                data, epochs, global_batch, K, trainer, carry, supervisor)
        else:
            xs, ys, ms, lms, have = [], [], [], [], 0
            dropped_tail = 0
            for _ in range(epochs):
                for ds in _RebatchingIterator(data, global_batch, dp):
                    if ds.features.shape[0] != global_batch:
                        # a round splits into K x (global_batch / dp)
                        # shards; a truncated tail would mis-shard it, so
                        # it is dropped (counted and warned below)
                        dropped_tail += ds.features.shape[0]
                        continue
                    # masked DataSets ride the rounds (_unpack's routing:
                    # a labels-only mask plays both roles)
                    x_, y_, m_, lm_ = _unpack(ds)
                    xs.append(np.asarray(x_))
                    ys.append(np.asarray(y_))
                    if m_ is not None:
                        ms.append(np.asarray(m_))
                    if lm_ is not None:
                        lms.append(np.asarray(lm_))
                    have += 1
                    if have == K:
                        carry, loss = trainer.fit_round(
                            carry, np.concatenate(xs), np.concatenate(ys),
                            mask=np.concatenate(ms) if ms else None,
                            label_mask=np.concatenate(lms) if lms else None,
                            lost=supervisor.lost_for_round() or None)
                        net.score_value = float(loss)
                        xs, ys, ms, lms, have = [], [], [], [], 0
                if hasattr(data, "reset"):
                    data.reset()
        if have or dropped_tail:
            # one unit on both paths, rows: `have` counts pooled global
            # batches stranded short of a round, `dropped_tail` rows that
            # never filled a global batch
            from deeplearning4j_tpu_torch import monitoring

            dropped_rows = have * global_batch + dropped_tail
            mon = monitoring.localsgd_monitor()
            if mon is not None:
                mon.dropped_rows.inc(dropped_rows)
            warnings.warn(
                f"local-SGD fit dropped {dropped_rows} sample row(s): "
                f"{have} pooled global batch(es) ({have * global_batch} "
                f"rows) stranded short of an averaging round of {K}, plus "
                f"{dropped_tail} tail row(s) that did not fill a global "
                f"batch; size the dataset/epochs accordingly for full "
                f"coverage")
        # the averaged params and network state flow back into the model;
        # the updater state restarts for the new params (the reference
        # master serializes params, and the moments restart fresh)
        net.params = trainer.params(carry)
        net.state = trainer.state(carry)
        if isinstance(net.params, dict):   # ComputationGraph
            net.opt_state = {n: ups[n].init_state(p)
                             for n, p in net.params.items()}
        else:                              # MultiLayerNetwork
            net.opt_state = [u.init_state(p)
                             for u, p in zip(ups, net.params)]
        return net

    def _run_multi_rounds(self, data, epochs, global_batch, K, trainer,
                          carry, supervisor):
        """Multi-input/-output ComputationGraph local SGD (the reference's
        SparkComputationGraph trains MultiDataSet RDDs). The stream runs
        through _RebatchingMultiIterator; each round ships dict x/y keyed
        by the graph's input/output names through the same trainer, with
        the shared features mask and a single-array labels mask riding
        along. Returns (carry, pending batches, dropped rows)."""
        conf = self.network.conf
        in_names = list(conf.network_inputs)
        out_names = list(conf.network_outputs)

        def named(arrs, names, what):
            if isinstance(arrs, dict):
                return {n: np.asarray(arrs[n]) for n in names}
            arrs = list(arrs)
            if len(arrs) != len(names):
                raise ValueError(f"MultiDataSet carries {len(arrs)} {what} "
                                 f"arrays; the graph has {len(names)}")
            return dict(zip(names, (np.asarray(a) for a in arrs)))

        class _Epochs:
            """The source's epochs chained into one stream, so that the
            rebatcher pools rows across epoch boundaries."""

            def __iter__(self):
                for e in range(epochs):
                    yield from data
                    if hasattr(data, "reset") and e + 1 < epochs:
                        data.reset()

        round_x, round_y, round_m, round_lm, have = [], [], [], [], 0
        # dp=global_batch: a K > 1 round needs exact global batches, so
        # the rebatcher's tail flush emits only whole ones
        rebatcher = _RebatchingMultiIterator(_Epochs(), global_batch,
                                             dp=global_batch)
        for mds in rebatcher:
            round_x.append(named(mds.features, in_names, "feature"))
            round_y.append(named(mds.labels, out_names, "label"))
            if mds.features_mask is not None:
                round_m.append(np.asarray(mds.features_mask))
            if mds.labels_mask is not None:
                round_lm.append(np.asarray(mds.labels_mask))
            have += 1
            if have == K:
                x_dict = {n: np.concatenate([r[n] for r in round_x])
                          for n in in_names}
                y_dict = {n: np.concatenate([r[n] for r in round_y])
                          for n in out_names}
                carry, loss = trainer.fit_round(
                    carry, x_dict, y_dict,
                    mask=(np.concatenate(round_m) if round_m else None),
                    label_mask=(np.concatenate(round_lm) if round_lm
                                else None),
                    lost=supervisor.lost_for_round() or None)
                self.network.score_value = float(loss)
                round_x, round_y, round_m, round_lm, have = \
                    [], [], [], [], 0
        return carry, have, getattr(rebatcher, "dropped_rows", 0)

    def _check_local_sgd_supported(self, K):
        """The K > 1 path trains through the functional loss
        (``as_loss_fn``), which threads (state, rng), includes the l1/l2
        terms, and takes the masks, with the per-entry updaters and the
        ``max_grad_norm`` clip. A center-loss head is refused: its centers
        and center term live in the fit path."""
        net = self.network
        conf = net.conf
        if hasattr(net, "layers"):           # MultiLayerNetwork
            named = [(str(i), l) for i, l in enumerate(net.layers)]
        else:                                # ComputationGraph
            from deeplearning4j_tpu_torch.nn.conf.graph import LayerVertex

            named = [(n, v.layer) for n, v in conf.vertices.items()
                     if isinstance(v, LayerVertex)]
        problems = [f"layer {i} center loss (centers state and center "
                    f"term need the fit path)" for i, l in named
                    if type(l).__name__ == "CenterLossOutputLayer"]
        if problems:
            raise NotImplementedError(
                "averaging_frequency>1 routes through the functional "
                "local-SGD trainer, which does not carry: "
                + "; ".join(problems)
                + ". Use averaging_frequency=1 (exact sync averaging) or "
                "parallel.ParameterAveragingTrainer with a custom loss.")

    def get_network(self):
        return self.network


class _RebatchingIterator:
    """Re-batches an iterator of DataSets to a fixed global batch size
    (like the reference's RDD repartitioning), preserving feature masks.

    The tail that doesn't fill a whole global batch is NOT dropped: it is
    flushed truncated down to the largest multiple of the data-parallel
    degree, so small datasets still train (only examples that can't shard
    evenly are lost)."""

    def __init__(self, source, batch_size: int, dp: int = 1):
        self._source = source
        self._batch = batch_size
        self._dp = max(1, dp)

    def reset(self):
        if hasattr(self._source, "reset"):
            self._source.reset()

    def __iter__(self):
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        from deeplearning4j_tpu_torch.nn.multilayer import _unpack

        feats, labels, masks, lmasks = [], [], [], []
        have, any_mask, any_unmasked = 0, False, False
        any_lmask, any_no_lmask = False, False

        def _cat(n):
            fx = np.concatenate(feats)
            fy = np.concatenate(labels)
            fm = np.concatenate(masks) if any_mask else None
            lm = np.concatenate(lmasks) if any_lmask else None
            return (DataSet(fx[:n], fy[:n],
                            None if fm is None else fm[:n],
                            None if lm is None else lm[:n]),
                    fx[n:], fy[n:],
                    None if fm is None else fm[n:],
                    None if lm is None else lm[n:])

        for ds in self._source:
            x, y, mask, lmask = _unpack(ds)
            if isinstance(lmask, (list, tuple, dict)):
                # the per-output MultiDataSet shape: np.asarray would
                # stack it [n_out, B, T] and the batch-axis slicing below
                # would silently corrupt it
                raise ValueError(
                    "per-output labels masks (list/dict) are not supported "
                    "on the spark re-batching path; use a single labels "
                    "mask array or fit the ComputationGraph directly")
            feats.append(np.asarray(x))
            labels.append(np.asarray(y))
            if mask is not None:
                any_mask = True
                masks.append(np.asarray(mask))
            else:
                any_unmasked = True
            if lmask is not None:
                any_lmask = True
                lmasks.append(np.asarray(lmask))
            else:
                any_no_lmask = True
            if any_lmask and any_no_lmask:
                raise ValueError("mixed labels-masked/unmasked DataSets "
                                 "in one stream")
            if any_mask and any_unmasked:
                raise ValueError("mixed masked/unmasked DataSets in one stream")
            have += feats[-1].shape[0]
            while have >= self._batch:
                out, fx, fy, fm, lm = _cat(self._batch)
                yield out
                feats, labels = [fx], [fy]
                masks = [fm] if fm is not None else []
                lmasks = [lm] if lm is not None else []
                have = fx.shape[0]
        tail = (have // self._dp) * self._dp
        if tail:
            out, _, _, _, _ = _cat(tail)
            yield out


class _RebatchingMultiIterator:
    """MultiDataSet twin of _RebatchingIterator: pools per-slot
    feature/label arrays — plus the SHARED features mask and a
    single-array labels mask — and re-cuts them into fixed global
    batches; the tail flushes truncated to the largest dp multiple.
    Per-output labels-mask lists/dicts are rejected (that routing lives
    in the graph's fit path). Slot order/keys are preserved (list or
    dict features both work, matching ComputationGraph._as_input_dict)."""

    def __init__(self, source, batch_size: int, dp: int = 1):
        self._source = source
        self._batch = batch_size
        self._dp = max(1, dp)

    def reset(self):
        if hasattr(self._source, "reset"):
            self._source.reset()

    @staticmethod
    def _slots(arrs, keys=None):
        """(keys_or_None, list_of_arrays). ``keys`` (from the stream's
        first item) pins slot order for every later dict — items whose
        dicts iterate in a different order must not silently swap slots —
        and mismatched key sets fail loud."""
        if isinstance(arrs, dict):
            if keys is None:
                keys = list(arrs)
            elif set(keys) != set(arrs):
                raise ValueError(
                    f"MultiDataSet slot keys changed mid-stream: "
                    f"{sorted(arrs)} vs {sorted(keys)}")
            return keys, [np.asarray(arrs[k]) for k in keys]
        return None, [np.asarray(a) for a in
                      (arrs if isinstance(arrs, (list, tuple)) else [arrs])]

    def __iter__(self):
        from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet

        fkeys = lkeys = None
        pool_f = pool_l = None
        pool_m, pool_lm = [], []
        any_mask = any_unmasked = any_lmask = any_no_lmask = False
        have = 0

        def _cut(n):
            nonlocal have
            cf = [np.concatenate(p) if len(p) > 1 else p[0] for p in pool_f]
            cl = [np.concatenate(p) if len(p) > 1 else p[0] for p in pool_l]
            cm = (np.concatenate(pool_m) if any_mask else None)
            clm = (np.concatenate(pool_lm) if any_lmask else None)
            for i, a in enumerate(cf):
                pool_f[i] = [a[n:]]
            for i, a in enumerate(cl):
                pool_l[i] = [a[n:]]
            pool_m[:] = [cm[n:]] if cm is not None else []
            pool_lm[:] = [clm[n:]] if clm is not None else []
            have -= n
            feats = ([a[:n] for a in cf] if fkeys is None
                     else dict(zip(fkeys, (a[:n] for a in cf))))
            labels = ([a[:n] for a in cl] if lkeys is None
                      else dict(zip(lkeys, (a[:n] for a in cl))))
            return MultiDataSet(feats, labels,
                                features_mask=None if cm is None
                                else cm[:n],
                                labels_mask=None if clm is None
                                else clm[:n])

        self.dropped_rows = 0
        for ds in self._source:
            lm = getattr(ds, "labels_mask", None)
            if isinstance(lm, (list, tuple, dict)):
                raise ValueError(
                    "per-output labels masks (list/dict) are not supported "
                    "on the spark re-batching path; use a single labels "
                    "mask array or fit the ComputationGraph directly")
            fm = getattr(ds, "features_mask", None)
            fk, fa = self._slots(ds.features, fkeys)
            lk, la = self._slots(ds.labels, lkeys)
            if pool_f is None:
                fkeys, lkeys = fk, lk
                pool_f = [[] for _ in fa]
                pool_l = [[] for _ in la]
            for i, a in enumerate(fa):
                pool_f[i].append(a)
            for i, a in enumerate(la):
                pool_l[i].append(a)
            if fm is not None:
                any_mask = True
                pool_m.append(np.asarray(fm))
            else:
                any_unmasked = True
            if lm is not None:
                any_lmask = True
                pool_lm.append(np.asarray(lm))
            else:
                any_no_lmask = True
            if any_mask and any_unmasked:
                raise ValueError(
                    "mixed masked/unmasked MultiDataSets in one stream")
            if any_lmask and any_no_lmask:
                raise ValueError("mixed labels-masked/unmasked "
                                 "MultiDataSets in one stream")
            have += fa[0].shape[0]
            while have >= self._batch:
                yield _cut(self._batch)
        if pool_f is not None:
            tail = (have // self._dp) * self._dp
            if tail:
                yield _cut(tail)
            self.dropped_rows = have   # rows below the dp multiple


class SparkComputationGraph(SparkDl4jMultiLayer):
    """SparkComputationGraph analog: the same shims over a
    ComputationGraph."""

    def __init__(self, mesh, network_or_conf, training_master=None):
        from deeplearning4j_tpu_torch.nn.conf.builders import (
            ComputationGraphConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        if isinstance(network_or_conf, ComputationGraphConfiguration):
            network_or_conf = ComputationGraph(network_or_conf).init(
                device=mesh.device_type if mesh is not None else "cuda")
        super().__init__(mesh, network_or_conf, training_master)
