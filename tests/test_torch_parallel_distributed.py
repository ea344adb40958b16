"""The port's ``initialize_distributed`` and ``FaultTolerantTrainer``
(``parallel/distributed.py``) against the JAX package's.

Mirrors ``tests/test_fault_tolerance.py`` (``TestFaultTolerance``,
``TestDistributedInit``) and ``tests/test_faults.py``'s
``TestCoordinatorConnect``, ``TestTrainerHardening`` and the
``FaultTolerantTrainer`` half of ``TestEndToEndSchedule``. No checkpoint
crosses between the packages: both train the same zip (written by the JAX
package) and their kill-and-resume outcomes are compared, the final losses
within 1e-5 relative. Each package's resumed run equals its own
uninterrupted run exactly. Under ranks (gloo worlds of 2): a
ParallelWrapper's checkpoints are written by rank 0 alone, a
TensorParallel's a shard a rank, and a crash at step 7 resumed from step 5
equals the uninterrupted 10 steps bit for bit (params and updater state).
The real rendezvous: two processes join through ``COORDINATOR_ADDRESS`` on
localhost.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import faults, monitoring
from deeplearning4j_tpu_torch.faults import (
    CoordinatorConnectFault, RetryPolicy,
)
from deeplearning4j_tpu_torch.parallel import launch

import torch_parallel_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TRAIN_SCRIPT = r"""
import sys, os
sys.path.insert(0, {repo!r})
import numpy as np
pkg, zip_path, ckpt_dir = sys.argv[1], sys.argv[2], sys.argv[3]
n_steps, crash_at = int(sys.argv[4]), int(sys.argv[5])
if pkg == "deeplearning4j_tpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
    from deeplearning4j_tpu.util.serialization import restore_model
    from deeplearning4j_tpu.parallel.distributed import FaultTolerantTrainer
    model = restore_model(zip_path)
else:
    from deeplearning4j_tpu_torch.util.serialization import restore_model
    from deeplearning4j_tpu_torch.parallel import FaultTolerantTrainer
    model = restore_model(zip_path, device="cpu")
trainer = FaultTolerantTrainer(model, ckpt_dir, save_every=5,
                               on_restore=lambda s: print(f"RESTORED {{s}}"))
rng = np.random.default_rng(0)
x = rng.normal(size=(16, 4)).astype(np.float32)
y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
while model.step_count < n_steps:
    trainer.fit_batch((x, y))
    if crash_at >= 0 and model.step_count == crash_at:
        trainer.checkpointer.wait()
        print(f"CRASHING at {{model.step_count}}", flush=True)
        os._exit(137)  # a host failure
trainer.checkpointer.save(model.step_count, model)
trainer.checkpointer.wait()
print(f"DONE {{model.step_count}} {{float(model.score_value)!r}}")
"""


def _jax_model(seed=3):
    from deeplearning4j_tpu.nn import (
        InputType, MultiLayerNetwork, NeuralNetConfiguration,
    )
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.optimize import Sgd

    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(lr=0.1))
            .list().layer(DenseLayer(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init()


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    from deeplearning4j_tpu.util.serialization import write_model

    path = str(tmp_path_factory.mktemp("ft") / "net.zip")
    write_model(_jax_model(), path)
    return path


def _run(pkg, zip_path, ckpt_dir, n_steps, crash_at):
    script = _TRAIN_SCRIPT.format(repo=ROOT)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", script, pkg, zip_path,
                           str(ckpt_dir), str(n_steps), str(crash_at)],
                          capture_output=True, text=True, env=env,
                          timeout=300)


def _port_model(zip_path):
    from deeplearning4j_tpu_torch.util.serialization import restore_model

    return restore_model(zip_path, device="cpu")


def _data(n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    return x, y


def _leaves(tree):
    from deeplearning4j_tpu_torch.common.trees import tree_leaves

    return [a.detach().cpu().numpy() for a in tree_leaves(tree)]


@pytest.fixture(autouse=True)
def _isolate():
    faults.reset()
    monitoring.reset()
    yield
    faults.reset()
    monitoring.reset()
    monitoring.disable()


class TestFaultTolerance:
    def test_kill_and_resume(self, tmp_path, zip_path):
        """Both packages killed at step 12 (checkpoints at 5, 10), then
        relaunched: each restores step 10 and finishes at 30; the final
        losses agree."""
        final = {}
        for pkg in ("deeplearning4j_tpu", "deeplearning4j_tpu_torch"):
            ckpt = tmp_path / pkg
            r1 = _run(pkg, zip_path, ckpt, 30, 12)
            assert r1.returncode == 137, r1.stderr[-2000:]
            assert "CRASHING at 12" in r1.stdout
            r2 = _run(pkg, zip_path, ckpt, 30, -1)
            assert r2.returncode == 0, r2.stderr[-2000:]
            assert "RESTORED 10" in r2.stdout
            assert "DONE 30" in r2.stdout
            final[pkg] = float(r2.stdout.strip().split()[-1])
        a, b = final.values()
        assert abs(a - b) <= 1e-5 * abs(a), final

    def test_corrupted_latest_checkpoint_resumes_previous(self, tmp_path,
                                                          zip_path):
        """The newest checkpoint torn: the relaunch falls back to the
        previous valid step (5)."""
        from deeplearning4j_tpu_torch.parallel import FaultTolerantTrainer

        ckpt = tmp_path / "ck"
        x, y = _data()
        model = _port_model(zip_path)
        tr = FaultTolerantTrainer(model, ckpt, save_every=5)
        while model.step_count < 12:
            tr.fit_batch((x, y))
        tr.checkpointer.wait()
        clipped = 0
        for dirpath, _dirs, files in os.walk(ckpt / "10"):
            for name in files:
                path = os.path.join(dirpath, name)
                size = os.path.getsize(path)
                if size > 16:
                    with open(path, "r+b") as f:
                        f.truncate(size // 2)
                    clipped += 1
        assert clipped, "nothing to corrupt under the step dir"
        relaunch = FaultTolerantTrainer(_port_model(zip_path), ckpt,
                                        save_every=5)
        assert relaunch.restored_step == 5

    def test_uninterrupted_run_equivalence(self, tmp_path, zip_path):
        """Crash exactly on a checkpoint step and resume: the same state
        as an uninterrupted run, bit for bit."""
        from deeplearning4j_tpu_torch.parallel import FaultTolerantTrainer

        x, y = _data()

        def train(ckpt, crash_at=None):
            model = _port_model(zip_path)
            tr = FaultTolerantTrainer(model, ckpt, save_every=5)
            while model.step_count < 20:
                tr.fit_batch((x, y))
                if model.step_count == crash_at:
                    tr.checkpointer.wait()
                    return None
            return model

        plain = train(tmp_path / "a")
        train(tmp_path / "b", crash_at=10)
        resumed = train(tmp_path / "b")
        for a, b in zip(_leaves((plain.params, plain.opt_state)),
                        _leaves((resumed.params, resumed.opt_state))):
            np.testing.assert_array_equal(a, b)
        assert float(plain.score_value) == float(resumed.score_value)


class TestDistributedInit:
    def test_single_process_summary(self, monkeypatch):
        from deeplearning4j_tpu_torch.parallel import initialize_distributed

        for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
            monkeypatch.delenv(k, raising=False)
        info = initialize_distributed()
        assert info == {"process_index": 0, "process_count": 1,
                        "local_devices": 1, "global_devices": 1}
        assert not torch.distributed.is_initialized()

    def test_two_processes_join_through_the_coordinator(self):
        """Two processes with COORDINATOR_ADDRESS / NUM_PROCESSES /
        PROCESS_ID on localhost join one gloo group and all-reduce."""
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        script = (
            "import sys, torch, torch.distributed as dist\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from deeplearning4j_tpu_torch.parallel import "
            "initialize_distributed\n"
            "info = initialize_distributed(device='cpu')\n"
            "t = torch.ones(1) * (info['process_index'] + 1)\n"
            "dist.all_reduce(t)\n"
            "print(sorted(info.items()), float(t[0]), flush=True)\n"
            "dist.destroy_process_group()\n")
        procs = [subprocess.Popen(
            [sys.executable, "-c", script], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}",
                     NUM_PROCESSES="2", PROCESS_ID=str(i)))
            for i in range(2)]
        outs = [p.communicate(timeout=120) for p in procs]
        for i, (p, (out, err)) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, err[-2000:]
            assert out.strip() == str(sorted(
                {"process_index": i, "process_count": 2,
                 "local_devices": 1, "global_devices": 2}.items())) + " 3.0"


class TestCoordinatorConnect:
    def test_connect_refusal_retried(self, monkeypatch):
        """Refused twice, connected at the third attempt, in both
        packages; the port's group joins a store at the address."""
        import jax

        from deeplearning4j_tpu import faults as jax_faults
        from deeplearning4j_tpu import monitoring as jax_monitoring
        from deeplearning4j_tpu.parallel.distributed import (
            initialize_distributed as jax_init,
        )
        from deeplearning4j_tpu_torch.parallel import distributed

        calls = {"jax": 0, "port": []}
        monkeypatch.setattr(jax.distributed, "initialize",
                            lambda **kw: calls.__setitem__(
                                "jax", calls["jax"] + 1))
        monkeypatch.setattr(distributed.launch, "init_rank",
                            lambda *a: calls["port"].append(a[:3]))
        monkeypatch.setattr(distributed.dist, "TCPStore",
                            lambda *a, **kw: ("store",) + a[:3])
        jax_monitoring.enable()
        monitoring.enable()
        try:
            with jax_faults.injected("coord_connect:2") as jplan:
                jax_init(coordinator_address="127.0.0.1:9", num_processes=1,
                         process_id=0, retry=jax_faults.RetryPolicy(
                             max_attempts=5, base_delay_s=0.001))
            jtext = jax_monitoring.metrics_text()
        finally:
            jax_monitoring.reset()
            jax_monitoring.disable()
        with faults.injected("coord_connect:2") as plan:
            info = distributed.initialize_distributed(
                coordinator_address="127.0.0.1:9", num_processes=1,
                process_id=0, device="cpu",
                retry=RetryPolicy(max_attempts=5, base_delay_s=0.001))
        assert calls["jax"] == 1 and calls["port"] == [(0, 1, "cpu")]
        assert plan.injected["coord_connect"] == jplan.injected[
            "coord_connect"] == 2
        assert info["process_count"] == 1
        line = ('dl4j_recovery_total{component="distributed",'
                'outcome="retried_ok"} 1')
        assert line in jtext and line in monitoring.metrics_text()

    def test_connect_refusal_exhaustion(self, monkeypatch):
        from deeplearning4j_tpu_torch.parallel import distributed

        monkeypatch.setattr(distributed.launch, "init_rank",
                            lambda *a: None)
        with faults.injected("coord_connect:99"):
            with pytest.raises(CoordinatorConnectFault):
                distributed.initialize_distributed(
                    coordinator_address="127.0.0.1:9", num_processes=1,
                    process_id=0, device="cpu",
                    retry=RetryPolicy(max_attempts=2, base_delay_s=0.001))

    def test_several_processes_need_an_address(self, monkeypatch):
        from deeplearning4j_tpu_torch.parallel import initialize_distributed

        monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
        with pytest.raises(ValueError, match="COORDINATOR_ADDRESS"):
            initialize_distributed(num_processes=2, process_id=0,
                                   device="cpu")


class TestTrainerHardening:
    def test_save_on_exception(self, tmp_path, zip_path):
        from deeplearning4j_tpu_torch.parallel import FaultTolerantTrainer

        monitoring.enable()
        trainer = FaultTolerantTrainer(_port_model(zip_path),
                                       tmp_path / "ck", save_every=1000)
        x, y = _data()

        class _Boom:
            def __iter__(self):
                yield (x, y)
                yield (x, y)
                raise RuntimeError("mid-epoch crash")

        with pytest.raises(RuntimeError, match="mid-epoch crash"):
            trainer.fit(_Boom())
        # save_every=1000 never fired; save-on-exception captured step 2
        assert trainer.checkpointer.all_steps() == [2]
        assert ('dl4j_recovery_total{component="trainer",'
                'outcome="save_on_error"} 1') in monitoring.metrics_text()
        trainer.close()

    def test_crash_loop_detector_bounds_restarts(self, tmp_path, zip_path):
        from deeplearning4j_tpu_torch.parallel import FaultTolerantTrainer

        x, y = _data()
        t = FaultTolerantTrainer(_port_model(zip_path), tmp_path / "ck",
                                 save_every=1)
        t.fit_batch((x, y))
        t.checkpointer.wait()
        t.close()
        for _ in range(3):
            FaultTolerantTrainer(_port_model(zip_path), tmp_path / "ck",
                                 max_restarts_without_progress=3).close()
        with pytest.raises(RuntimeError, match="crash loop"):
            FaultTolerantTrainer(_port_model(zip_path), tmp_path / "ck",
                                 max_restarts_without_progress=3)
        os.remove(tmp_path / "ck" / ".crashloop.json")
        FaultTolerantTrainer(_port_model(zip_path), tmp_path / "ck",
                             max_restarts_without_progress=3).close()

    def test_unwraps_parallel_facades_only(self, tmp_path, zip_path):
        from deeplearning4j_tpu_torch.parallel import (
            DeviceMesh, FaultTolerantTrainer, ParallelWrapper,
        )

        class Holder:
            def __init__(self, model):
                self.model = model
                self.params, self.state, self.opt_state = {}, {}, {}
                self.step_count = 0

        net = _port_model(zip_path)
        t = FaultTolerantTrainer(Holder(net), tmp_path / "h")
        assert t._target is not net
        with launch.local_group("cpu"):
            w = ParallelWrapper(net, DeviceMesh(device="cpu"))
            t = FaultTolerantTrainer(w, tmp_path / "w")
            assert t._target is net and t.writes

    def test_preempt_unmanaged_raises_and_saves(self, tmp_path, zip_path):
        """An injected preempt with no lifecycle manager propagates out of
        fit(), whose save-on-exception captures the step."""
        from deeplearning4j_tpu_torch.parallel import FaultTolerantTrainer

        x, y = _data()
        model = _port_model(zip_path)
        tr = FaultTolerantTrainer(model, tmp_path / "ck", save_every=100)
        with faults.injected("preempt:1@step==3"):
            with pytest.raises(faults.PreemptionFault):
                tr.fit([(x, y)] * 5)
        assert tr.checkpointer.all_steps() == [3]

    def test_lifecycle_emergency_save(self, tmp_path, zip_path):
        """register_lifecycle: a managed preemption drains at a batch
        boundary and the emergency checkpoint saves the current step."""
        from deeplearning4j_tpu_torch.parallel import FaultTolerantTrainer
        from deeplearning4j_tpu_torch.serving import lifecycle

        x, y = _data()
        model = _port_model(zip_path)
        tr = FaultTolerantTrainer(model, tmp_path / "ck", save_every=100)
        mgr = lifecycle.LifecycleManager(grace_s=10.0, exit_fn=lambda c: None)
        mgr.install(signals=())
        try:
            tr.register_lifecycle(mgr)
            with faults.injected("preempt:1@step==2"):
                tr.fit([(x, y)] * 6)
            mgr.preempted.wait(30)
            assert model.step_count == 2
            deadline = 0
            while tr.checkpointer.all_steps() != [2] and deadline < 300:
                import time

                time.sleep(0.1)
                deadline += 1
            assert tr.checkpointer.all_steps() == [2]
        finally:
            lifecycle.reset()


class TestEndToEndSchedule:
    def test_trainer_half_of_the_schedule(self, tmp_path, zip_path,
                                          monkeypatch):
        """One seeded schedule (coord_connect, data_io, ckpt_io and a
        corrupted last save): the faulted run equals the fault-free run,
        the relaunch restores the newest valid step (10), and every
        recovery is in dl4j_recovery_total, as in the JAX package."""
        from deeplearning4j_tpu_torch.datasets.iterators import (
            ArrayDataSetIterator,
        )
        from deeplearning4j_tpu_torch.parallel import (
            FaultTolerantTrainer, distributed,
        )

        monitoring.enable()
        x, y = _data(32, seed=1)

        def train(ckpt_dir):
            model = _port_model(zip_path)
            tr = FaultTolerantTrainer(model, ckpt_dir, save_every=2,
                                      keep_last=3)
            tr.fit(ArrayDataSetIterator(x, y, batch_size=8), epochs=3)
            tr.close()
            return model

        baseline = train(tmp_path / "plain")
        monkeypatch.setattr(distributed.launch, "init_rank",
                            lambda *a: None)
        spec = "coord_connect:1;data_io:1;ckpt_io:1;ckpt_corrupt:1@step==12"
        with faults.injected(spec, seed=5) as plan:
            distributed.initialize_distributed(
                num_processes=1, process_id=0, device="cpu",
                retry=RetryPolicy(max_attempts=3, base_delay_s=0.001))
            faulted = train(tmp_path / "faulted")
        assert plan.injected == {"coord_connect": 1, "data_io": 1,
                                 "ckpt_io": 1, "ckpt_corrupt": 1}
        for a, b in zip(_leaves(baseline.params), _leaves(faulted.params)):
            np.testing.assert_array_equal(a, b)
        relaunch = FaultTolerantTrainer(_port_model(zip_path),
                                        tmp_path / "faulted", save_every=2)
        assert relaunch.restored_step == 10
        relaunch.close()
        text = monitoring.metrics_text()
        for component in ("distributed", "data", "checkpoint"):
            assert f'component="{component}"' in text, component


class TestRanks:
    def test_kill_and_resume_under_ranks(self, tmp_path, zip_path):
        """Gloo worlds of 2: ParallelWrapper (replicated, rank 0 writes)
        and TensorParallel (sharded, each rank writes its shards); a crash
        after step 7 resumed from step 5 equals 10 uninterrupted steps bit
        for bit, params and updater state."""
        from deeplearning4j_tpu.nn import (
            InputType, MultiLayerNetwork, NeuralNetConfiguration,
        )
        from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
        from deeplearning4j_tpu.optimize import Adam

        conf = (NeuralNetConfiguration.builder().seed(6)
                .updater(Adam(lr=1e-2)).list()
                .layer(DenseLayer(n_out=8, activation="relu"))
                .layer(OutputLayer(n_out=4, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.feed_forward(6)).build())
        jnet = MultiLayerNetwork(conf).init()
        rng = np.random.default_rng(2)
        x = rng.normal(size=(8, 6)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]
        p = {"net": {"json": conf.to_json(), "kind": "mln",
                     "params": _np_tree(jnet.params),
                     "state": _np_tree(jnet.state)},
             "batch": (x, y), "dir": str(tmp_path)}
        outs = launch.run(ranks.ft_world, 2, device="cpu", args=(p,),
                          threads=1, timeout=300)
        for rank, out in enumerate(outs):
            for kind in ("wrapper", "tensor"):
                o = out[kind]
                assert o["restored"] == 5, (kind, o["restored"])
                plain, crash, resume = o["saves"]
                if kind == "wrapper" and rank:
                    assert plain == crash == resume == [], o["saves"]
                else:
                    assert plain == [5, 10] and crash == [5]
                    assert resume == [10]   # fit's closing save skips it
                for a, b in zip(
                        _np_leaves(o["plain"]) + _np_leaves(o["plain_opt"]),
                        _np_leaves(o["resumed"])
                        + _np_leaves(o["resumed_opt"])):
                    np.testing.assert_array_equal(a, b)
        assert sorted(n for n in os.listdir(tmp_path / "tensor_crash")
                      if not n.startswith(".")) == ["shard-0-of-2",
                                                    "shard-1-of-2"]


def _np_leaves(tree):
    import jax

    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)
