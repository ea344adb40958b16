"""Parallelism (counterpart of ``deeplearning4j_tpu/parallel``).

The JAX package runs one SPMD program over a ``jax.sharding.Mesh``, where
XLA inserts the collectives. The port takes that package's multi-process
form as its only form:

- one process a rank and one card a process (local rank ->
  ``cuda:<local rank>``), joined by ``torch.distributed``: NCCL on the card,
  gloo when the caller asks for the CPU, never a fallback from one to the
  other (:mod:`.launch` spawns the ranks, as ``jax.distributed`` joins the
  JAX package's hosts);
- :class:`DeviceMesh` over ``torch.distributed.device_mesh`` with the JAX
  axis names ("data", "model", "pipe", "seq");
- every rank calls the same entry point (``wrapper.fit_batch(ds)``) with the
  same global host batch and takes its slice by rank;
- the collectives that sit inside a forward pass are differentiable
  (:mod:`.collectives`), and a data-parallel step reaches the other
  replicas through the train step's hook (``nn/replicas.py``).

The whole of the JAX package's surface: the mesh, data parallelism
(:class:`ParallelWrapper`), tensor and expert parallelism, ring / zig-zag /
Ulysses sequence parallelism on the flash kernels' block primitives, GPipe
and HeteroPipe pipelines (:mod:`.pipeline`, replayable on one card),
threshold-encoded gradient sharing, parameter averaging (local SGD), the
Spark shims over both (:mod:`.spark`), :func:`initialize_distributed` and
the checkpoint-restart :class:`FaultTolerantTrainer` (:mod:`.distributed`),
and :mod:`.inference`, the request batching in front of a model's
``output()``, whose synchronous ``output`` is collective over a mesh's
"data" axis.
"""

from deeplearning4j_tpu_torch.parallel.compression import (
    EncodedGradientTrainer, message_density, threshold_encode,
)
from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.distributed import (
    FaultTolerantTrainer, initialize_distributed,
)
from deeplearning4j_tpu_torch.parallel.expert import (
    init_moe_params, moe_param_specs, place_moe_params, switch_moe,
)
from deeplearning4j_tpu_torch.parallel.inference import (
    DeadlineExceeded, ParallelInference, resolve,
)
from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh, multi_slice_mesh
from deeplearning4j_tpu_torch.parallel.param_averaging import (
    ParameterAveragingTrainer,
)
from deeplearning4j_tpu_torch.parallel.pipeline import (
    GPipe, HeteroPipe, graph_stage_fn, pack_stage_params,
    pipeline_train_step, stack_stage_params, unpack_stage_params,
)
from deeplearning4j_tpu_torch.parallel.sequence import (
    ring_attention, ring_attention_zigzag, sequence_parallel_encoder,
    ulysses_attention, zigzag_shard, zigzag_unshard,
)
from deeplearning4j_tpu_torch.parallel.spark import (
    ParameterAveragingTrainingMaster, RoundSupervisor, SharedTrainingMaster,
    SparkComputationGraph, SparkDl4jMultiLayer,
)
from deeplearning4j_tpu_torch.parallel.tensor_parallel import TensorParallel

__all__ = ["DeviceMesh", "multi_slice_mesh", "ParameterAveragingTrainer",
           "ParallelWrapper", "ParallelInference", "DeadlineExceeded",
           "resolve", "TensorParallel", "GPipe", "HeteroPipe",
           "graph_stage_fn", "pack_stage_params", "pipeline_train_step",
           "stack_stage_params", "unpack_stage_params", "init_moe_params",
           "moe_param_specs", "place_moe_params", "switch_moe",
           "FaultTolerantTrainer", "initialize_distributed",
           "SparkDl4jMultiLayer", "SparkComputationGraph",
           "ParameterAveragingTrainingMaster", "SharedTrainingMaster",
           "RoundSupervisor", "ring_attention", "ring_attention_zigzag",
           "ulysses_attention", "sequence_parallel_encoder", "zigzag_shard",
           "zigzag_unshard", "EncodedGradientTrainer", "threshold_encode",
           "message_density"]
