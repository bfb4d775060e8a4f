"""Multi-process execution on ``torch.distributed``: the port of the JAX
package's ``dgmc_tpu/parallel``.

The mapping: a JAX process drives a host's devices, a port process (a
rank) drives one card. JAX's ``jax.devices()`` becomes the world's ranks
and ``process_count`` the world size, so ``--num_processes`` counts ranks
and JAX's rule that ``--model_shards`` equal the total device count
becomes: ``--model_shards`` / ``--row_shards`` equal the world size (rows
over N ranks are always N processes). Backend: NCCL for CUDA tensors,
gloo for CPU tensors (and for ranks that share a card), an explicit
argument of :func:`initialize_distributed`. Device: ``cuda:<LOCAL_RANK>``
under torchrun, else ``cuda:<rank % device_count>``, unless the caller
asks for the CPU.

PyTorch has no GSPMD: each rank runs the port's own code on its part (a
batch slice, a row block, a target shard) and every cross-rank sum is
written out (:mod:`~dgmc_tpu_torch.parallel.comm`). JAX's ``compat.py``
(its ``shard_map`` / ``vma`` version shim) has no counterpart.
"""

from dgmc_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                          NamedSharding, make_mesh,
                                          batch_spec, corr_spec,
                                          corr_sharding)
from dgmc_tpu_torch.parallel.rules import (DEFAULT_STREAM_CHUNK,
                                           DEFAULT_TOPK_BLOCK,
                                           PartitionRules, corr_row_rules,
                                           match_partition_rules,
                                           replicated_rules, shard_tree,
                                           state_tree, streamed_rules,
                                           tree_shardings)
from dgmc_tpu_torch.parallel.sharding import (replicate, shard_batch,
                                              make_sharded_train_step,
                                              make_sharded_eval_step)
from dgmc_tpu_torch.parallel.topk import (corr_sharded_topk,
                                          sharded_topk_cols,
                                          sharded_topk_rows)
from dgmc_tpu_torch.parallel.distributed import (global_batch, host_obs_dir,
                                                 initialize_distributed,
                                                 is_coordinator,
                                                 local_batch_slice)

__all__ = [
    'initialize_distributed',
    'is_coordinator',
    'host_obs_dir',
    'global_batch',
    'local_batch_slice',
    'DATA_AXIS',
    'MODEL_AXIS',
    'make_mesh',
    'batch_spec',
    'corr_spec',
    'corr_sharding',
    'DEFAULT_TOPK_BLOCK',
    'PartitionRules',
    'match_partition_rules',
    'tree_shardings',
    'shard_tree',
    'replicated_rules',
    'corr_row_rules',
    'streamed_rules',
    'replicate',
    'shard_batch',
    'make_sharded_train_step',
    'make_sharded_eval_step',
    'sharded_topk_rows',
    'sharded_topk_cols',
    # The port's own names beside JAX's.
    'Mesh',
    'NamedSharding',
    'DEFAULT_STREAM_CHUNK',
    'state_tree',
    'corr_sharded_topk',
]
