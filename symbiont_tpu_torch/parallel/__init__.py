"""Device-plane parallelism: mesh, sharding specs, sequence and pipeline
parallel training.

The port of `symbiont_tpu/parallel/`; the JAX package's module map:

mesh       : named device meshes (axes: data, tensor) over this process's
             CUDA devices, or an explicit device list that may repeat a
             device (the counterpart of the JAX tests' 8 virtual CPU
             devices); `init_distributed` joins processes into one world
             over `torch.distributed`, and a mesh over the world's devices
             spans processes
sharding   : placement rules — DP batch and corpus rows on 'data', TP rules
             for decoder LM params (heads / MLP hidden on 'tensor'),
             corpus-sharded top-k
ring_attention : sequence-parallel blockwise attention: K/V blocks travel
             round the entries of an axis while a streaming softmax
             accumulates (long context)
context    : sequence-parallel decoder LM *training* — the train-time
             forward with activations split on the sequence dim and exact
             causal attention over the ring or Ulysses (gpt_forward_sp /
             lm_loss_sp / make_lm_train_step_sp)
ulysses    : the all-to-all sequence-parallel scheme — trade sequence
             blocks for head shards, run the flash kernels over the whole
             sequence, trade back (exact, as the ring; pick per workload)
pipeline   : GPipe pipeline parallelism — layer stages split over a 'pipe'
             axis, microbatch activations handed from stage to stage
             (stack_layers / shard_pp_params / lm_loss_pp /
             make_lm_train_step_pp / make_pp_train_state; exact against the
             plain step)

One process owns the mesh over its local devices, as JAX's single-
controller `Mesh` is owned. Where XLA inserts the collectives in the JAX
package (psum, all-gather, all-to-all, ppermute), the port issues them as
copies between devices and adds (`sharding.sum_to`), which autograd
carries as they stand.

Across processes (A15 multi-host, after `init_distributed`) each process
holds and computes only its own entries of a mesh, and a sum over a line
of the mesh that crosses processes is an all-reduce over that line's
process group, with autograd (`sharding.all_reduce`). The data- and
tensor-parallel LM train step (`train/trainer.shard_lm_train_state`,
`lm_train_step`) runs there; serving and the SP/PP steps over such a mesh
raise, naming ROADMAP's "A15 multi-host serving" and "SP/PP across
processes".

`parallel/compat.py` (glue between JAX versions) has no counterpart.
"""

from symbiont_tpu_torch.parallel.mesh import (
    Mesh,
    build_mesh,
    init_distributed,
    local_device_count,
    mesh_from_config,
    parse_mesh_spec,
    shutdown_distributed,
    world_devices,
)
from symbiont_tpu_torch.parallel.sharding import (
    NamedSharding,
    P,
    Sharded,
    batch_sharding,
    corpus_topk,
    gpt_param_sharding,
    replicate,
    shard_params,
)
from symbiont_tpu_torch.parallel.context import (
    gpt_forward_sp,
    lm_loss_sp,
    make_lm_train_step_sp,
)
from symbiont_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_attention_sharded,
)
from symbiont_tpu_torch.parallel.ulysses import (
    ulysses_attention,
    ulysses_attention_sharded,
)
from symbiont_tpu_torch.parallel.pipeline import (
    lm_loss_pp,
    make_lm_train_step_pp,
    make_pp_train_state,
    shard_pp_params,
    stack_layers,
)

__all__ = [
    "Mesh",
    "NamedSharding",
    "P",
    "Sharded",
    "build_mesh",
    "init_distributed",
    "shutdown_distributed",
    "world_devices",
    "local_device_count",
    "mesh_from_config",
    "parse_mesh_spec",
    "batch_sharding",
    "corpus_topk",
    "replicate",
    "gpt_param_sharding",
    "shard_params",
    "gpt_forward_sp",
    "lm_loss_sp",
    "make_lm_train_step_sp",
    "ring_attention",
    "ring_attention_sharded",
    "ulysses_attention",
    "ulysses_attention_sharded",
    "lm_loss_pp",
    "make_lm_train_step_pp",
    "make_pp_train_state",
    "stack_layers",
    "shard_pp_params",
]
