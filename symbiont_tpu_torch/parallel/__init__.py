"""Device-plane parallelism: mesh and sharding specs.

The port of `symbiont_tpu/parallel/` for the names ported so far (A15
stage 1); the JAX package's module map, for those names:

mesh       : named device meshes (axes: data, tensor) over this process's
             CUDA devices, or an explicit device list that may repeat a
             device (the counterpart of the JAX tests' 8 virtual CPU
             devices)
sharding   : placement rules — DP batch and corpus rows on 'data', TP rules
             for decoder LM params (heads / MLP hidden on 'tensor'),
             corpus-sharded top-k

One process owns the mesh over its local devices, as JAX's single-
controller `Mesh` is owned. Where XLA inserts the collectives in the JAX
package, the port's engines issue them as copies between devices and adds
(`sharding.sum_to`), which autograd carries as they stand.

`parallel/compat.py` (glue between JAX versions) has no counterpart.
Still to port: `init_distributed` and meshes that span processes over
`torch.distributed` (ROADMAP A15 multi-host), and `ring_attention`,
`ulysses`, `context` and `pipeline` (ROADMAP A15 stage 2).
"""

from symbiont_tpu_torch.parallel.mesh import (
    Mesh,
    build_mesh,
    local_device_count,
    mesh_from_config,
    parse_mesh_spec,
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

__all__ = [
    "Mesh",
    "NamedSharding",
    "P",
    "Sharded",
    "build_mesh",
    "local_device_count",
    "mesh_from_config",
    "parse_mesh_spec",
    "batch_sharding",
    "corpus_topk",
    "replicate",
    "gpt_param_sharding",
    "shard_params",
]
