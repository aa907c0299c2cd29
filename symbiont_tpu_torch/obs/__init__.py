"""The engine's observability hooks (own copies of the JAX package's
`symbiont_tpu/obs/` parts the engine records into).

device          : CUDA allocator statistics (`torch.cuda.memory_stats`)
hbm             : the device-memory claim ledger, `reconcile`, OOM guard
xprof           : the per-signature dispatch ledger and host-sync counts
engine_timeline : the engine timeline (decode steps, admits, finishes,
                  cancels; embed flushes, packing opportunity)
usage           : per-tenant usage metering
"""
