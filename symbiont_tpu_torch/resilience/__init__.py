"""The port's resilience plane, copies of the JAX package's modules:
`admission` (quotas, fair queues, deadlines, the degradation ladder),
`dlq` (the dead-letter store behind `GET /api/dlq`), `faults` (seeded
fault injection), `supervisor` (restart-with-backoff for service loops),
`breaker` and `stores` (the circuit breaker and the spill wrappers of the
external stores), `procsup` (the process supervisor), `autoscale` (the
elastic autoscaler and its drains) and `genlog` (the generation journal)."""
