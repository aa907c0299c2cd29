"""The port's resilience plane, copies of the JAX package's modules:
`admission` (quotas, fair queues, deadlines, the degradation ladder),
`dlq` (the dead-letter store behind `GET /api/dlq`), `faults` (seeded
fault injection) and `supervisor` (restart-with-backoff for service
loops). The breaker, the store wrappers, the process supervisor, the
autoscaler and the generation journal are ROADMAP A8 stage 2."""
