"""Host-side utilities of the port.

telemetry : trace headers and spans, the metrics registry (counters,
            gauges, histograms) and the torch.profiler hook `maybe_profile`
ids       : uuids and timestamps (copy of the JAX package's module)
retry     : jittered back-off (copy of the JAX package's module)
"""
