"""Host-side utilities of the port.

telemetry : the metrics registry (counters, gauges, histograms) and the
            torch.profiler hook `maybe_profile`
"""
