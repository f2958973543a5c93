"""User-facing utilities (placement groups; the runtime's metrics,
tracing, chaos and profiling helpers) and the port's flight recorders,
step profiler and analytic FLOP accounting."""
