"""Per-layer metric readers, one file each, found by the metric's name in
BENCHMARK.json. A reader defines `read(ctx)`, which returns the metric's
value from a traced run, or None when it finds nothing to read (the
harness then leaves the metric out of the line). `ctx` is
gpubench.harness.TraceContext: the parsed trace of `calls` profiled
requests of `rows` chunks over `cards` cards, the configuration, and the
untraced rest of the window (`window_chunks`,
`window_s`)."""
