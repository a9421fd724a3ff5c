"""The benchmark's harness: finding a cell's files by name (`registry`),
turning a configuration and a seed into the inputs both sides read
(`scenes`), reducing a profiler trace to per-layer numbers (`trace`),
and running one cell once (`runner`)."""
