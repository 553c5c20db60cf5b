"""The benchmark's general code: cells resolved by name from
`BENCHMARK.json`, the traffic generator, the two entry points,
the trace reduction, the import guard and the report."""
