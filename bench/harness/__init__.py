"""The benchmark's harness: cells resolved by name from ``BENCHMARK.json``,
traffic and weights drawn from the seed, the wall-clock driver, the
traced run's spans and device trace, and the check that decides
``correct``.  It drives ``repro_torch`` and imports neither JAX nor the
JAX package."""
