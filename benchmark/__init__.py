"""The benchmark of gubernator_tpu_torch's engines on one H100: the harness
(harness.py), its command (run.py), the one traffic generator
(generator.py), the yardstick (yardstick.py), the plain references
(reference/) and, one file each, the configurations, traffic mixes, entry
modules and metric readers that BENCHMARK.json names."""
