"""One file per metric: its unit, layer, source, the end-to-end metric it
moves, which way is better, and ``read(run)``, which takes the number from
the run's record (``run.RunRecord``) or returns None where the run holds
nothing to read. The harness loads the files named in BENCHMARK.json."""
