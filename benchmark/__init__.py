"""The port's benchmark: ``python -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``run.py``). Everything of one
configuration, traffic mix or per-layer metric lives in a file of its own
under this folder, found by the name ``BENCHMARK.json`` gives it."""
