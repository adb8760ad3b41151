"""Benchmark of the PyTorch/CUDA port ``bayesian_bm25_tpu_torch``: one
cell a run, ``python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, with the cells in ``BENCHMARK.json``."""
