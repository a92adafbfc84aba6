"""The benchmark of the PyTorch and CUDA port: ``python bench_port/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` (see run.py)."""
