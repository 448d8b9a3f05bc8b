"""The benchmark of stratum_tpu_torch, the PyTorch and CUDA port.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card it is started on and prints
one JSON result line. Nothing here imports JAX or the JAX package.
"""
