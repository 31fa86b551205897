"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on an NVIDIA
card and prints the result as one JSON line.  Nothing here imports JAX or
the JAX package ``repro``; the plain reference (``reference.py``) imports
nothing of the program either.
"""
