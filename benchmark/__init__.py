"""The benchmark of ``shift_gcn_torch`` on NVIDIA H100 cards.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line; see ``run.py``.  Nothing here imports JAX or the JAX package.
"""
