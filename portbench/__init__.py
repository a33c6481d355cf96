"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of ProbeSim.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line.  Nothing here imports JAX or the JAX
package; ``reference/`` imports nothing of the port either.
"""
