"""The benchmark of ``debiasing_multi_modal_tpu_torch`` on NVIDIA H100 cards.

``python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of the root ``BENCHMARK.json`` and prints one JSON result line
(``README.md`` in this folder).  Nothing here imports ``jax`` or the JAX
package.
"""
