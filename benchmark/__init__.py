"""The benchmark of torbi_tpu_torch on CUDA cards (``run.py``).

The cells, metrics and configurations are data: ``BENCHMARK.json`` at the
root of the checkout names them, and the harness finds each by its name
under this folder (``spec.py``). Nothing here imports JAX or the JAX
package; ``reference/`` imports nothing of torbi_tpu_torch either.
"""
