"""The benchmark of ``amf_tpu_torch``, the PyTorch and CUDA port.

Data-driven: ``BENCHMARK.json`` names the cells; each configuration,
traffic mix and metric is a file of its own here, found by its name
(``portbench/README.md``). Nothing here imports JAX or the JAX package.
"""
