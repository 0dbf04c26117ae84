"""Benchmark of the PyTorch port (``unet_tpu_torch``) on an NVIDIA H100.

``python bench_h100/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell and prints one JSON line. Everything a
cell needs is found by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``) and its traffic
(``traffic/<mix>.json``, which names its driver ``drivers/<driver>.py``);
each per-layer metric of ``BENCHMARK.json`` is read by
``metrics/<metric>.py``. The yardstick (roofline arithmetic, slice
generator, the plain reference and the comparison) lives here, apart from
the program, and imports neither JAX nor the JAX package.
"""
