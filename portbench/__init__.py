"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on one
NVIDIA H100 a cell: ``python -m portbench.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` from the root of a checkout.  Cells,
metrics and bounds are in ``BENCHMARK.json``; configurations, traffic
mixes, per-layer metrics and drivers are files of their own here, found
by name (``spec.py``)."""
