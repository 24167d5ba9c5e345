"""repro_torch — the PyTorch/CUDA port of the TF-Micro-style system.

It sits beside the JAX package ``repro`` (the frozen reference) with the
same sub-package layout: ``core`` (schema, arena, planner, resolver,
quantization, exporter, executor, interpreter), ``apps`` (the §5 model
builders) and ``kernels`` (hand-written CUDA kernels for Hopper, each
beside its plain PyTorch version).  It imports torch and numpy, never jax
and nothing of ``repro``.
"""
