"""Hand-written CUDA kernels for Hopper — the CMSIS-NN vendor-library
analogue (paper §4.7–4.8).  Importing the package registers the
``tag="cuda"`` implementations with the port's op registry (``ops.py``);
``ref.py`` holds the plain PyTorch version every kernel is held against.

Kernels (each: ``<name>.py`` launcher with its ``launches`` count +
``csrc/<name>.cu``, built with nvcc for sm_90a at first use by
``_build.py``):

  * quant_matmul     — K1, int8 matmul + requant (the TFLM hot spot)
  * flash_attention  — K2, causal/GQA/sliding-window prefill attention
  * decode_attention — K3, one new token per sequence vs a KV cache
    (the dense serving decode step)
  * paged_decode_attention — K4, K3 through a block table over a shared
    pool of KV blocks (the paged serving decode step)
  * dequant_matmul   — K5 (int8) and K6 (packed int4): float activations
    times quantized weights, the quantized decode step's MLP
  * paged_decode_attention_q — K7, K4 over an int8 KV pool with one
    scale per row (the paged int8-KV decode step)
  * ssd_scan         — K8, the Mamba-2 SSD chunked scan with a carried
    state (the ssm and hybrid prefill and prefill-chunk steps)
"""

from . import ops  # noqa: F401  (registers the "cuda" tag)
