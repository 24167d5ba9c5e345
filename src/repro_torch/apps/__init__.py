"""Reference TinyML applications from the paper's evaluation (§5.1), the
PyTorch package's copy:

* ``conv_reference`` — "an even smaller reference convolution model
  containing just two convolution layers, a max-pooling layer, a dense
  layer, and an activation layer" (§5.3, Table 2),
* ``hotword`` — a Google-Hotword-class keyword-spotting model (SVDF
  stack; the paper uses scrambled weights, we use seeded random ones),
* ``vww`` — a Visual-Wake-Words-class person-detection MobileNet-v1
  (Chowdhery et al. 2019) at 96×96×1.
"""

from .models import (build_conv_reference, build_fc_stack, build_hotword,
                     build_vww, paper_models)

__all__ = ["build_conv_reference", "build_fc_stack", "build_hotword",
           "build_vww", "paper_models"]
