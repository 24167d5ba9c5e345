"""Quickstart: the paper's four-step application flow (§4.1), end to
end on the conv reference model, on the PyTorch port — the twin of
``examples/quickstart.py``.

  1. build an OpResolver (links only the ops the model needs),
  2. supply a fixed-size arena,
  3. create the interpreter (ALL allocation happens here),
  4. set inputs -> invoke -> read outputs.

Run: PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
(the card by default).
"""

import argparse

import numpy as np

from repro_torch.apps import build_conv_reference
from repro_torch.core import (MicroInterpreter, MicroModel,
                              MicroMutableOpResolver, export)
from repro_torch.core.schema import OpCode

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

# --- export: TF-Lite-style toolchain (Figure 1) -------------------------
gb = build_conv_reference()
blob = export(gb)                       # µFB single-blob serialization
model = MicroModel(blob)
print(f"model blob: {len(blob)} bytes "
      f"({len(model.operators)} ops, {len(model.tensors)} tensors)")

# --- step 1: OpResolver — link exactly what the model uses --------------
resolver = MicroMutableOpResolver()
for op in (OpCode.CONV_2D, OpCode.MAX_POOL_2D, OpCode.MEAN,
           OpCode.FULLY_CONNECTED, OpCode.SOFTMAX, OpCode.RESHAPE):
    resolver.add(op)

# --- step 2+3: arena + interpreter (init-time allocation only) ----------
arena_size = MicroInterpreter.required_arena_size(model, resolver)
print(f"planned arena: {arena_size} bytes")
interp = MicroInterpreter(model, resolver, arena_size, device=args.device)
print(interp.memory_report())

# --- step 4: invoke ------------------------------------------------------
rng = np.random.default_rng(0)
x = rng.normal(0, 1, interp.input_spec(0).shape).astype(np.float32)
interp.set_input(0, x)
interp.invoke()
probs = interp.output(0)
print("class probabilities:", np.round(probs.ravel(), 3))
assert abs(float(probs.sum()) - 1.0) < 1e-3
print("quickstart OK")
