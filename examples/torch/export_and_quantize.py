"""The Figure-1 model-export workflow on the PyTorch port — the twin of
``examples/export_and_quantize.py``: build a training graph (with
dropout), strip training ops, fold constants, calibrate on a
representative dataset, quantize to INT8, and compare float vs INT8
accuracy and arena footprint — then compile the model blob to a C-style
source array (the no-filesystem deployment path, §4.3.1).

Run: PYTHONPATH=src python examples/torch/export_and_quantize.py
[--device cpu] (the card by default).
"""

import argparse

import numpy as np

from repro_torch.apps import build_vww
from repro_torch.apps.models import representative_dataset
from repro_torch.core import (AllOpsResolver, MicroInterpreter, MicroModel,
                              export)
from repro_torch.core.schema import model_to_source

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

resolver = AllOpsResolver()
gb = build_vww()
ds = representative_dataset(gb, n=8)

print("=== export: float vs INT8 (post-training quantization) ===")
float_blob = export(gb)
q_blob = export(build_vww(), representative_dataset=ds,
                quantize_int8=True)
print(f"  float blob: {len(float_blob) / 1024:.1f} KiB")
print(f"  int8 blob:  {len(q_blob) / 1024:.1f} KiB "
      f"({len(float_blob) / len(q_blob):.2f}x smaller)")

fm, qm = MicroModel(float_blob), MicroModel(q_blob)
rng = np.random.default_rng(0)
x = rng.normal(0, 1, (1, 96, 96, 1)).astype(np.float32)

outs = {}
for tag, model in (("float", fm), ("int8", qm)):
    size = MicroInterpreter.required_arena_size(model, resolver)
    it = MicroInterpreter(model, resolver, size, device=args.device)
    it.set_input(0, x)
    it.invoke()
    outs[tag] = it.output(0)
    used = it.arena_used_bytes()
    print(f"  {tag:5s}: arena={size / 1024:.1f} KiB "
          f"(persistent {used['persistent'] / 1024:.1f}, "
          f"nonpersistent {used['nonpersistent'] / 1024:.1f})")

err = float(np.max(np.abs(outs["float"] - outs["int8"])))
print(f"  max |float - int8| on softmax outputs: {err:.4f}")
assert err < 0.25, "quantization error too large"

print("=== compile blob to a C array (no file system on target) ===")
src = model_to_source(q_blob, "vww_model")
print("  " + src.splitlines()[0])
print(f"  {len(src.splitlines())} lines, deployable as a .c file")
print("export_and_quantize OK")
