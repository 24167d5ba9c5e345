"""Train a small LM end to end on the PyTorch port — the twin of
``examples/train_small_lm.py``: synthetic Markov corpus -> packed
batches -> AdamW train loop (one captured program) -> checkpoint in the
JAX package's layout -> restore -> greedy decode through the serving
engine, whose tokens from the restored weights must be those of the
trained weights before the save.

Run: PYTHONPATH=src python examples/torch/train_small_lm.py
[--device cpu] (the card by default).
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import PackedLMDataset
from repro_torch.models import get_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.training import init_train_state, make_train_step

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

cfg = get_config("yi-6b", reduced=True)
bundle = get_model(cfg)
params = bundle.init(torch.Generator(args.device).manual_seed(0))
state = init_train_state(params)
n_params = sum(p.numel() for p in params.parameters())
print(f"arch={cfg.arch_id}  params={n_params / 1e6:.2f}M")

ds = PackedLMDataset(cfg, batch=8, seq=32, seed=0)
step = make_train_step(bundle.loss, lr=3e-3, max_grad_norm=5.0,
                       remat=False, data_shards=1)

print("=== training 80 steps on the Markov corpus ===")
first_loss = None
for i in range(80):
    state, metrics = step(state, ds.next_batch())
    if first_loss is None:
        first_loss = float(metrics["ce_loss"])
    if i % 20 == 0 or i == 79:
        print(f"  step {i:3d}  loss={float(metrics['ce_loss']):.4f}  "
              f"gnorm={float(metrics['grad_norm']):.3f}")
final_loss = float(metrics["ce_loss"])
assert final_loss < first_loss - 0.5, "training did not descend"


def generate(weights):
    eng = ServingEngine(bundle, weights, max_slots=2, cache_len=64,
                        device=args.device)
    rng = np.random.default_rng(1)
    eng.submit(Request(uid=0, tokens=rng.integers(
        0, cfg.vocab - 2, 8).astype(np.int32), max_new_tokens=10))
    return eng.run()[0].output


trained = generate(state.params)
with tempfile.TemporaryDirectory() as tmp:
    print("=== checkpoint round-trip ===")
    save_checkpoint(tmp, 60, state)
    restored = restore_checkpoint(tmp, 60, state, device=args.device)
    for (n, a), (_, b) in zip(state.params.named_parameters(),
                              restored.params.named_parameters()):
        assert torch.equal(a, b), n
    print("  restored == saved")

print("=== serving the trained model ===")
out = generate(restored.params)
print(f"  generated: {out}")
assert out == trained, (out, trained)
print("train_small_lm OK")
