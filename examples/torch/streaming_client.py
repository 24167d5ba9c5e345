"""Interactive streaming client on the PyTorch port — the twin of
``examples/streaming_client.py``: tokens arrive one at a time, the
moment the host learns them, instead of at request completion.

A ``StreamingServer`` (``repro_torch.launch.serve``) drives an
OVERLAPPED engine — decode step i+1 is dispatched before step i's tokens
are read back, so host delivery rides in the device's shadow — on a
background thread, while this client plays three chat conversations against
it concurrently: each consumer thread iterates ``server.stream(uid)``
and renders its tokens live with per-token latency (TTFT, then ITL).
At the end a plain (not overlapped) engine on the same weights serves
the same prompts as one batch, and its tokens must be the streamed ones.

Run: PYTHONPATH=src python examples/torch/streaming_client.py
[--device cpu] (the card by default).
"""

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import StreamingServer
from repro_torch.models import get_model
from repro_torch.serving import Request, ServingEngine

ARCH = "qwen3-32b"
PROMPTS = {"alice": 12, "bob": 7, "carol": 9}   # prompt lengths

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

cfg = get_config(ARCH, reduced=True)
bundle = get_model(cfg)
gen = torch.Generator(args.device).manual_seed(0)
params = bundle.init(gen)
eng = ServingEngine(bundle, params, max_slots=2, cache_len=96,
                    overlap=True, device=args.device)
server = StreamingServer(eng).start()
print(f"=== streaming server up: {ARCH} (reduced), 2 slots, "
      f"overlapped decode ===")

rng = np.random.default_rng(0)
lock = threading.Lock()
prompts = {}


def chat(name: str, plen: int) -> None:
    with lock:
        prompt = rng.integers(1, cfg.vocab - 2, plen).astype(np.int32)
    t_sub = time.monotonic()
    uid = server.submit(prompt, max_new_tokens=12)
    with lock:
        prompts[uid] = prompt
    last = t_sub
    for ev in server.stream(uid):
        now = time.monotonic()
        gap_ms = (now - last) * 1e3
        last = now
        tag = "TTFT" if ev.index == 0 else "itl "
        with lock:
            print(f"  [{name:5s}] token {ev.index:2d} = {ev.token:4d}  "
                  f"({tag} {gap_ms:7.1f} ms)"
                  f"{'   <final>' if ev.final else ''}")


threads = [threading.Thread(target=chat, args=(n, p), name=n)
           for n, p in PROMPTS.items()]
for t in threads:
    t.start()
for t in threads:
    t.join()

print("\n=== transcripts (exactly the streamed tokens, in order) ===")
for uid in sorted(server.engine.results):
    res = server.engine.results[uid]
    print(f"  uid {uid}: {len(res.output)} tokens  "
          f"preemptions={res.preemptions}  {res.output}")
server.shutdown()
print("server drained and stopped.")

batch = ServingEngine(bundle, params, max_slots=2, cache_len=96,
                      device=args.device)
for uid, prompt in prompts.items():
    batch.submit(Request(uid=uid, tokens=prompt, max_new_tokens=12))
batch.run()
for uid in prompts:
    assert batch.results[uid].output == server.engine.results[uid].output, \
        (uid, batch.results[uid].output, server.engine.results[uid].output)
print("a batch run of the same prompts gives the streamed tokens")
