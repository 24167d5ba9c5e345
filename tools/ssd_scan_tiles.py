#!/usr/bin/env python3
"""K8 (``ssd_scan``) at every tiling its wrapper could pick, on the card.

``kernels.ssd_scan.tiling`` picks the output kernel's row tile and the
chunk-state kernel's column range from the shape.  This times the kernel
(CUDA-graph replay, ``chip_smoke.time_ms``) at each (row_tile, n_cols)
on the main path's shapes — Mamba2-780m's one-shot prefill of 512 and its
chunk step of 128 with a carried state, Zamba2-1.2B's prefill, float32 at
512 and at one chunk — checks each against the plain version, and marks
the wrapper's choice.  Run from the root of a checkout on a machine with
an H100 (about 1 minute):

    python3 tools/ssd_scan_tiles.py
"""

import itertools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import ref, ssd_scan as K8  # noqa: E402

# (b, s, h, p, g, n, dtype, h0)
SHAPES = [(1, 512, 48, 64, 1, 128, torch.bfloat16, False),
          (1, 128, 48, 64, 1, 128, torch.bfloat16, True),
          (1, 512, 64, 64, 1, 64, torch.bfloat16, False),
          (1, 512, 48, 64, 1, 128, torch.float32, True),
          (1, 128, 48, 64, 1, 128, torch.float32, True)]


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_scan_tiles.py: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    chosen = K8.tiling
    for b, s, h, p, g, n, dtype, h0 in SHAPES:
        rng = np.random.default_rng(0)
        t = lambda shape: torch.from_numpy(                    # noqa: E731
            rng.normal(0, 1, shape).astype(np.float32)).to(dev)
        x, bm, cm = (t(shape).to(dtype)
                     for shape in ((b, s, h, p), (b, s, g, n), (b, s, g, n)))
        dt = torch.from_numpy(rng.uniform(0.001, 0.1, (b, s, h)).astype(
            np.float32)).to(dev)
        a = -torch.from_numpy(rng.uniform(0.5, 2.0, h).astype(
            np.float32)).to(dev)
        st = t((b, h, p, n)) if h0 else None
        want_y, want_s = ref.ssd_scan_ref(x, dt, a, bm, cm, chunk=128, h0=st)
        pick = chosen(s, h, p, n, 128, dtype)
        times = {}
        for tiles in itertools.product((128, 64, 32, 16), (64, 32, 16)):
            if tiles[0] > K8.MAX_ROW_TILE[dtype]:
                continue
            K8.tiling = lambda *args, tiles=tiles: tiles   # noqa: E731
            y, state = K8.ssd_scan_cuda(x, dt, a, bm, cm, chunk=128, h0=st)
            torch.cuda.synchronize()
            if not (torch.allclose(y.float(), want_y.float(), atol=5e-4,
                                   rtol=2.0 ** -7)
                    and torch.allclose(state, want_s, atol=5e-4,
                                       rtol=1e-3)):
                raise AssertionError(f"K8 at tiles {tiles} disagrees with "
                                     f"the plain version")
            times[tiles], _ = chip_smoke.time_ms(torch, lambda: K8.ssd_scan_cuda(
                x, dt, a, bm, cm, chunk=128, h0=st))
        K8.tiling = chosen
        print(f"{(b, s, h, p, g, n)} {str(dtype)[6:]}{' h0' if h0 else ''}: "
              + ", ".join(f"{k}{'*' if k == pick else ''} {v * 1e3:.2f} us"
                          for k, v in times.items()), flush=True)
    print("(* the wrapper's choice; CUDA-graph replay, µs a call)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
