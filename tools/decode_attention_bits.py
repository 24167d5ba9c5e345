#!/usr/bin/env python3
"""K3 (``decode_attention``) and K4 (``paged_decode_attention``) of
several checkouts, launched without the log-sum-exp, on the same seeded
inputs: are their outputs the same bits?

Each checkout root given runs in a process of its own that imports that
checkout's ``repro_torch`` (its kernels built from its own sources), on
the shapes of ``chip_smoke.py``'s phase 2 — Yi-6B's (4, 32, 4, 2048, 128)
cache and its paged pool of 16-row blocks on a permuted table, lengths
1, 37, 1500 and 2048, float32 and bfloat16 — and writes its outputs to
``build/decode_attention_bits/<n>.pt``; then every root's outputs
are compared with the first's, bit for bit.  E.g. a parent unpacked
under ``build/``:

    python3 tools/decode_attention_bits.py build/parent .

Prints the card's name and power limit, one line per case with the
roots that differ from the first (none: ``equal``), and exits 1 if any
does.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "decode_attention_bits"
B, H, KH, S, BS, D = 4, 32, 4, 2048, 16, 128
LENGTHS = (1, 37, 1500, 2048)


def run_one(root: Path, out: Path) -> int:
    """Every case with ``root``'s kernels; save the outputs to ``out``."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    got = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(25)
        q = torch.randn(B, H, D, generator=g).to(dev, dtype)
        k, v = (torch.randn(B, KH, S, D, generator=g).to(dev, dtype)
                for _ in range(2))
        t = S // BS
        perm = torch.randperm(B * t, generator=g) + 1
        tables = perm.view(B, t).to(dev, torch.int32)
        pools = []
        for x in (k, v):
            pool = torch.zeros(B * t + 1, KH, BS, D, dtype=dtype, device=dev)
            pool[tables.long().view(-1)] = x.view(B, KH, t, BS, D) \
                .transpose(1, 2).reshape(B * t, KH, BS, D)
            pools.append(pool)
        name = str(dtype)[6:]
        got[f"K3 {name}"] = ops.decode_attention(q, k, v, lengths).cpu()
        got[f"K4 {name}"] = ops.paged_decode_attention(
            q, *pools, tables, lengths).cpu()
    torch.cuda.synchronize()
    torch.save(got, out)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        return run_one(Path(argv[1]).resolve(), Path(argv[2]))
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    files = []
    for i, root in enumerate(argv):
        files.append(OUT / f"{i}.pt")
        subprocess.run([sys.executable, __file__, "--one", root,
                        str(files[-1])], check=True)
    import torch
    runs = [torch.load(f) for f in files]
    differ = False
    for case in runs[0]:
        bad = [argv[i] for i, r in enumerate(runs)
               if not torch.equal(r[case], runs[0][case])]
        differ |= bool(bad)
        print(json.dumps({"case": case, "roots": argv,
                          "differ_from_first": bad or "equal"}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
