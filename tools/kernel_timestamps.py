#!/usr/bin/env python3
"""Where the time of one K3 launch goes, block by block, on the card.

A profile gives a kernel's whole time; to see where the time goes inside
one launch this script builds a copy of K3 (``src/repro_torch/kernels/csrc/decode_attention.cu``)
with ``%globaltimer`` stamps at the ends of its phases, launches it at
Yi-6B's decode shape (B 4, H 32, KH 4, S 2048, D 128, lengths 1, 37,
1500, 2048) in bfloat16 and float32, and prints, for the blocks of the
two long rows, each stamp in ns after the kernel's first one:

  0 start, 1 the run's span known, 2 the tile's rows in shared memory,
  3 the part's (m, l, acc) computed, 4 written, 5 the parts combined,
  6 the run's partial written and fenced, 7 the last block known,
  8 partials staged, 9 weights, 10 outputs written

(the CUDA-core path for float32 stamps 0-2 and 4-7).  Stamps come from
thread 0 of each block, so phases 2-3 are its warp's.  The copy is built
under ``build/kernel_timestamps/`` and nothing in the package changes.
The stamps sit at named lines of the source; when the source moves on,
the script stops with the line it could not find.  Run from the root of
a checkout on a machine with a card and nvcc::

    python3 tools/kernel_timestamps.py
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "kernel_timestamps"

DEFINE = """
__device__ unsigned long long g_stamp[8192][12];
#define STAMP(i) do { if (threadIdx.x == 0) { unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
  g_stamp[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + \\
          blockIdx.x][i] = t_; } } while (0)
"""

# (line of the source, stamp, before the line?, at every occurrence?)
STAMPS = [
    ("  bf16* o = out + bh0 * D;\n", 0, False, False),
    ("  TQ* o = out + bh0 * D;                // the G heads' rows, "
     "contiguous\n", 0, False, False),
    ("  const int ldq = D + 8;\n", 1, False, False),
    ("  const int base = run * RUN;\n\n  // the warp pair", 1, None, False),
    ('    asm volatile("bar.sync %0, 64;\\n" ::"r"(1 + t) : "memory");'
     "  // rows in\n", 2, False, False),
    ("  const int jr = r0 + lane;             // this lane's key row", 2,
     True, False),
    ("  // each part's (m, l, acc) for the heads < G;", 3, True, False),
    ("  combine_parts(wacc, L.lda, wm, wl,", 4, True, True),
    ("  finish(wacc, L.lda, rm, rl,", 5, True, True),
    ("  __threadfence();                      // partials visible before "
     "arrival\n  __syncthreads();\n", 6, False, False),
    ("  if (!*flag) return;\n  __threadfence();\n", 7, False, False),
    ("    // the weights exp(m_r - m), one a thread, then each head's l", 8,
     True, False),
    ("    // four consecutive columns of one head a thread", 9, True, False),
    ("        store(o + g * D + d0 + e, l == 0.f ? 0.f : sum[e] / l);\n"
     "    }\n", 10, False, False),
]


def instrumented_header() -> str:
    src = (CSRC / "decode_attention.cuh").read_text()
    src = src.replace("namespace decode_attn {\n",
                      "namespace decode_attn {\n" + DEFINE, 1)
    for line, i, before, every in STAMPS:
        if line not in src:
            sys.exit(f"kernel_timestamps: the source no longer has {line!r}")
        stamp = f"  STAMP({i});\n"
        if before is None:              # after the first of its two lines
            head, _, tail = line.partition("\n")
            new = head + "\n" + stamp + tail
        else:
            new = stamp + line if before else line + stamp
        src = src.replace(line, new) if every else src.replace(line, new, 1)
    return src


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "decode_attention.cuh").write_text(instrumented_header())
    shutil.copy(CSRC / "async_copy.cuh", OUT)
    cu = (CSRC / "decode_attention.cu").read_text() + (
        '\nextern "C" int stamps(void* dst) {\n'
        "  return (int)cudaMemcpyFromSymbol(dst, decode_attn::g_stamp,\n"
        "                                   sizeof(decode_attn::g_stamp));\n"
        "}\n"
        'extern "C" int clear_stamps() {\n'
        "  void* p = nullptr;\n"
        "  cudaGetSymbolAddress(&p, decode_attn::g_stamp);\n"
        "  return (int)cudaMemset(p, 0, sizeof(decode_attn::g_stamp));\n"
        "}\n")
    (OUT / "decode_attention.cu").write_text(cu)
    lib = OUT / "decode_attention.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(OUT / "decode_attention.cu")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_timestamps: no CUDA device", file=sys.stderr)
        return 2
    lib = build()
    from repro_torch.kernels import decode_attention as K3
    fn = lib.decode_attention_launch
    fn.argtypes = K3._ARGTYPES
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    b, h, kh, s, d = 4, 32, 4, 2048, 128
    lengths = torch.tensor([1, 37, 1500, 2048], dtype=torch.int32,
                           device=dev)
    nrun = -(-s // K3.RUN)
    g = torch.Generator().manual_seed(3)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn(b, h, d, generator=g).to(dev, dt)
        k, v = (torch.randn(b, kh, s, d, generator=g).to(dev, dt)
                for _ in range(2))
        ws = torch.empty(b * h * nrun * (d + 2), device=dev)
        out = torch.empty_like(q)
        counters = torch.zeros(b * kh, dtype=torch.int32, device=dev)
        for i in range(5):              # four warm-ups, then the one read
            if i == 4:
                torch.cuda.synchronize()
                if lib.clear_stamps() != 0:
                    raise RuntimeError("could not clear the stamps")
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
                    counters.data_ptr(), b, h, kh, s, d, d ** -0.5, 0, 0,
                    int(dt == torch.bfloat16),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        torch.cuda.synchronize()
        buf = np.zeros((8192, 12), dtype=np.uint64)
        if lib.stamps(ctypes.c_void_p(buf.ctypes.data)) != 0:
            raise RuntimeError("could not read the stamps")
        st = buf[:nrun * kh * b].astype(np.int64)
        t0 = st[:, 0][st[:, 0] > 0].min()
        print(f"{dt}: kernel span {st[st > 0].max() - t0} ns; per block, "
              f"stamps 0-10 in ns ('-': not reached)")
        for blk in range(nrun * kh * b):
            run, kv, row = blk % nrun, (blk // nrun) % kh, blk // (nrun * kh)
            if kv == 0 and row in (2, 3) and st[blk][0] > 0:
                print(f"  b{row} run {run:2d} " + " ".join(
                    f"{x - t0:6d}" if x > 0 else "     -"
                    for x in st[blk][:11]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
