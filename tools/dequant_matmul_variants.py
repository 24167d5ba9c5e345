#!/usr/bin/env python3
"""Where K5's and K6's time goes: the kernel against copies of itself
with one part taken out, on the card.

Builds copies of ``src/repro_torch/kernels/csrc/dequant_matmul.cu`` under
``build/dequant_variants/``, each with named lines replaced, and times
every copy at the decode step's two shapes, (4, 4096, 11008) and (4,
11008, 4096), with the weight warm in L2 and out of it (each call on the
next of enough copies to hold 150 MB), through CUDA-graph replay as
``chip_smoke.py`` phase 2 does.  The copies:

  full         the kernel as it is
  stream       the weight and x copied through the ring, no arithmetic
  no_stream    the arithmetic on whatever the buffers hold, no weight copy
  no_convert   the copies and the MMAs, the weight's bytes fed to the
               MMAs as they are (no conversion to bf16)
  deeper       the kernel with one ring buffer more
  other_tpw    stages of 4 units and 2 buffers in int8, of 2 units and 6
               buffers in int4
  first_unit   a block's first stage of one unit, so its arithmetic
               starts after 16 KB (int8) or 8 KB (int4) have come
  no_x         the kernel without x's copies
  no_mma       the copies and the conversion, float adds for the MMAs
  no_split     x's bits fed to the MMAs as they are (no split in terms)
  compute      neither the weight's nor x's copies
  compute_no_split, compute_no_convert, compute_no_mma
               ``compute`` less one part
  skeleton     ``compute`` less all three: the loop, the loads from
               shared memory and the ends of segments
  handshake    ``compute`` with no work on a stage: the barriers alone
  stamped      the kernel with %globaltimer stamps by thread 0 of each
               block (its start, its first stage in, the ends of its first
               and last segment, the end of its stream and of its work) and
               its clock64 over the stream; one launch's stamps give the
               time to the first stage, a unit's time in the steady state,
               what the ends of segments and the arrivals cost, how far
               apart the blocks end, and the SM clock
  stamped_compute, stamped_handshake
               the same stamps in ``compute`` and ``handshake``

A last shape, (4, 128, 16896), gives each block one unit: what a launch
costs besides the stream.  Copies other than ``full``, ``deeper``,
``other_tpw``, ``first_unit`` and the stamped ones compute wrong values;
only ``full`` is checked, against the plain version.  When the source
moves on, the script stops with the line it could not find.  Nothing in
the package changes.  Run from the root of a checkout on a machine with a
card and nvcc, with the copies to time (all of them by default)::

    python3 tools/dequant_matmul_variants.py [name ...]
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "dequant_variants"

MMA_CALL = ("        mma_kstep<W>(buf + (kk0 + lm_row) * L::PITCH + lm_col, "
            "a, d);\n")
CP16 = "        async_copy::cp16(dst, in ? su : w, in);\n"
X_COPIES = [
    ("        async_copy::cp16(\n"
     "            buf + L::W_BYTES + 4 * (mi * L::X_PITCH + kk),\n"
     "            in ? x + static_cast<long long>(m0 + mi) * K + k0 + kk : x, "
     "in);\n", ""),
    ("        async_copy::cp4(\n"
     "            buf + L::W_BYTES + 4 * (mi * L::X_PITCH + kk),\n"
     "            in ? x + static_cast<long long>(m0 + mi) * K + k0 + kk : x, "
     "in);\n", "")]
SPLIT = ("      split(*reinterpret_cast<const float2*>(xs + mi * L::X_PITCH + "
         "kk), hi,\n            mid, lo);\n")
VARIANTS = {
    "full": [],
    "stream": [(MMA_CALL, "")],
    "no_stream": [(CP16, "")],
    "no_convert": [
        ("  return bf16x2_fma(v, BF16X2_ONE, off);\n", "  return p;\n"),
        ("  return bf16x2_fma(lop3<0x6A>(p, 0x000F000Fu, 0x43084308u), "
         "BF16X2_ONE,\n                    0xC308C308u);", "  return p;")],
    "deeper": [("  static constexpr int STAGES = 3;\n",
                "  static constexpr int STAGES = 4;\n"),
               ("  static constexpr int STAGES = 4;     // ring buffers",
                "  static constexpr int STAGES = 5;     // ring buffers")],
    "other_tpw": [("  static constexpr int TPW = 4;\n"
                   "  static constexpr int STAGES = 3;\n",
                   "  static constexpr int TPW = 2;\n"
                   "  static constexpr int STAGES = 6;\n"),
                  ("  static constexpr int TPW = 2;        // units a stage (a "
                   "warp's k-steps)\n  static constexpr int STAGES = 4;",
                   "  static constexpr int TPW = 4;        // units a stage (a "
                   "warp's k-steps)\n  static constexpr int STAGES = 2;")],
    "first_unit": [("    int j, q, left, buf;\n",
                    "    int j, q, left, buf;\n    bool started = false;\n"),
                   ("      return min(W::TPW, min(kb - q, left));",
                    "      return min(started ? W::TPW : 1, "
                    "min(kb - q, left));"),
                   ("      q += n, left -= n;", 
                    "      q += n, left -= n, started = true;")],
    "no_x": X_COPIES,
    "no_mma": [('  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
                '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, '
                '{%0,%1,%2,%3};\\n"\n'
                '      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])\n'
                '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), '
                '"r"(b0), "r"(b1));\n',
                "  d[0] += __uint_as_float(b0); d[1] += __uint_as_float(b1);"
                "\n  d[2] += __uint_as_float(a[0] ^ a[1]);\n"
                "  d[3] += __uint_as_float(a[2] ^ a[3]);\n")],
    "stamped": [
        ('#include "async_copy.cuh"\n',
         '#include "async_copy.cuh"\n'
         "__device__ unsigned long long g_stamp[65536][12];\n"
         "#define STAMP(i) do { if (threadIdx.x == 0) { unsigned long long "
         "t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
         "g_stamp[blockIdx.y * gridDim.x + blockIdx.x][i] = t_; } } "
         "while (0)\n"),
        ("                     static_cast<int>(s0 % p.kb), share, 0};\n",
         "                     static_cast<int>(s0 % p.kb), share, 0};\n"
         "  STAMP(0);\n"
         "  if (threadIdx.x == 0) g_stamp[blockIdx.y * gridDim.x + "
         "blockIdx.x][7] = share;\n"
         "  if (threadIdx.x == 0) g_stamp[blockIdx.y * gridDim.x + "
         "blockIdx.x][9] = clock64();\n"),
        ("  int chain = 0;\n", "  int chain = 0, ends = 0;\n"),
        ("    __syncthreads();                    // all of it; the last one is "
         "done\n",
         "    __syncthreads();                    // all of it; the last one is "
         "done\n    if (cs.left == share) STAMP(1);\n"),
        ("      finish(j, static_cast<int>(blockIdx.x) - first, nseg);\n",
         "      if (ends == 0) STAMP(2); else STAMP(4);\n"
         "      finish(j, static_cast<int>(blockIdx.x) - first, nseg);\n"
         "      if (ends++ == 0) STAMP(3); else STAMP(5);\n"),
        ("  if (n_shared == 0) return;\n",
         "  STAMP(6);\n  if (threadIdx.x == 0) g_stamp[blockIdx.y * "
         "gridDim.x + blockIdx.x][10] = clock64();\n"
         "  if (n_shared == 0) { STAMP(8); return; }\n"),
        ("    store(shared_j[e], s, sc[e]);\n  }\n}\n",
         "    store(shared_j[e], s, sc[e]);\n  }\n  STAMP(8);\n}\n")],
}
VARIANTS["no_split"] = [(SPLIT, "      hi = mid = lo = __float_as_uint("
                                 "xs[mi * L::X_PITCH + kk]);\n")]
VARIANTS["compute"] = VARIANTS["no_stream"] + VARIANTS["no_x"]
VARIANTS["stamped_compute"] = VARIANTS["stamped"] + VARIANTS["compute"]
VARIANTS["handshake"] = VARIANTS["compute"] + [(
    "      if (u < n && q * UNIT + kk0 < K) {  // the k-step holds rows\n",
    "      if (false) {\n")]
VARIANTS["stamped_handshake"] = VARIANTS["stamped"] + VARIANTS["handshake"]
for part in ("no_split", "no_convert", "no_mma"):
    VARIANTS[f"compute_{part}"] = VARIANTS["compute"] + VARIANTS[part]
VARIANTS["skeleton"] = (VARIANTS["compute"] + VARIANTS["no_split"]
                        + VARIANTS["no_convert"] + VARIANTS["no_mma"])
SHAPES = [(4, 4096, 11008), (4, 11008, 4096), (4, 128, 16896)]
STAMP_FNS = """
extern "C" int stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamp, sizeof(g_stamp));
}
extern "C" int clear_stamps() {
  void* p = nullptr;
  cudaGetSymbolAddress(&p, g_stamp);
  return (int)cudaMemset(p, 0, sizeof(g_stamp));
}
"""


def build(names):
    """Write and compile the named copies at once; name -> library."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "dequant_matmul.cu").read_text()
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, OUT / h.name)
    procs = {}
    for name in names:
        text = src
        edits = VARIANTS[name]
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: line not found in the source:\n"
                                 f"{old}")
            text = text.replace(old, new)
        if name.startswith("stamped"):
            text += STAMP_FNS
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        lib = OUT / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc exited {proc.returncode}\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: {regs}", flush=True)
        libs[name] = lib
    return libs


def timeline(lib, call, w, torch):
    """One launch's stamps, after warm-ups, in µs: medians over blocks."""
    import numpy as np
    for _ in range(3):
        call(w)
    torch.cuda.synchronize()
    if lib.clear_stamps() != 0:
        raise RuntimeError("could not clear the stamps")
    call(w)
    torch.cuda.synchronize()
    buf = np.zeros((65536, 12), dtype=np.uint64)
    if lib.stamps(ctypes.c_void_p(buf.ctypes.data)) != 0:
        raise RuntimeError("could not read the stamps")
    st = buf[buf[:, 0] > 0].astype(np.int64)
    t0 = st[:, 0].min()
    nst = st[:, 7]
    ends = (st[:, 3] - st[:, 2]) + np.where(st[:, 5] > 0,
                                             st[:, 5] - st[:, 4], 0)
    steady = (st[:, 6] - st[:, 1] - ends) / np.maximum(nst - 1, 1)
    med = lambda v: float(np.median(v)) / 1e3   # noqa: E731
    out = {
        "blocks": int(len(st)), "span": (st[:, 8].max() - t0) / 1e3,
        "start_skew": (st[:, 0].max() - t0) / 1e3,
        "first_stage": med(st[:, 1] - st[:, 0]),
        "stage_steady": med(steady[nst > 1]) if (nst > 1).any() else None,
        "segment_ends": med(ends),
        "stream_end_first_block": (st[:, 6].min() - t0) / 1e3,
        "stream_end_last_block": (st[:, 6].max() - t0) / 1e3,
        "arrivals_and_combine": med(st[:, 8] - st[:, 6]),
        "stages": [int(nst.min()), int(nst.max())],
        "sm_clock_ghz": float(np.median((st[:, 10] - st[:, 9])
                                        / (st[:, 6] - st[:, 0])))}
    print(f"    timeline (us): {out}", flush=True)
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke
    from repro_torch.kernels import ref
    from repro_torch.models import lm_quant

    if not torch.cuda.is_available():
        print("dequant_matmul_variants.py: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"dequant_matmul_variants.py: no copy {unknown}; the copies: "
              f"{', '.join(VARIANTS)}", file=sys.stderr)
        return 2
    libs = {}
    for name, path in build(names).items():
        lib = ctypes.CDLL(str(path))
        for fn in (lib.dequant_matmul_launch, lib.dequant_matmul_i4_launch):
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.dequant_matmul_workspace_floats,
                   lib.dequant_matmul_counter_ints):
            fn.argtypes = [ctypes.c_int] * 4
            fn.restype = ctypes.c_longlong
        libs[name] = lib
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    rows = []
    for int4 in (False, True):
        for m, k, n in SHAPES:
            leaf = lm_quant._quantize_leaf(torch.randn(k, n, generator=g)
                                           .to(dev), 4 if int4 else 8)
            w = leaf.q4 if int4 else leaf.q8
            scale = leaf.qs.reshape(-1)
            x = torch.randn(m, k, generator=g).to(dev)
            want = (ref.dequant_matmul_i4_ref if int4
                    else ref.dequant_matmul_ref)(x, w, scale)
            row = {"kernel": "K6" if int4 else "K5", "shape": [m, k, n]}
            for name, lib in libs.items():
                fn = (lib.dequant_matmul_i4_launch if int4
                      else lib.dequant_matmul_launch)
                out = torch.empty(m, n, device=dev)
                ws = torch.empty(lib.dequant_matmul_workspace_floats(
                    m, k, n, int(int4)), device=dev)
                ctr = torch.zeros(lib.dequant_matmul_counter_ints(
                    m, k, n, int(int4)), dtype=torch.int32, device=dev)

                def call(wc, fn=fn, out=out, ws=ws, ctr=ctr):
                    rc = fn(x.data_ptr(), wc.data_ptr(), scale.data_ptr(),
                            out.data_ptr(), ws.data_ptr(), ctr.data_ptr(), m,
                            k, n, torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                call(w)
                torch.cuda.synchronize()
                if name == "full":
                    err = (out - want).abs().max().item()
                    if err > 1e-5 * want.abs().max().item():
                        raise AssertionError(f"full {row}: err {err}")
                if name.startswith("stamped"):
                    row[name] = timeline(lib, call, w, torch)
                    continue
                warm, _ = chip_smoke.time_ms(torch, lambda: call(w))
                cold, _ = chip_smoke.cold_time_ms(torch, w, call)
                row[name] = {"warm_us": warm * 1e3, "cold_us": cold * 1e3}
                print(f"  {row['kernel']} {(m, k, n)} {name}: warm "
                      f"{warm * 1e3:.2f} us, out of L2 {cold * 1e3:.2f} us",
                      flush=True)
            rows.append(row)
    print(json.dumps({"variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
