"""Reading a ``torch.profiler`` trace of the device.

``kernel_of``, ``trace_totals``-style reading of the raw records,
the marker kernels around a traced stretch and ``bound`` are a frozen
copy of the readers in ``chip_smoke.py`` at commit 92e5ccc (its
``kernel_of``, ``trace_records``, ``trace_totals``, ``trace_device_us``,
``trace_markers`` and ``bound``), kept here so that no change to the
program changes how the benchmark reads a trace.  What is new: the
records' start and end times, from which the busy time (the union of the
device records), the traced window (from the end of the last lead-in
marker to the start of the first trailing one) and the idle gaps come.

The trace drops or skews device records at its edges (chip_smoke.py
saw the first ~0.5 s go), so a traced stretch is framed by a second of
``i0e`` marker kernels before it and a quarter of ``i1e`` after it, and
only records between the two are read.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

LEAD_MARKER, TRAIL_MARKER = "i0e", "i1e"
LEAD_S, TRAIL_S, TICK_S = 1.0, 0.25, 0.01
SETTLED = 10


def bound(nbytes: float, ops: float, ops_per_s: float,
          bytes_per_s: float = 3.35e12) -> Tuple[float, str]:
    """(least time in ms, what bounds it) on the H100."""
    t_bytes, t_ops = nbytes / bytes_per_s, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_of(name: str) -> Optional[str]:
    """The port's kernel whose wrapper launched the device function
    ``name``: K3, K4 and K7 run one function of K3's device code and
    differ in its template arguments; K8 runs one state pass or one
    single-chunk kernel a call.  None for any other function."""
    if "decode_simt_kernel" in name or "decode_mma_kernel" in name:
        if "ContiguousRows" in name:
            return "decode_attention"
        return ("paged_decode_attention_q" if "RowScale" in name
                else "paged_decode_attention")
    if "dequant_matmul_kernel" in name:
        return "dequant_matmul_i4" if "Int4W" in name else "dequant_matmul"
    if "quant_matmul_rows" in name or "quant_matmul_kernel" in name:
        return "quant_matmul"
    if "flash_attention_kernel" in name:
        return "flash_attention"
    if "state_pass_kernel" in name or "one_chunk_kernel" in name:
        return "ssd_scan"
    return None


class Markers:
    """Marker kernels around a traced stretch: ``lead()`` runs ``LEAD_S``
    of ``i0e`` launches, one every ``TICK_S``, each waited for;
    ``trail()`` runs ``TRAIL_S`` of ``i1e``.  The host clock after the
    lead-in and before the trail brackets the stretch."""

    def __init__(self, torch, device):
        self.torch = torch
        self.probe = torch.ones(1, device=device)
        # a stream of their own: waiting for a marker does not wait for
        # the run's work (a train step takes a second and more)
        self.stream = torch.cuda.Stream(device)
        self.n_lead = self.n_trail = 0

    def _run(self, fn, seconds: float) -> int:
        n, end = 0, time.perf_counter() + seconds
        while time.perf_counter() < end:
            with self.torch.cuda.stream(self.stream):
                fn(self.probe)
            self.stream.synchronize()
            n += 1
            time.sleep(TICK_S)
        return n

    def lead(self) -> None:
        self.n_lead = self._run(self.torch.special.i0e, LEAD_S)

    def trail(self) -> None:
        self.n_trail = self._run(self.torch.special.i1e, TRAIL_S)


class Traced:
    """A profiler over a stretch of a run, driven from the thread that
    runs the process's first profile (kineto sets up in no other):
    ``begin()`` (``start()`` and ``lead()``), the stretch, ``stop()``
    (``trail()`` and ``finish()``), then ``read()``."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.prof = None

    def start(self) -> None:
        """Start the profile: the device's records and the CUDA calls,
        not every host operation."""
        from torch.profiler import ProfilerActivity, profile
        self.marks = Markers(self.torch, self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()

    def lead(self) -> None:
        """The lead-in; the stretch starts when this returns."""
        self.marks.lead()
        self._window = [time.monotonic_ns(), 0]

    def begin(self) -> None:
        self.start()
        self.lead()

    def trail(self) -> None:
        """End the stretch: the trailing markers."""
        self._window[1] = time.monotonic_ns()
        self.marks.trail()
        time.sleep(TRAIL_S)

    def finish(self) -> None:
        """End the profile."""
        self.prof.__exit__(None, None, None)

    def stop(self) -> None:
        self.trail()
        self.finish()

    def read(self) -> "TraceData":
        """The stretch's ``TraceData`` (after ``stop()``)."""
        return read(self.prof, self.marks, tuple(self._window))


class TraceData:
    """What a trace says about its window: ``window_s``, ``busy_s`` (the
    union of the device records in it), seconds by record name and by
    the port's kernel (``kernel_of``), the idle gaps with what the host
    was doing, and ``host_window`` (ns)."""

    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.by_name: Dict[str, float] = {}
        self.by_kernel: Dict[str, float] = {}
        self.gaps: List[Tuple[str, float]] = []
        self.host_window: Tuple[int, int] = (0, 0)


def read(prof, marks: Markers, host_window) -> TraceData:
    """The ``TraceData`` of a profile: its raw records, not
    ``key_averages()`` (which builds an object for each of ~10^5
    launches)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        rec = (start, start + e.duration_ns(), e.name())
        (dev if e.device_type() == DeviceType.CUDA else host).append(rec)
    lead = [r for r in dev if LEAD_MARKER in r[2]]
    trail = [r for r in dev if TRAIL_MARKER in r[2]]
    out = TraceData()
    out.host_window = host_window
    if len(lead) < SETTLED or len(trail) != marks.n_trail:
        raise RuntimeError(
            f"the trace holds {len(lead)} of {marks.n_lead} lead-in markers "
            f"(at least {SETTLED} needed) and {len(trail)} of "
            f"{marks.n_trail} trailing ones: its window did not cover the "
            f"traced stretch")
    w0 = max(r[1] for r in lead)
    w1 = min(r[0] for r in trail)
    out.window_s = (w1 - w0) / 1e9
    inside = sorted((max(s, w0), min(e, w1), n) for s, e, n in dev
                    if e > w0 and s < w1 and LEAD_MARKER not in n
                    and TRAIL_MARKER not in n)
    busy, gaps = 0, []
    prev = "window start"
    at = w0
    for s, e, n in inside:
        dur = (e - s) / 1e9
        out.by_name[n] = out.by_name.get(n, 0.0) + dur
        k = kernel_of(n)
        if k is not None:
            out.by_kernel[k] = out.by_kernel.get(k, 0.0) + dur
        if s > at:
            gaps.append((s - at, at, s, prev, n))
        if e > at:
            busy += e - max(s, at)
            at = e
            prev = n
    if w1 > at:
        gaps.append((w1 - at, at, w1, prev, "window end"))
    out.busy_s = busy / 1e9
    gaps.sort(reverse=True)
    host.sort()
    for size, g0, g1, before, after in gaps[:10]:
        out.gaps.append((_label(host, g0, g1, before, after), size / 1e9))
    return out


def _label(host, g0: int, g1: int, before: str, after: str) -> str:
    """What the host was doing in a device gap: the shortest host record
    (a CUDA runtime call, or an annotation) that spans its middle, else
    "host code outside CUDA calls"; with the device records on each
    side."""
    mid = (g0 + g1) // 2
    spans = [(e - s, n) for s, e, n in host if s <= mid <= e]
    what = min(spans)[1] if spans else "host code outside CUDA calls"
    return f"{what} (after {before[:60]}; before {after[:60]})"


def device_ops(data: TraceData, n: int = 10) -> List[Tuple[str, float]]:
    """The ``n`` device records that took the most time in the window."""
    return sorted(data.by_name.items(), key=lambda kv: -kv[1])[:n]
