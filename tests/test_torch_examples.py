"""The five example twins under ``examples/torch/`` on the CPU
(``--device cpu``), each in a subprocess of its own with a time limit,
all started at once (one torch thread each):

  * ``quickstart`` and ``export_and_quantize`` against their JAX
    examples, which run in subprocesses too, under the aliases jax 0.9
    needs (``jax.experimental.enable_x64`` and ``pltpu.TPUMemorySpace``;
    the JAX package is untouched): every number both print is equal —
    blob, plan and arena bytes, the class probabilities, the float-int8
    error, the C array's lines — but the memory report's "linked op
    code", a stand-in for each package's own op code size, and its
    device line, which only the port prints;
  * the LM twins' own claims: ``serve_multitenant``'s arena — each
    tenant's KV section stacks, the persistent bytes its caches' (the
    twin asserts it), every request served; ``streaming_client``'s
    streamed tokens are the transcripts and a batch run's (asserted in
    the twin); ``train_small_lm``'s loss falls by more than 0.5 and the
    restored weights generate the trained weights' tokens (asserted in
    the twin);
  * no twin imports jax or anything of ``repro``.
"""

import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TWINS = ["quickstart", "export_and_quantize", "serve_multitenant",
         "streaming_client", "train_small_lm"]
# the JAX examples the micro twins are held to, number for number
JAX_TWINS = ["quickstart", "export_and_quantize"]
# seconds each subprocess may take (all run at once)
LIMIT_S = 150

RUN_TWIN = """
import runpy, sys
sys.argv = [sys.argv[1], "--device", "cpu"]
runpy.run_path(sys.argv[0], run_name="__main__")
print("IMPORTED", "jax" in sys.modules
      or any(m == "repro" or m.startswith("repro.") for m in sys.modules))
"""

# the JAX example under the names jax 0.9 gives what it imports
RUN_JAX = """
import runpy, sys
import jax, jax.experimental
from jax.experimental.pallas import tpu as pltpu
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
if not hasattr(pltpu, "TPUMemorySpace"):
    pltpu.TPUMemorySpace = pltpu.MemorySpace
sys.argv = [sys.argv[1]]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


@pytest.fixture(scope="module")
def runs():
    """name -> stdout of each twin (``name``) and JAX example
    (``jax name``), all started at once; a run that fails or overruns
    fails here."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = {}
    for name in TWINS:
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", RUN_TWIN,
             str(ROOT / "examples" / "torch" / f"{name}.py")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name in JAX_TWINS:
        procs[f"jax {name}"] = subprocess.Popen(
            [sys.executable, "-c", RUN_JAX,
             str(ROOT / "examples" / f"{name}.py")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + LIMIT_S
    out = {}
    try:
        for name, p in procs.items():
            out[name], _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, (name, out[name][-3000:])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _numbers(text):
    """Every number in ``text``'s lines but the memory report's linked
    op code and device lines, in order."""
    nums = []
    for line in text.splitlines():
        if line.startswith(("linked op code", "device:", "IMPORTED")):
            continue
        nums += [float(n.replace(",", "")) for n in
                 re.findall(r"-?\d[\d,]*(?:\.\d+)?", line)]
    return nums


@pytest.mark.parametrize("name", TWINS)
def test_twin_runs_without_jax(runs, name):
    lines = runs[name].splitlines()
    assert lines[-1] == "IMPORTED False", lines[-3:]


@pytest.mark.parametrize("name", JAX_TWINS)
def test_micro_twin_prints_the_jax_examples_numbers(runs, name):
    got, want = runs[name], runs[f"jax {name}"]
    assert f"{name} OK" in got and f"{name} OK" in want
    assert _numbers(got) == _numbers(want), (got, want)
    assert len(_numbers(got)) >= 10


def test_serve_multitenant_arena_stacks(runs):
    text = runs["serve_multitenant"]
    assert "serve_multitenant OK" in text
    admitted = [int(n) for n in re.findall(
        r"^  \+ .*persistent=(\d+) KiB$", text, re.M)]
    assert len(admitted) == 3 and admitted == sorted(set(admitted))
    served = [int(n) for n in re.findall(r"-> (\d+) tokens", text)]
    assert len(served) == 12 and all(n >= 1 for n in served)
    total, persistent, capacity = map(int, re.search(
        r"^(\d+) tokens in .*persistent=(\d+) KiB \(stacked\), "
        r"capacity=(\d+) MiB$", text, re.M).groups())
    assert total == sum(served)
    assert persistent == admitted[-1] and capacity == 512


def test_streaming_client_streams_the_transcripts(runs):
    text = runs["streaming_client"]
    assert "a batch run of the same prompts gives the streamed tokens" \
        in text
    streams = {}
    for name, i, tok in re.findall(r"\[(\w+)\s*\] token\s+(\d+) =\s+(\d+)",
                                   text):
        streams.setdefault(name, {})[int(i)] = int(tok)
    got = sorted(tuple(s[i] for i in sorted(s)) for s in streams.values())
    transcripts = sorted(
        tuple(int(t) for t in re.findall(r"\d+", body))
        for body in re.findall(r"uid \d+: \d+ tokens\s+preemptions=\d+\s+"
                               r"\[([^\]]*)\]", text))
    assert len(got) == 3 and got == transcripts


def test_train_small_lm_learns_and_restores(runs):
    text = runs["train_small_lm"]
    assert "train_small_lm OK" in text and "restored == saved" in text
    losses = [float(x) for x in re.findall(r"loss=([\d.]+)", text)]
    assert len(losses) == 5 and losses[-1] < losses[0] - 0.5
    assert re.search(r"generated: \[[\d, ]+\]", text)
