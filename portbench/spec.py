"""Where the benchmark finds its parts, by name, so that a later change
adds a cell, a configuration, a traffic mix, a per-layer metric or a
kind of configuration by adding files only:

- ``BENCHMARK.json`` at the root of the checkout: cells and metrics;
- ``configs/<config>.json``: a configuration (its ``kind`` picks the
  driver ``drivers/<kind>.py``);
- ``traffic/<mix>.json``: a traffic mix, read by ``traffic.py``;
- ``metrics/<metric>.py``: a metric's reader, ``read(rec, ctx)`` -> a
  number or None (nothing to read); a metric named ``<quantity>.<cell
  part>`` without a file of its own is read by ``metrics/<quantity>.py``;
- ``checks/<cell>.json``: the limits of a cell's compared numbers.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench._found.{tag}.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Bench:
    """``BENCHMARK.json`` (``benchmark``) and the parts under ``roots``,
    each part taken from the first root that holds it."""

    def __init__(self, benchmark: Path = None, roots=(HERE,)):
        self.roots = [Path(r) for r in roots]
        self.doc = json.loads(Path(benchmark or ROOT / "BENCHMARK.json")
                              .read_text())

    def _find(self, *candidates: str) -> Path:
        for name in candidates:
            for root in self.roots:
                if (root / name).exists():
                    return root / name
        raise FileNotFoundError(f"none of {candidates} under {self.roots}")

    def cell(self, name: str) -> Dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in self.doc['workloads']]}")

    def _json(self, folder: str, name: str) -> Dict:
        return json.loads(self._find(f"{folder}/{name}.json").read_text())

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> Dict[str, Dict]:
        try:
            return self._json("checks", cell)
        except FileNotFoundError:
            return {}

    def driver(self, kind: str):
        return _load(self._find(f"drivers/{kind}.py"), "drivers")

    def reader(self, metric: str) -> Callable:
        path = self._find(f"metrics/{metric}.py",
                          f"metrics/{metric.split('.')[0]}.py")
        return _load(path, "metrics").read

    def metrics(self, cell: Dict, section: str) -> List[Dict]:
        """The metrics of ``section`` (``end_to_end`` or ``per_layer``)
        that ``cell`` reports: those listing it under ``workloads``; one
        without that key, in every cell that reports its end-to-end
        metric (``moves``), or, end to end, in every cell."""
        ends = [m for m in self.doc["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]
        if section == "end_to_end":
            return ends
        names = {m["name"] for m in ends}
        return [m for m in self.doc["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]
