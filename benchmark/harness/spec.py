"""Where the benchmark finds each of its parts, by the names that
``BENCHMARK.json`` gives:

- a configuration: ``configs/<config>.json`` (its source, ``reduced``,
  ``assumed`` and the program's config tree as it is run, under ``config``);
- a traffic mix: ``traffic/<traffic>.json`` (its parameters, and the
  ``entry`` that drives it);
- an entry driver: ``drivers/<entry>.py`` (``run(ctx) -> Measured``);
- a per-layer metric: ``metrics/<metric>.py`` (``read(measured) -> float
  or None``);
- a kernel group: every ``kernels/*.json`` (``order``, ``patterns``, and
  the ``operation`` whose device time it counts, if any);
- a cell's correctness limits: ``limits/<cell>.json``.

A later cell, mix, driver, metric or kernel group is a new file: nothing
here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Spec:
    def __init__(self, root: Optional[Path] = None):
        self.root = Path(root) if root is not None else ROOT
        self.dir = self.root / "benchmark"
        with open(self.root / "BENCHMARK.json", encoding="utf8") as f:
            self.bench = json.load(f)

    # -- entries of BENCHMARK.json ------------------------------------------
    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")

    def cells(self) -> List[str]:
        return [w["name"] for w in self.bench["workloads"]]

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list that move an end-to-end metric it reports."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    # -- files found by name -----------------------------------------------
    def _json(self, *parts: str) -> dict:
        path = self.dir.joinpath(*parts)
        with open(path, encoding="utf8") as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self._json("configs", f"{name}.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, cell: str) -> dict:
        return self._json("limits", f"{cell}.json")

    def _module(self, kind: str, name: str) -> ModuleType:
        path = self.dir / kind / f"{name}.py"
        if not path.exists():
            raise SystemExit(f"no {kind[:-1]} file {path}")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def driver(self, entry: str) -> ModuleType:
        return self._module("drivers", entry)

    def reader(self, metric: str) -> ModuleType:
        return self._module("metrics", metric)

    def kernel_groups(self) -> List[dict]:
        """Every kernel group, in the order their names are tried: by
        ``order``, then by file name."""
        groups = []
        for path in sorted((self.dir / "kernels").glob("*.json")):
            with open(path, encoding="utf8") as f:
                g = json.load(f)
            g["name"] = path.stem
            flags = re.I if g.get("ignore_case") else 0
            g["compiled"] = [re.compile(p, flags) for p in g["patterns"]]
            groups.append(g)
        return sorted(groups, key=lambda g: (g["order"], g["name"]))


def classify(name: str, groups: List[dict]) -> Optional[dict]:
    """The first group one of whose patterns finds ``name``, or None."""
    for g in groups:
        if any(p.search(name) for p in g["compiled"]):
            return g
    return None
