"""`BENCHMARK.json` and the files it names, found by name.

- a cell (`workloads` entry) by its `name`;
- its configuration: the `configs` entry named by the cell's `config`,
  whose `file` holds the deployment's settings;
- its traffic: `perf_bench/traffic/<traffic>.json`;
- its limits on what `correct` compares: `perf_bench/limits/<cell>.json`;
- a per-layer metric's reader: `perf_bench/layer_metrics/<metric>.py`,
  a module with `read(ctx) -> float | None`.

Adding a configuration, a traffic mix, a cell or a per-layer metric takes
new files and new entries in `BENCHMARK.json`, and no edit here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)
        self.bench_dir = self.root / "perf_bench"

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def _json(self, folder: str, name: str) -> dict:
        with open(self.bench_dir / folder / f"{name}.json") as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def metrics_for(self, section: str, workload: str) -> list:
        """The `end_to_end` or `per_layer` entries this cell reports."""
        return [m for m in self.data[section]
                if "workloads" not in m or workload in m["workloads"]]

    def layer_reader(self, metric: str):
        path = self.bench_dir / "layer_metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"perf_bench_layer_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
