"""Finding a cell's files by the names in `BENCHMARK.json`: its configuration
(`configs/<name>.json`, named by the config entry's `file`), its traffic mix
(`traffic/<name>.json`), the limits of its correctness check
(`limits/<cell>.json`) and the readers of its metrics (`metrics/<name>.py`).
A cell, a configuration, a traffic mix or a metric is added by adding such
files and entries; nothing here names one."""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import os
from typing import Callable, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM_KEYS = ("model_config", "runtime_config", "engine_config")
REQUEST_KEYS = ("num_frames", "video_size_h", "video_size_w")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of `BENCHMARK.json` with its files read."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    end_to_end: List[dict]  # the metric entries the cell reports with --trace 0
    per_layer: List[dict]  # ... and with --trace 1
    limits: Optional[dict]  # the check's limits, None before they are set
    bench_dir: str  # the directory of the benchmark's files

    def program_config(self, control: Optional[str] = None) -> dict:
        """The program's config dict (model, runtime and engine sections): the
        configuration file's, with the traffic's request keys, and with the
        section overrides of the file's control named `control`."""
        cfg = {k: copy.deepcopy(self.config[k]) for k in PROGRAM_KEYS}
        for k in REQUEST_KEYS:
            cfg["runtime_config"][k] = self.traffic[k]
        if control is not None:
            for section, values in self.config["controls"][control].items():
                if section in PROGRAM_KEYS:
                    cfg[section].update(values)
        return cfg


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with `workloads` applies to the cells it lists; one without,
    to every cell that reports the end-to-end metric it moves (or, for an
    end-to-end metric, to every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load(workload: str, root: str = ROOT) -> Cell:
    """The cell named `workload` of `root`/BENCHMARK.json."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    bench_dir = os.path.join(root, bench["paths"][0])
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, reported)]
    limits_path = os.path.join(bench_dir, "limits", workload + ".json")
    return Cell(name=workload, chips=w["chips"], config_name=w["config"], traffic_name=w["traffic"],
                config=_json(os.path.join(root, conf["file"])),
                traffic=_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")),
                end_to_end=e2e, per_layer=per_layer,
                limits=_json(limits_path) if os.path.exists(limits_path) else None, bench_dir=bench_dir)


def reader(bench_dir: str, metric: str) -> Callable:
    """The `read(reading)` function of `metrics/<metric>.py`."""
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
