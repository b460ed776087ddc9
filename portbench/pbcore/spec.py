"""Cells, configurations, traffic mixes and metrics, found by name.

`BENCHMARK.json` at the checkout's root names every cell (`workloads`),
configuration and metric; each configuration's sizes are its `file`
under `portbench/configs/`, each traffic mix `portbench/traffic/
<traffic>.json`, each metric's reader `portbench/metrics/<metric>.py`.
A new cell, mix or metric is new files and new entries: nothing here
changes.  Standard library only: `run.py` reads the cell before NumPy
and torch are imported, so that the thread settings reach them."""
import json
import os
import re
from dataclasses import dataclass

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict       # the configuration file's object
    traffic: dict      # the traffic file's object
    end_to_end: list   # BENCHMARK.json's entries that this cell reports
    per_layer: list


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric, cell):
    return cell in metric.get("workloads", [cell])


def load_cell(name, root=ROOT, traffic_dir=None):
    """The cell `name` of `root`'s BENCHMARK.json.  `traffic_dir`
    (default `portbench/traffic`) is where its mix is read."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(
        traffic_dir or os.path.join(BENCH, "traffic"),
        w["traffic"] + ".json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def metric_path(name):
    return os.path.join(BENCH, "metrics", name + ".py")


def stream_path(name):
    return os.path.join(BENCH, "streams", name + ".ivf")


def reference(name):
    """libaom's record of stream `name` (`portbench/reference`)."""
    return load_json(os.path.join(BENCH, "reference", name + ".json"))
