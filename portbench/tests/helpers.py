"""A throwaway benchmark root for CPU dry runs: a BENCHMARK.json whose
cells use copies of the configuration files (`portbench/configs/`), each in the picture format
of its small streams, and the small mixes of `portbench/tests/traffic/`,
as a later change would add a cell."""
import json
import os

from pbcore import spec

TRAFFIC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "traffic")
# cell -> (configuration, mix, the mix's picture size)
CELLS = {"tiny.intra": ("intra_1080p", "tiny_intra", (192, 128)),
         "tiny.inter": ("inter_1080p", "tiny_inter", (192, 128)),
         "tiny.lowdelay": ("inter_1080p", "tiny_lowdelay", (128, 96))}


def tiny_root(tmp_path):
    b = spec.benchmark()
    b["workloads"] = [{"name": n, "config": n, "traffic": t, "chips": 1,
                       "why": "a test's cell"}
                      for n, (c, t, _) in CELLS.items()]
    b["configs"] = []
    for n, (c, _, (w, h)) in CELLS.items():
        config = spec.load_json(os.path.join(spec.BENCH, "configs",
                                             c + ".json"))
        config["format"].update(width=w, height=h)
        path = tmp_path / f"{n}.json"
        path.write_text(json.dumps(config))
        b["configs"].append({"name": n, "source": config["source"],
                             "file": str(path), "reduced": [],
                             "why": "a test's cell"})
    for m in b["end_to_end"] + b["per_layer"]:
        m.pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return str(tmp_path)


def tiny_cell(tmp_path, name):
    return spec.load_cell(name, root=tiny_root(tmp_path),
                          traffic_dir=TRAFFIC)
