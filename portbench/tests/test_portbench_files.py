"""The benchmark's files: BENCHMARK.json against the contract's shapes,
every configuration, mix and metric file, the seeded draws, and what a
run does without a card."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from pbcore import spec, traffic

B = spec.benchmark()
ALLOWED = {"configs": {"name", "source", "file", "reduced", "why"},
           "workloads": {"name", "config", "traffic", "chips", "why"},
           "metric": {"name", "unit", "better", "bound", "source",
                      "workloads", "layer", "moves"}}


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_keys(kind):
    names = [e["name"] for e in B[kind]]
    assert len(names) == len(set(names))
    for e in B[kind]:
        assert spec.NAME.match(e["name"]), e["name"]
        keys = ALLOWED.get(kind, ALLOWED["metric"])
        assert set(e) <= keys, set(e) - keys
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and \
                    "\t" not in e[k]
        if kind in ("end_to_end", "per_layer"):
            assert spec.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert os.path.exists(spec.metric_path(e["name"]))
        if kind == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if kind == "per_layer":
            assert e["moves"] in {m["name"] for m in B["end_to_end"]}
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            if e["unit"] == "%" and e["name"].endswith("_roofline"):
                assert e["better"] == "higher"


def test_every_config_and_cell_parses():
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}
    for c in B["configs"]:
        assert c["file"].startswith("portbench/configs/")
        conf = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        assert conf["entry"] in ("decode_stream_batched", "Decoder")
        assert set(conf["threads"]) >= {"torch_intra_op", "blas", "decoder"}
        assert "assumed" in conf
        for k in c["reduced"]:
            assert spec.NAME.match(k)
    pairs = set()
    for w in B["workloads"]:
        cell = spec.load_cell(w["name"])
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert spec.NAME.match(w["traffic"])
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert cell.per_layer
        for s in cell.traffic["streams"]:
            ref = spec.reference(s)
            assert os.path.getsize(spec.stream_path(s)) == ref["bytes"]


def test_metric_readers_are_small_functions():
    for m in B["end_to_end"] + B["per_layer"]:
        tree = ast.parse(open(spec.metric_path(m["name"])).read())
        assert [n.name for n in tree.body
                if isinstance(n, ast.FunctionDef)] == ["read"]


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_draws_are_a_function_of_the_seed_alone(cell):
    c = spec.load_cell(cell)
    n_units = {s: spec.reference(s)["tus"] for s in c.traffic["streams"]}

    def take(seed, n=12):
        g = traffic.calls(c.traffic, n_units, seed)
        return [next(g) for _ in range(n)]
    big = 2 ** 33 + 12345
    assert take(big) == take(big)
    assert take(7) == take(7)
    assert take(big) != take(big + 1) or len(c.traffic["streams"]) == 1 \
        and c.traffic["call"] == "stream"
    # every round draws the same work in another order, and ends marked
    n = len(c.traffic["streams"])
    calls = take(big, 2 * n)
    streams = [x.stream for x in calls]
    for s in c.traffic["streams"]:
        assert streams.count(s) == 2
        assert sorted(streams[:n]) == sorted(c.traffic["streams"])
    assert [x.last for x in calls] == ([False] * (n - 1) + [True]) * 2
    if c.traffic["call"] == "frames":
        for x in calls:
            n = n_units[x.stream]
            assert len(x.units) == c.traffic["frames_per_call"]
            for u in range(n):
                assert x.units.count(u) == len(x.units) // n


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable] + args, cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=env)


def test_no_jax_after_the_harness_and_reference_are_imported():
    code = (
        "import sys, importlib.util, glob, os\n"
        "sys.path.insert(0, 'portbench')\n"
        "import run, control\n"
        "from pbcore import spec, traffic, drive, spans, trace, work, "
        "faults\n"
        "for p in glob.glob('portbench/metrics/*.py'):\n"
        "    run.load_reader(os.path.basename(p)[:-3])\n"
        "import av1dec_tpu_torch.api\n"
        "print(run.forbidden_modules())\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = _run(["-c", code], spec.ROOT, env)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_no_result(monkeypatch):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(["portbench/run.py", "--workload", "intra.coef", "--seed",
              str(2 ** 32 + 3), "--seconds", "1", "--trace", "0"],
             spec.ROOT, env)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_directory_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = _run(["portbench/run.py", "--workload", "intra.coef", "--seed",
              "5", "--seconds", "1", "--trace", "0"], str(tmp_path), env)
    assert p.returncode != 0 and p.stdout.strip() == ""
