"""The readings the limits of `correct` are set from, at a cell's own size:
the program's, the control's and each planted fault's numbers compared
(`frames_wrong`, `frames_missing`), on several seeds, in one process (one
set-up, one warm call of each stream, then a short window a reading).

    python3 portbench/control.py --workload <cell> --seconds 8 \
        --seeds 11 12 13

The control (`Runner(control=True)`) is the port's output one bit short
of the configuration's 8 bits a sample; the faults are `pbcore/faults.py`'s.
A JSON line a reading on standard output.  The benchmark's own runs do
not run this.  Needs a card, as `run.py` does."""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run as bench  # noqa: E402
from pbcore import spec  # noqa: E402


def readings(cell, seeds, seconds, device="cuda", faults=None):
    """Yields (seed, mode, checks) for the program ("program"), the
    control ("control") and each fault, on each seed."""
    import torch
    torch.set_num_threads(int(cell.config["threads"]["torch_intra_op"]))
    from pbcore import drive, traffic
    from pbcore.faults import FAULTS, planted
    units, refs = bench.load_streams(cell)
    n_units = {s: len(u) for s, u in units.items()}
    runner = drive.Runner(cell.config, device, units, refs)
    for c in traffic.warm_calls(cell.traffic, n_units,
                                cell.config.get("batch")):
        runner.call(c, drive.Record())
    for seed in seeds:
        for mode in ("program", "control") + tuple(
                FAULTS if faults is None else faults):
            runner.control = mode == "control"
            gen = traffic.calls(cell.traffic, n_units, seed)
            if mode in ("program", "control"):
                rec, _ = bench.window(runner, gen, seconds)
            else:
                with planted(mode):
                    rec, _ = bench.window(runner, gen, seconds)
            yield seed, mode, bench.compare(rec.frames)
    runner.control = False


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    bench.set_host(cell.config)
    import torch
    if not torch.cuda.is_available():
        bench.log("no result: needs a CUDA card")
        return 2
    for seed, mode, checks in readings(cell, args.seeds, args.seconds):
        print(json.dumps({"workload": cell.name, "seed": seed, "mode": mode,
                          "correct": bench.correct_of(checks),
                          **{k: v["value"] for k, v in checks.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
