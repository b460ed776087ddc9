"""CPU dry runs of the harness on small cells, each a throwaway mix file
and BENCHMARK.json entry (as a later change adds a cell): the result's
shape, `correct` on the program, and `correct` false under the control
(`control.readings`) and under each planted fault.  The look for a card is skipped
(`run.run_cell(device="cpu")`); everything else of a run is driven."""
import pytest

import control
import run as bench
from helpers import CELLS, tiny_cell
from pbcore.faults import FAULTS, planted

SEED = 2 ** 33 + 77


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_added_as_files_runs_and_is_correct(tmp_path, name, trace):
    cell = tiny_cell(tmp_path, name)
    result, draws = bench.run_cell(cell, SEED, 1.0, trace, device="cpu")
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(keys) <= {"correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "recon_paths", "checks"}
    assert result["correct"] is True and result["failed"] == 0
    # every frame on the path its stream's record expects
    paths = result["recon_paths"]
    assert paths["off_path"] == 0
    assert paths["taken"] == paths["expected"]
    assert sum(paths["taken"].values()) == result["attempted"]
    assert result["attempted"] == result["checks"]["frames_checked"]["value"]
    assert result["attempted"] > 0 and draws
    want = {m["name"] for m in (cell.per_layer if trace else
                                cell.end_to_end)}
    assert set(result["metrics"]) <= want
    if not trace:
        assert set(result["metrics"]) == {"fps", "setup_s"}
    else:
        # no device metric from a CPU run
        assert not {"kernel_ms", "kernel_roofline", "device_idle",
                    "peak_dev_mib"} & set(result["metrics"])
        assert result["metrics"]
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert result["device"]["platform"] == "cpu"


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_control_is_not_correct(tmp_path, name):
    cell = tiny_cell(tmp_path, name)
    seen = {mode: checks for _, mode, checks in
            control.readings(cell, [SEED], 0.5, device="cpu", faults=())}
    assert bench.correct_of(seen["program"])
    c = seen["control"]
    assert not bench.correct_of(c)
    assert c["frames_wrong"]["value"] == c["frames_checked"]["value"]


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("fault", FAULTS)
def test_each_fault_is_not_correct(tmp_path, name, fault):
    cell = tiny_cell(tmp_path, name)
    with planted(fault):
        result, _ = bench.run_cell(cell, SEED, 0.5, 0, device="cpu")
    c = result["checks"]
    assert result["correct"] is False
    assert c["frames_wrong"]["value"] + c["frames_missing"]["value"] > 0
    if fault == "half_left_out":
        assert c["frames_missing"]["value"] > 0
    # the patches are gone again
    result, _ = bench.run_cell(cell, SEED, 0.5, 0, device="cpu")
    assert result["correct"] is True
