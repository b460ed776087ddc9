"""The readers of the program's spans and copy counters (`tu_parse_ms`,
`schedule_ms`, `dev_prep_ms`, `dispatch_ms`, `dev_fetch_ms`,
`host_walk_ms`, `host_filter_ms`, `h2d_mib`, `d2h_mib`,
`untraced_share`): CPU dry runs of the small cells, each reader a number
where its frames exist and None where they do not, and None, without
raising, on the records of a program that keeps no spans."""
import pytest

import run as bench
from helpers import tiny_cell

SEED = 2 ** 33 + 91
SPANS = ("tu_parse_ms", "schedule_ms", "dev_prep_ms", "dispatch_ms",
         "dev_fetch_ms", "host_walk_ms", "host_filter_ms", "untraced_share")
COPIES = ("h2d_mib", "d2h_mib")
# cell -> the span readers with frames to read there: `tiny.inter`
# (obmc: a key frame, then inter frames on the host pixel path),
# `tiny.lowdelay` (inter frames on the device path), `tiny.intra` (the
# batched entry, which keeps no Decoder.stats)
READS = {
    "tiny.inter": {"tu_parse_ms", "schedule_ms", "host_walk_ms",
                   "host_filter_ms", "untraced_share"},
    "tiny.lowdelay": {"tu_parse_ms", "schedule_ms", "dev_prep_ms",
                      "dispatch_ms", "dev_fetch_ms", "untraced_share"},
    "tiny.intra": set(),
}


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card_stub"])
@pytest.mark.parametrize("name", sorted(READS))
def test_span_readers_read_where_their_frames_are(tmp_path, monkeypatch,
                                                  name, card):
    """With `card_stub` the port counts the CPU's copies as a card's, so
    the copy readers read in the Decoder cells; on the CPU a run counts
    no copy, and they read nothing."""
    from av1dec_tpu_torch import tracing
    if card:
        monkeypatch.setattr(tracing, "_on_card", lambda device: True)
    cell = tiny_cell(tmp_path, name)
    result, _ = bench.run_cell(cell, SEED, 0.5, 1, device="cpu")
    assert result["correct"] is True
    got = result["metrics"]
    want = READS[name] | (set(COPIES) if card and READS[name] else set())
    assert set(got) & set(SPANS + COPIES) == want
    for m in want:
        assert got[m]["value"] > 0
    if "untraced_share" in got:
        assert got["untraced_share"]["value"] < 100
        assert got["untraced_share"]["unit"] == "%"


def test_span_readers_without_spans_read_nothing():
    """A record of a program without the port's spans (the parent of the
    change that added them) leaves every reader None."""
    class Record:
        stats = [{"intra": 0, "recon_path": p, "ms": 10.0,
                  "inter_plan_ms": 1.0} for p in ("device", "host")]

    class Run:
        record = Record()
        frames = 2
    for m in SPANS + COPIES:
        assert bench.load_reader(m)(Run()) is None, m
