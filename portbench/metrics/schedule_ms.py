"""schedule_ms (ms/frame): the mean of the program's `schedule`
(`wavefront.build_schedule`) and `eligibility`
(`device_inter.ineligible_reason`) spans of every frame record in the
window's `Decoder.stats`; both run in `DeviceRecon`'s construction,
also for the frames that then take the host pixel path.  None where
the records have no `spans_ms`."""


def read(run):
    st = [s["spans_ms"] for s in run.record.stats if "spans_ms" in s]
    if not st:
        return None
    return sum(s.get("schedule", 0.0) + s.get("eligibility", 0.0)
               for s in st) / len(st)
