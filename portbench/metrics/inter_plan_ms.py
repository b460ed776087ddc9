"""inter_plan_ms (ms/frame): the mean `inter_plan_ms` (`InterPlan`, host)
of the window's inter frames on the device path, from `Decoder.stats`."""


def read(run):
    ms = [s["inter_plan_ms"] for s in run.record.stats
          if not s["intra"] and s["recon_path"] == "device"]
    return sum(ms) / len(ms) if ms else None
