"""mc_ref_mib (MiB/frame): the mean of the program's `refs_bytes` (the
reference samples `device_inter.pack_ref_flat` packs for MC, at the
width MC reads: 1 byte a sample at 8 bits, 4 above) over the window's
inter frames on the device path, from `Decoder.stats`.  None where
there are none, or their records have no such counter (a program
without it)."""


def read(run):
    st = [s["refs_bytes"] for s in run.record.stats
          if "refs_bytes" in s and not s["intra"] and
          s["recon_path"] == "device"]
    if not st:
        return None
    return sum(st) / len(st) / 2 ** 20
