"""dev_prep_ms (ms/frame): the mean of the program's `prep` and
`upload` spans with their children (`prep_batch`: residuals, lane rows,
deblock maps; `to_torch_inputs`: the scan's plan, the MC lanes and
references, the uploads) over the window's inter frames on the device
path, from `Decoder.stats`.  None where there are none, or the records
have no `spans_ms`."""


def read(run):
    st = [s["spans_ms"] for s in run.record.stats
          if "spans_ms" in s and not s["intra"] and
          s["recon_path"] == "device"]
    if not st:
        return None
    return sum(v for s in st for k, v in s.items()
               if k.split(".")[0] in ("prep", "upload")) / len(st)
