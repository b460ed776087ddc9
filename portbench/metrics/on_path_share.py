"""on_path_share (%): the share of the window's frames that took the
recon path (device or host) the reference's record expects for them.
The batched entry's host-path frames are counted at `FrameRecon.run`,
`Decoder`'s read from `Decoder.stats` `recon_path`.  Below 100 when a
cell's traffic has drifted off the layers its `why` names."""


def read(run):
    n = run.record.paths_n
    return 100.0 * (n - run.record.off_path) / n if n else None
