"""Scale-out over processes and cards with `torch.distributed`: the
group (`dist.py`), the (data, space) mesh (`mesh.py`), column halo
exchange (`halo.py`), column-sharded CDEF (`sharded_cdef.py`),
frame-sharded decode (`sharded_frames.py`) and a worker that runs them
in N processes (`worker.py`)."""
