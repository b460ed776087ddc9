"""One rank of a multi-process run of the port's scale-out layer.

    python -m av1dec_tpu_torch.parallel.worker --coordinator HOST:PORT \\
        --world N --rank R [--backend gloo|nccl] --device cpu|cuda \\
        --out DIR [--gops STREAM] [--cdef PLANES.npz --n-space 2 4] \\
        [--frames STREAM] [--time ITERS]

Joins the group (`dist.initialize_distributed`; without `--backend`,
its rule: NCCL when every rank has a card) and runs, in order:
- always, an `all_reduce` (sum) of the rank ids over the whole group,
  `make_mesh` of the first half of the ranks (membership recorded), and
  both halo exchanges (`halo.py`, 2 columns, fill -1) of a small block
  (HALO_BLOCK, plus 100 x the rank) over all ranks on the space axis
  (`global_mesh("space")`);
- `--gops`: this rank's GOP shard of STREAM (`decode_my_gops`), as
  display MD5s per GOP index;
- `--cdef`: `cdef_sharded` of the frame in PLANES.npz (`planes_<i>`,
  `gates_<i>` for the four strength maps, and `meta` = [bd, damping,
  subx, suby], as `save_cdef_input` writes it) over a mesh of each
  `--n-space` size (data = N / n_space), as MD5s of each whole output
  plane's int32 bytes, with the `cdef_filter` launches of that call and
  the largest difference of its `cdef_shard` output from the plain
  `_cdef_shard_core` on the same bordered planes and strengths; with
  `--time ITERS` on a card, also the mean device ms of the
  `cdef_shard_kernel` launches and the mean host ms of the halo
  exchanges per call over ITERS more calls, and the ms of the plain
  version on the same inputs (the ranks take turns, so that each has
  the card to itself);
- `--frames`: `decode_frames_sharded` of STREAM's first FRAMES_DATA
  coded frames over a mesh with data = FRAMES_DATA, as display MD5s per
  frame, with the index of the frame this rank scanned, the scan
  kernel's launches for it and the levels with lanes that their
  counters report complete.
Writes DIR/rank<R>.json.  `launch` starts N such processes and collects
their results.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np


# shape of the block of the halo exchange check
HALO_BLOCK = (3, 4)
# ranks on the data axis of the sharded frames run, one frame each
FRAMES_DATA = 2
# calls of the plain version and of the kernel's wrapper timed per rank
PLAIN_ITERS = 3
WRAPPER_ITERS = 20


def halo_block(rank):
    """The halo check's block of a rank: [3, 4] int32."""
    return (np.arange(HALO_BLOCK[0] * HALO_BLOCK[1], dtype=np.int32)
            .reshape(HALO_BLOCK) + 100 * rank)


def save_cdef_input(path, planes, gates, bd):
    """Write a frame's CDEF input for `--cdef`: planes (arrays or
    tensors), `compute_gates` output and the bit depth."""
    y_pri, y_sec, uv_pri, uv_sec, damping, subx, suby = gates
    arrays = {f"planes_{i}": np.asarray(_host(p), np.int32)
              for i, p in enumerate(planes)}
    for i, g in enumerate((y_pri, y_sec, uv_pri, uv_sec)):
        arrays[f"gates_{i}"] = np.asarray(_host(g), np.int32)
    arrays["meta"] = np.asarray([bd, damping, subx, suby], np.int64)
    np.savez(path, **arrays)


def _host(t):
    return t.cpu().numpy() if hasattr(t, "cpu") else t


def _load_cdef_input(path):
    with np.load(path, allow_pickle=False) as z:
        n = sum(1 for k in z.files if k.startswith("planes_"))
        planes = [z[f"planes_{i}"] for i in range(n)]
        g = [z[f"gates_{i}"] for i in range(4)]
        bd, damping, subx, suby = (int(v) for v in z["meta"])
    return planes, tuple(g) + (damping, subx, suby), bd


def plane_md5s(planes):
    """MD5 of each plane's int32 bytes."""
    return [hashlib.md5(np.ascontiguousarray(_host(p), np.int32).tobytes())
            .hexdigest() for p in planes]


def _cdef_runs(args, dev, res):
    import torch

    from av1dec_tpu_torch.ops.kernels import cdef
    from av1dec_tpu_torch.parallel import sharded_cdef
    from av1dec_tpu_torch.parallel.mesh import make_mesh
    planes, gates, bd = _load_cdef_input(args.cdef)
    planes = [torch.as_tensor(p, device=dev) for p in planes]
    res["cdef"] = {}
    for n_space in args.n_space:
        if args.world % n_space:
            raise ValueError(f"--n-space {n_space} does not divide "
                             f"{args.world} ranks")
        mesh = make_mesh(data=args.world // n_space)
        before = cdef.launches
        out, calls = _against_plain(lambda: sharded_cdef.cdef_sharded(
            planes, gates, bd, mesh))
        rec = {"md5": plane_md5s(out), "launches": cdef.launches - before,
               "max_abs_err": max(err for _, err in calls),
               "shard_widths": [p.shape[1] // n_space for p in planes],
               "space_index": mesh.space_index}
        if args.time and dev.type == "cuda":
            rec.update(_time_cdef(planes, gates, bd, mesh, args.time))
            rec.update(_turns_ms(calls))
        res["cdef"][str(n_space)] = rec


def _against_plain(fn):
    """fn(), with each `cdef_shard` call of it held against the plain
    `_cdef_shard_core` on the same inputs (bordered planes, strengths).
    Returns (fn's result, [(arguments, max abs difference)] per call)."""
    from av1dec_tpu_torch.ops.kernels import cdef
    real, calls = cdef.cdef_shard, []

    def held(*args):
        got = real(*args)
        ref = cdef._cdef_shard_core(*args)
        calls.append((args, max(int((g - r).abs().max())
                                for g, r in zip(got, ref))))
        return got
    cdef.cdef_shard = held
    try:
        return fn(), calls
    finally:
        cdef.cdef_shard = real


def _turns_ms(calls):
    """Mean ms (CUDA events) of the `cdef_shard` wrapper and of the plain
    `_cdef_shard_core` on the inputs of `calls`, all of them once per
    iteration; the ranks take turns, so that each has the card to
    itself."""
    import torch
    import torch.distributed as dist

    from av1dec_tpu_torch.ops.kernels import cdef

    def mean_ms(fn, iters):
        def once():
            for args, _ in calls:
                fn(*args)
        once()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            once()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    out = {}
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = {"wrapper_ms": mean_ms(cdef.cdef_shard, WRAPPER_ITERS),
                   "plain_ms": mean_ms(cdef._cdef_shard_core, PLAIN_ITERS)}
        dist.barrier()
    return out


def _time_cdef(planes, gates, bd, mesh, iters):
    """Mean device ms of the cdef_shard kernels and mean host ms of the
    halo exchanges of one cdef_sharded call, over `iters` calls."""
    import torch
    import torch.distributed as dist

    from av1dec_tpu_torch.parallel import dist as pdist
    from av1dec_tpu_torch.parallel import sharded_cdef
    from av1dec_tpu_torch.profiling import (RecordsLost, complete_events,
                                           launch_ms)
    spent = []  # seconds of halo exchange, per cdef_sharded call
    real = sharded_cdef.exchange_halo_cols_fill

    def timed(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a)
        torch.cuda.synchronize()
        spent[-1] += time.perf_counter() - t
        return out

    def call():
        spent.append(0.0)
        sharded_cdef.cdef_sharded(planes, gates, bd, mesh)

    def agree(ok):
        # the calls are collective: every rank takes its trace again when
        # any rank's lost records
        flag = torch.tensor([int(ok)],
                            device=pdist.wire_device(None, planes[0].device))
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())
    sharded_cdef.exchange_halo_cols_fill = timed
    try:
        ev, _, _ = complete_events(call, iters, "cdef_shard_kernel",
                                   agree)
        ev = [e for e in ev if "cdef_shard_kernel" in e.name]
        rec = {"kernel_ms": sum(e.time_range.elapsed_us() for e in ev) /
               1e3 / iters, "kernels_per_call": len(ev) / iters,
               "kernel_timed_by": "profiler"}
    except RecordsLost:
        # every rank's traces lost records (the verdict is the group's)
        ms, per_call = launch_ms(call, iters)
        rec = {"kernel_ms": ms, "kernels_per_call": per_call,
               "kernel_timed_by": "CUDA events around each launch"}
    finally:
        sharded_cdef.exchange_halo_cols_fill = real
    rec["halo_ms"] = sum(spent[-iters:]) * 1e3 / iters
    return rec


def _frames_run(args, dev, res):
    from av1dec_tpu_torch.api import display_md5
    from av1dec_tpu_torch.bindings import NativeParser
    from av1dec_tpu_torch.container import read_temporal_units
    from av1dec_tpu_torch.ops.kernels import deblock, wavefront
    from av1dec_tpu_torch.parallel.mesh import make_mesh
    from av1dec_tpu_torch.parallel.sharded_frames import \
        decode_frames_sharded
    from av1dec_tpu_torch.pipeline.device_recon import DeviceRecon
    K = FRAMES_DATA
    parser = NativeParser()
    drs = []
    for _, tu in read_temporal_units(args.frames):
        for hdr, plans in parser.parse_tu(tu, with_plans=True):
            if plans is not None and len(drs) < K:
                drs.append(DeviceRecon(parser.seq, hdr, plans))
        if len(drs) == K:
            break
    parser.close()
    mesh = make_mesh(data=K)
    t0 = time.perf_counter()
    scans0 = wavefront.launches
    dbl0 = deblock.launches
    frames = decode_frames_sharded(drs, mesh, device=dev)
    res["frames_s"] = time.perf_counter() - t0
    # this rank scanned frame `frame_index`: its scan kernel launches and
    # the levels with lanes their counters report complete
    res["frame_index"] = mesh.index("data")
    res["scan_launches"] = wavefront.launches - scans0
    res["scan_levels"] = (wavefront.levels_completed()
                          if res["scan_launches"] else 0)
    res["deblock_launches"] = deblock.launches - dbl0
    res["frames"] = [
        display_md5(planes, dr.sch.bd, dr.hdr["upscaled_width"],
                    dr.hdr["frame_height"],
                    (dr.sch.sub_x, dr.sch.sub_y))
        for dr, planes in zip(drs, frames)]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m "
                                 "av1dec_tpu_torch.parallel.worker")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--backend")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    ap.add_argument("--gops")
    ap.add_argument("--cdef")
    ap.add_argument("--n-space", type=int, nargs="*", default=[])
    ap.add_argument("--frames")
    ap.add_argument("--time", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from av1dec_tpu_torch import resolve_device
    from av1dec_tpu_torch.api import display_md5
    from av1dec_tpu_torch.parallel import dist as pdist
    from av1dec_tpu_torch.parallel import halo
    from av1dec_tpu_torch.parallel.mesh import make_mesh
    backend = pdist.initialize_distributed(
        args.coordinator, args.world, args.rank, backend=args.backend)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    res = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": backend, "device": str(dev)}
    try:
        ids = torch.tensor([dist.get_rank()], dtype=torch.int64,
                           device=pdist.wire_device(None, dev))
        dist.all_reduce(ids)
        res["all_reduce"] = int(ids.item())
        res["in_half_mesh"] = make_mesh(max(1, args.world // 2)) \
            is not None
        row = pdist.global_mesh("space")
        block = torch.as_tensor(halo_block(dist.get_rank()), device=dev)
        res["halo"] = {
            "cols": halo.exchange_halo_cols(block, 2, row).tolist(),
            "fill": halo.exchange_halo_cols_fill(block, 2, -1, row)
            .tolist()}
        if args.gops:
            res["gops"] = {
                str(gi): [display_md5(planes, bd, w, h, ss)
                          for planes, bd, ss, _, _, w, h in frames]
                for gi, frames in pdist.decode_my_gops(args.gops,
                                                       device=dev)}
        if args.cdef:
            _cdef_runs(args, dev, res)
        if args.frames:
            _frames_run(args, dev, res)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def free_port():
    """A free TCP port on localhost (bound to port 0, then released)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(world, out_dir, extra=(), backend=None, device="cuda",
           timeout=300):
    """Run `world` worker processes (ranks 0..world-1) on localhost with
    the arguments `extra`, on `device` (a card unless "cpu" is named),
    with `backend` (None: the workers' rule, `initialize_distributed`'s:
    NCCL when every rank has a card, else name one); wait at most
    `timeout` seconds, killing every one of them on a failure or a
    timeout.  Returns the ranks' results in rank order;
    raises RuntimeError with the failed rank's output.  The workers run
    from the checkout's root, so `-m` finds the package there."""
    from av1dec_tpu_torch import resolve_device
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(os.path.join(out_dir, f"rank{r}.log"), "wb")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "av1dec_tpu_torch.parallel.worker",
                 "--coordinator", f"localhost:{port}", "--world",
                 str(world), "--rank", str(r), "--device", str(device),
                 "--out", out_dir] +
                (["--backend", backend] if backend else []) +
                [str(a) for a in extra], cwd=repo,
                stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            for r, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                        raise RuntimeError(
                            f"worker rank {r} of {world} exited "
                            f"{p.returncode}:\n{f.read()[-3000:]}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"workers of {world} ranks timed out "
                                   f"after {timeout} s")
            time.sleep(0.1)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                    raise RuntimeError(f"worker rank {r} of {world} exited "
                                       f"{p.returncode}:\n"
                                       f"{f.read()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


if __name__ == "__main__":
    sys.exit(main())
