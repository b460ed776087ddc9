"""av1dec_tpu_torch command-line decoder.

Usage:
    python -m av1dec_tpu_torch <input.ivf> [-o out.yuv | --y4m out.y4m]
                               [--md5] [--frame-md5] [--limit N]
                               [--summary] [--device cuda|cpu] [--stats]
                               [--gop-workers N]

Decodes every frame the JAX package's CLI decodes, but frames with a
compound block (see `api.py`): raw YUV or Y4M output, MD5 checksums of
the output planes, frame limits, a decode-rate summary, the per-frame
decode records (`--stats`, with the path each frame took) and
GOP-parallel decode in worker processes (`--gop-workers`), as the JAX
package's CLI.
"""
import argparse
import hashlib
import sys
import time

import numpy as np


def _plane_bytes(frame):
    """Output planes as raw bytes (8-bit: u8; >8-bit: little-endian u16)."""
    bd = frame.bit_depth
    out = b""
    for p in frame.planes:
        a = np.asarray(p)
        if bd > 8:
            out += a.astype("<u2").tobytes()
        else:
            out += a.astype(np.uint8).tobytes()
    return out


def _y4m_header(frame):
    """The Y4M stream header of frames like `frame` (the JAX package's
    CLI writes the same bytes)."""
    h, w = np.asarray(frame.planes[0]).shape
    cs = {(1, 1): "420jpeg", (1, 0): "422", (0, 0): "444"}[frame.subsampling]
    if len(frame.planes) == 1:
        cs = "mono"
    if frame.bit_depth > 8:
        cs += f"p{frame.bit_depth}"
    return f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C{cs}\n".encode()


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m av1dec_tpu_torch",
        description="AV1 decoder on PyTorch/CUDA")
    ap.add_argument("input", help="input file (IVF, Annex-B or OBU)")
    ap.add_argument("-o", "--output", help="raw YUV output file")
    ap.add_argument("--y4m", help="Y4M output file")
    ap.add_argument("--md5", action="store_true",
                    help="print MD5 over all output frames")
    ap.add_argument("--frame-md5", action="store_true",
                    help="print per-frame MD5 checksums")
    ap.add_argument("--limit", type=int, default=0,
                    help="decode at most N frames")
    ap.add_argument("--summary", action="store_true",
                    help="print decode-rate summary")
    ap.add_argument("--threads", type=int, default=1,
                    help="entropy-decode worker threads (tile-parallel)")
    ap.add_argument("--gop-workers", type=int, default=0,
                    help="decode keyframe-delimited GOPs in N parallel "
                         "worker processes on --device (with elastic "
                         "recovery); 0 = serial")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pixel path: cuda (default) "
                         "or cpu")
    ap.add_argument("--no-grain", action="store_true",
                    help="skip film-grain synthesis at output")
    ap.add_argument("--stats", action="store_true",
                    help="print per-frame decode records (JSON lines)")
    args = ap.parse_args(argv)

    from av1dec_tpu_torch.api import Decoder
    from av1dec_tpu_torch.config import DecoderConfig
    from av1dec_tpu_torch.container import (decode_gops_parallel,
                                            read_temporal_units)

    config = DecoderConfig(threads=args.threads,
                           apply_grain=not args.no_grain,
                           max_frames=args.limit)
    t0 = time.monotonic()
    n = 0
    total_md5 = hashlib.md5()
    dec = None
    if args.gop_workers > 1:
        gops = []
        frames = decode_gops_parallel(
            args.input, workers=args.gop_workers, config=config,
            device=args.device, stats=gops)
        stats = [rec for gop in gops for rec in gop["frames"]]
    else:
        dec = Decoder(config, device=args.device)
        stats = dec.stats
        frames = (fr for _, tu in read_temporal_units(args.input)
                  for fr in dec.decode(tu))
    out_f = open(args.output, "wb") if args.output else None
    y4m_f = open(args.y4m, "wb") if args.y4m else None
    try:
        for frame in frames:
            raw = _plane_bytes(frame)
            if args.frame_md5:
                print(f"frame {n}: {hashlib.md5(raw).hexdigest()}")
            if args.md5:
                total_md5.update(raw)
            if out_f:
                out_f.write(raw)
            if y4m_f:
                if n == 0:
                    y4m_f.write(_y4m_header(frame))
                y4m_f.write(b"FRAME\n")
                y4m_f.write(raw)
            n += 1
            if args.limit and n >= args.limit:
                break
    finally:
        if dec is not None:
            dec.close()
        if out_f:
            out_f.close()
        if y4m_f:
            y4m_f.close()
    dt = time.monotonic() - t0
    if args.stats:
        import json
        for rec in stats:
            print(json.dumps(rec), file=sys.stderr)
    if args.md5:
        print(total_md5.hexdigest())
    if args.summary:
        print(f"{n} frames in {dt:.3f}s ({n / dt:.2f} fps)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
