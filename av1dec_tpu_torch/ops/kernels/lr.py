"""Loop restoration on the device — Wiener filter, whole-plane torch.
[SPEC §7.17.4]

Port of `av1dec_tpu.ops.kernels.lr`: the 7-tap separable Wiener filter
as whole-plane passes with per-pixel taps gathered from the per-unit
coefficient maps.  LR's stripe-boundary reads (each 64-luma-row stripe
reads at most 2 rows above/below itself, from the deblocked pre-CDEF
frame) become 7 per-output-row gathers: per vertical tap, the
stripe-clamped source row is picked from the right plane (post- or
pre-CDEF), with indices and inside-stripe masks precomputed on the host
(`DeviceRecon._lr_wiener_args`), and filtered horizontally with the
taps of the output row's restoration unit, as `ops/spec/lr.lr_frame`
filters each unit's window with that unit's taps.  (The JAX pass
filters each source row with its own unit's taps, which differs from
the spec on the two rows on either side of a chroma unit-row
boundary.)  Each distinct (source plane, source row, unit row) is
filtered horizontally once: about one pass over the plane, plus the
rows near stripe and unit-row boundaries.  Frames with a self-guided
unit keep the host LR tail (`pipeline/device_recon.py` `finish_host`).
"""
import torch


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n


def wiener_plane(cdef_p, pre_p, args, bd):
    """One plane.  args (int32 tensors, `inside` bool, on the planes'
    device):
      uy [H], ux [W]      — unit row/col index per pixel (sentinel row/
                            col beyond the crop points at inactive
                            padding entries)
      tv, th [UR, UC, 7]  — per-unit vertical/horizontal taps
      act [UR, UC]        — unit active (Wiener) flags
      vr [7, H]           — stripe-clamped source row per (tap, row)
      inside [7, H]       — True: row from cdef; False: from pre
    """
    uy, ux, tv, th, act, vr, inside = args
    H, W = cdef_p.shape
    r0 = 5 if bd == 12 else 3
    r1 = 9 if bd == 12 else 11
    off0 = 1 << (bd + 6)
    lim = (1 << (bd + 1 + 7 - r0)) - 1
    uy, ux = uy.long(), ux.long()

    tv_px = tv[uy][:, ux]                      # [H, W, 7]

    def pad(src):
        src = src.to(torch.int32)
        return torch.cat([src[:, :1].expand(H, 3), src,
                          src[:, -1:].expand(H, 3)], dim=1)

    # the source row of vertical tap k is filtered horizontally with the
    # taps of the OUTPUT row's unit: near a unit-row boundary the clamped
    # rows belong to the next unit, whose taps differ.  Key each (tap,
    # output row) by (plane, source row, output unit row) and filter
    # each distinct key once.
    UR = th.shape[0]
    src_row = (~inside).long() * H + vr.long()         # [7, H] into z
    keys, inv = torch.unique(src_row * UR + uy, return_inverse=True)
    z = torch.cat([pad(cdef_p), pad(pre_p)])[keys // UR]
    th_k = th[keys % UR][:, ux]                        # [K, W, 7]
    h = torch.full((keys.numel(), W), off0, dtype=torch.int32,
                   device=cdef_p.device)
    for j in range(7):
        h = h + th_k[:, :, j] * z[:, j:j + W]
    h = _round2(h, r0).clamp(0, lim)
    acc = torch.full((H, W), -(1 << (bd + r1 - 1)), dtype=torch.int32,
                     device=cdef_p.device)
    for k in range(7):
        acc = acc + tv_px[:, :, k] * h[inv[k]]
    out = _round2(acc, r1).clamp(0, (1 << bd) - 1)
    act_px = act[uy][:, ux] != 0
    return torch.where(act_px, out, cdef_p.to(torch.int32))


def lr_wiener_planes(planes, pre_planes, lr_args, bd):
    """All planes; lr_args[p] is None for planes without restoration."""
    outs = []
    for p, (plane, pre) in enumerate(zip(planes, pre_planes)):
        a = lr_args[p]
        outs.append(plane if a is None
                    else wiener_plane(plane, pre, a, bd))
    return outs
