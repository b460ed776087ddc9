"""The wavefront scan of av1dec_tpu_torch == av1dec_tpu's run_wavefront,
exactly, on identical prep_batch inputs (the JAX package's packed lanes,
residuals and palettes, uploaded with to_torch_inputs), from streams
with directional, filter-intra, palette and CfL lanes, one- and
two-frame batches; and the host window flags that replace the JAX
scan's run-time branches."""
import numpy as np
import pytest
import torch

from torch_port_helpers import parse

MF_DIR, MF_PAL, MF_FI, MF_INTER = 3, 8, 9, 10


def _jax_prep(name, k):
    from av1dec_tpu.pipeline.device_recon import DeviceRecon, prep_batch
    frames = parse(name, "jax")[:k]
    drs = [DeviceRecon(s, h, p) for s, h, p in frames]
    assert all(dr.supported() for dr in drs)
    return prep_batch(drs)


def _jax_scan(prep):
    import jax.numpy as jnp
    from av1dec_tpu.ops.kernels.wavefront import run_wavefront
    inputs = {t: (jnp.asarray(p), s, c)
              for t, (p, s, c) in prep["inputs_np"].items()}
    frame0 = jnp.zeros(prep["K"] * prep["flat"], jnp.int32)
    return np.asarray(run_wavefront(
        frame0, inputs, jnp.asarray(prep["res_np"]),
        {t: jnp.asarray(a) for t, a in prep["pal_np"].items()},
        prep["config"]))


# (stream, frames per batch, mode families the stream must exercise)
CASES = [("base", 1, {"dir", "fi", "cfl"}), ("palette", 1, {"pal"}),
         ("i444", 1, {"dir", "fi", "cfl"}), ("multi", 2, {"cfl", "fi"})]


@pytest.mark.parametrize("name,k,fams", CASES, ids=[c[0] for c in CASES])
def test_scan_matches_jax(name, k, fams, native_lib):
    from av1dec_tpu_torch.ops.kernels.wavefront import (FLAG_CFL, FLAG_DIR,
                                                        FLAG_FI_PATCHES,
                                                        FLAG_PAL)
    from av1dec_tpu_torch.pipeline.device_recon import (scan_batch,
                                                        to_torch_inputs)
    prep = _jax_prep(name, k)
    assert prep["K"] == k
    inputs = to_torch_inputs(prep, "cpu")
    flags = inputs["windows"][2]
    seen = {"dir": flags[..., FLAG_DIR].any(),
            "pal": flags[..., FLAG_PAL].any(),
            "cfl": flags[..., FLAG_CFL].any(),
            "fi": flags[..., FLAG_FI_PATCHES].any()}
    assert all(seen[f] for f in fams), seen
    got = scan_batch(inputs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_scan(prep))


@pytest.mark.parametrize("name", ["base", "palette", "lossless"])
def test_window_flags_match_lanes(name, native_lib):
    from av1dec_tpu.ops.kernels.wavefront import make_windows as jwin
    from av1dec_tpu_torch.ops.kernels.wavefront import (FLAG_CFL, FLAG_DIR,
                                                        FLAG_FI_PATCHES,
                                                        FLAG_INTER, FLAG_PAL,
                                                        _F, plan_windows)
    prep = _jax_prep(name, 1)
    ts = [t for t, _ in prep["buckets"]]
    inp = prep["inputs_np"]
    ws, wc, flags = plan_windows({t: inp[t][0] for t in ts},
                                 {t: inp[t][1] for t in ts},
                                 {t: inp[t][2] for t in ts},
                                 prep["buckets"])
    jws, jwc = jwin({t: inp[t][1] for t in ts}, {t: inp[t][2] for t in ts},
                    dict(prep["buckets"]), ts)
    np.testing.assert_array_equal(ws, jws)
    np.testing.assert_array_equal(wc, jwc)
    for s in range(ws.shape[0]):
        for bi, t in enumerate(ts):
            rows = inp[t][0][ws[s, bi]:ws[s, bi] + wc[s, bi]]
            mf = rows[:, _F["mode_family"]]
            fi = mf == MF_FI
            want = [(mf == MF_DIR).any(), (mf == MF_PAL).any(),
                    (rows[:, _F["cfl_maxx"]] > 0).any(),
                    ((rows[fi, _F["h"]] >> 1) *
                     (rows[fi, _F["w"]] >> 2)).max() if fi.any() else 0,
                    (mf == MF_INTER).any()]
            got = flags[s, bi, [FLAG_DIR, FLAG_PAL, FLAG_CFL,
                                FLAG_FI_PATCHES, FLAG_INTER]]
            assert list(got) == [int(w) for w in want], (s, bi)
