"""The host half of av1dec_tpu_torch is a copy of av1dec_tpu's: each
copy is locked to its original, in source and on the committed streams
(parsed plans, schedules, residuals, deblock maps, CDEF gates, LR and
superres arguments, constant tables)."""
import ast
import filecmp
import os

import numpy as np
import pytest

from torch_port_helpers import intra_streams, parse

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "av1dec_tpu", "av1dec_tpu_torch"

# copied whole: identical but for the package name in imports
WHOLE = ["config.py", "ops/tables_data.py", "ops/qm_data.py",
         "ops/spec/__init__.py", "ops/spec/intra.py", "ops/spec/itx.py",
         "ops/spec/dequant.py", "ops/spec/deblock.py", "ops/spec/cdef.py",
         "ops/spec/superres.py", "ops/spec/superres_filter.py",
         "ops/spec/lr.py", "ops/gaussian_seq.py", "ops/spec/film_grain.py"]

# (port module, reference module, top-level names that may differ)
PARTIAL = [
    # the GOP workers differ: they run on the caller's device (the JAX
    # package's run on its host path), in `spawn` processes (CUDA cannot
    # be forked), and only a dead worker's GOP is retried (a decode
    # error propagates)
    ("container.py", "container.py",
     {"_decode_gop", "_run_jobs_elastic", "decode_gops_parallel",
      # the raw OBU probe accepts a sizeless last OBU, as the spec does
      "_walks_as_obu_stream"}),
    # libaom's compound and inter-intra masks and weights (the
    # reference's differ from libaom's, ROADMAP queue 3): distance
    # weights; the smooth inter-intra masks at the plane block's size,
    # stepped by 128 / max(w, h); the wedge sign flip by the spec's
    # average rule; the wide blocks' vertical wedges at x offsets 2, 4, 6
    ("ops/spec/inter.py", "ops/spec/inter.py",
     {"dist_weights", "interintra_mask", "wedge_mask", "WEDGE_CODEBOOK",
      # the reference's all-zero sign-flip table: the port derives the
      # sign in `wedge_mask`
      "WEDGE_SIGNFLIP"}),
    # libaom's wedge masters: the even and odd oblique ones swapped, the
    # vertical one as libaom has it
    ("ops/inter_tables.py", "ops/inter_tables.py",
     {"WEDGE_MASTER_OBLIQUE_EVEN", "WEDGE_MASTER_OBLIQUE_ODD",
      "WEDGE_MASTER_VERTICAL"}),
    # the difference-weighted mask comes from the luma predictions and
    # chroma takes it subsampled (the reference recomputes it per
    # plane); the smooth inter-intra masks are not subsampled
    ("pipeline/inter_pred.py", "pipeline/inter_pred.py",
     {"InterPredictor"}),
    ("bindings.py", "bindings.py", {"_LIB_PATH", "_load"}),
    ("pipeline/wavefront.py", "pipeline/wavefront.py",
     {"build_schedule_fast"}),
    ("ops/kernels/wavefront.py", "ops/kernels/wavefront.py",
     {"_gather_edges", "_edge_filter", "_upsample", "_dir_lut",
      "_predict_dir", "_predict_fi", "_smooth_all", "_paeth_b",
      "_cfl_adjust", "_apply_bucket"}),
    ("ops/kernels/cdef.py", "ops/kernels/cdef.py",
     {"_PROJ_FLAT", "_DIV", "_UV_DIR_422", "_directions", "_ilog2",
      "_constrain", "_filter_plane", "_cdef_core", "cdef_frame"}),
    ("pipeline/device_recon.py", "pipeline/device_recon.py",
     {"_postfilter_chain", "DeviceRecon", "prep_batch", "dispatch_batch"}),
    ("ops/kernels/mc.py", "ops/kernels/mc.py",
     {"_mc_list", "_mc_bucket", "run_mc"}),
    # _bucket_for takes arrays too, for InterPlan's whole-frame lanes; held
    # to the reference's in test_lifted_helpers_and_tables
    ("pipeline/device_inter.py", "pipeline/device_inter.py",
     {"InterPlan", "_bucket_for"}),
    ("pipeline/recon.py", "pipeline/recon.py", {"FrameRecon"}),
]
# reference top-level names each port module leaves out
DROPPED = {
    # the port builds its own library (`build_native`)
    "bindings.py": {"rebuild_native"},
    # the NumPy level-batch executor and its schedule oracle: the port's
    # scan is `ops/kernels/wavefront.py`; `_alpha` stays
    "pipeline/wavefront.py": {
        "WavefrontRecon", "_cfl_adjust", "_dir_lut", "_edge_filter_batch",
        "_gather_edges", "_level_for", "_paeth_batch", "_predict_dir",
        "_predict_fi", "_predict_level", "_smooth_batch", "_upsample_batch",
        "build_schedule_ref"},
    # the chunked scan: the port runs one scan into a preallocated buffer
    "ops/kernels/wavefront.py": {"CHUNK", "_ALL_FAMS", "_take3",
                                 "run_wavefront", "run_wavefront_chunk"},
    # the Pallas kernel and its tiling: `csrc/cdef_filter.cu` and
    # `csrc/cdef_frame.cu` take their place
    "ops/kernels/cdef.py": {"_TH", "_cdef_all", "_cdef_tile_kernel",
                            "_filter_plane_pallas"},
    # XLA's padded shape buckets: the port runs exact shapes; superres is
    # `ops/kernels/superres.py` (a kernel and its plain version), whose
    # output tests/test_torch_deblock_lr.py holds to `_superres_dev`'s
    "pipeline/device_recon.py": {"_CAPS", "_cap", "_caps_for", "_pad_rows",
                                 "_pow2", "run_device_batch",
                                 "_superres_dev"},
    "pipeline/device_inter.py": {"_MC_CAPS"},
    # the AV1DEC_DEVICE switch: the port passes the device explicitly;
    # `_alpha` is imported from `pipeline/wavefront.py`
    "pipeline/recon.py": {"_DEVICE", "_alpha", "device_mode",
                          "set_device_mode"},
}
# methods of DeviceRecon copied as they are
DR_METHODS = ["_needs_pre_cdef", "_residuals_flat_np", "_bucket_rows",
              "_palette_tensor", "_lr_wiener_args", "_superres_args",
              "finish_host"]
# methods of InterPlan copied as they are (not _list_params and
# _build_lanes: whole-frame NumPy rewrite; output held to the
# reference's by tests/test_torch_inter_lanes.py and
# test_torch_inter.py's test_inter_plan_matches_jax)
IP_METHODS = ["_pack_refs"]
# methods of InterPredictor copied as they are (all but predict_block,
# which builds the difference-weighted mask from the luma predictions,
# and _compound_blend, which takes it, and _interintra, which builds
# the smooth masks at the plane's size)
IPRED_METHODS = ["__init__", "rel_dist", "_tile_row_start",
                 "_tile_col_start", "_ref_planes", "_gm_shear_params",
                 "_pred_one", "_scaled", "_obmc", "_obmc_one"]
# native sources repaired in the port: the checkpoint reader bounds
# every vector before it allocates and commits only a whole blob
# (capi.cc); the compound-mode context map, the one-neighbour
# comp_ref_type context and the single-reference extra search over a
# compound neighbour's two lists follow libaom (inter.cc); a chroma
# palette map under 4 samples wide or high is widened by 2
# (tile_decode.cc); a refreshed slot saves its frame's reference order
# hints as they were before the refresh (headers.cc)
NATIVE_REPAIRED = {("src", "capi.cc"), ("src", "inter.cc"),
                   ("src", "tile_decode.cc"), ("src", "headers.cc")}
# methods of FrameRecon copied as they are (the block walk `run`
# included)
FR_METHODS = ["g", "_alloc_view", "warp_for_block", "_block_origin",
              "_filter_type", "run"]


def _read(pkg, rel):
    with open(os.path.join(_REPO, pkg, rel)) as f:
        return f.read()


def _strip_docstrings(tree):
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(getattr(body[0], "value", None), ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return tree


def _defs(src):
    out = {}
    for node in _strip_docstrings(ast.parse(src)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        out[n.id] = node
    return out


def _ref_src(rel):
    return _read(REF, rel).replace("av1dec_tpu.", "av1dec_tpu_torch.")


def test_native_sources_byte_identical():
    for sub in ("include", "src"):
        a = os.path.join(_REPO, REF, "native", sub)
        b = os.path.join(_REPO, PORT, "native", sub)
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b))
        repaired = sorted(n for s, n in NATIVE_REPAIRED if s == sub)
        match, mismatch, errors = filecmp.cmpfiles(
            a, b, [n for n in names if n not in repaired], shallow=False)
        assert not mismatch and not errors, (mismatch, errors)
        _, differ, errors = filecmp.cmpfiles(a, b, repaired, shallow=False)
        assert differ == repaired and not errors
    assert filecmp.cmp(os.path.join(_REPO, REF, "native", "Makefile"),
                       os.path.join(_REPO, PORT, "native", "Makefile"),
                       shallow=False)


@pytest.mark.parametrize("rel", WHOLE)
def test_whole_copies(rel):
    assert _read(PORT, rel) == _ref_src(rel)


@pytest.mark.parametrize("port_rel,ref_rel,changed", PARTIAL,
                         ids=[p[0] for p in PARTIAL])
def test_partial_copies(port_rel, ref_rel, changed):
    port = _defs(_read(PORT, port_rel))
    ref = _defs(_ref_src(ref_rel))
    shared = sorted(set(port) & set(ref) - changed)
    assert shared, port_rel
    assert set(ref) - set(port) - changed == DROPPED.get(port_rel, set())
    for name in shared:
        assert ast.dump(port[name]) == ast.dump(ref[name]), \
            f"{port_rel}: {name} differs from {REF}/{ref_rel}"


def _methods(src, cls):
    return {n.name: n for n in _defs(src)[cls].body
            if isinstance(n, ast.FunctionDef)}


def test_device_recon_methods_copied():
    port = _methods(_read(PORT, "pipeline/device_recon.py"), "DeviceRecon")
    ref = _methods(_ref_src("pipeline/device_recon.py"), "DeviceRecon")
    for name in DR_METHODS:
        assert ast.dump(port[name]) == ast.dump(ref[name]), name


def test_inter_plan_methods_copied():
    port = _methods(_read(PORT, "pipeline/device_inter.py"), "InterPlan")
    ref = _methods(_ref_src("pipeline/device_inter.py"), "InterPlan")
    for name in IP_METHODS:
        assert ast.dump(port[name]) == ast.dump(ref[name]), name


def test_inter_predictor_methods_copied():
    port = _methods(_read(PORT, "pipeline/inter_pred.py"), "InterPredictor")
    ref = _methods(_ref_src("pipeline/inter_pred.py"), "InterPredictor")
    assert set(port) == set(ref)
    assert set(port) - set(IPRED_METHODS) == {
        "predict_block", "_compound_blend", "_interintra"}
    for name in IPRED_METHODS:
        assert ast.dump(port[name]) == ast.dump(ref[name]), name


def test_frame_recon_methods_copied():
    port = _methods(_read(PORT, "pipeline/recon.py"), "FrameRecon")
    ref = _methods(_ref_src("pipeline/recon.py"), "FrameRecon")
    for name in FR_METHODS:
        assert ast.dump(port[name]) == ast.dump(ref[name]), name


def test_lifted_helpers_and_tables():
    from av1dec_tpu.ops.kernels import cdef as jc
    from av1dec_tpu.ops.kernels import wavefront as jw
    from av1dec_tpu.pipeline import recon
    from av1dec_tpu.pipeline import device_recon as jdr
    from av1dec_tpu_torch.ops.kernels import cdef as tc
    from av1dec_tpu_torch.ops.kernels import wavefront as tw
    from av1dec_tpu_torch.pipeline import device_recon as tdr
    from av1dec_tpu_torch.pipeline import wavefront as twf
    for sign in range(8):
        for idx in range(256):
            for plane in (1, 2):
                assert twf._alpha(sign, idx, plane) == \
                    recon._alpha(sign, idx, plane)
    np.testing.assert_array_equal(tc._PROJ_FLAT, np.asarray(jc._PROJ_FLAT))
    np.testing.assert_array_equal(tc._DIV, np.asarray(jc._DIV))
    np.testing.assert_array_equal(tc._UV_DIR_422,
                                  np.asarray(jc._UV_DIR_422))
    np.testing.assert_array_equal(tc._DIR_DY, jc._DIR_DY)
    np.testing.assert_array_equal(tc._DIR_DX, jc._DIR_DX)
    np.testing.assert_array_equal(tw._KERN, jw._KERN)
    np.testing.assert_array_equal(tw._SM, jw._SM)
    np.testing.assert_array_equal(
        tw._FI_TAPS, np.asarray(jw.FILTER_INTRA_TAPS, np.int32)[:, :, :7])
    assert tw._DEV_FIELDS == jw._DEV_FIELDS
    assert (tdr.BUCKETS, tdr.BWIN, tdr.FLAT_PAD) == \
        (jdr.BUCKETS, jdr.BWIN, jdr.FLAT_PAD)
    from av1dec_tpu.ops.kernels import mc as jmc
    from av1dec_tpu.pipeline import device_inter as jdi
    from av1dec_tpu_torch.ops.kernels import mc as tmc
    from av1dec_tpu_torch.pipeline import device_inter as tdi
    assert tmc.MC_FIELDS == jmc.MC_FIELDS and tmc._MF == jmc._MF
    np.testing.assert_array_equal(tmc._FTAB, jmc._FTAB)
    assert (tdi.MC_BUCKETS, tdi.BLOCK_W4, tdi.BLOCK_H4) == \
        (jdi.MC_BUCKETS, jdi.BLOCK_W4, jdi.BLOCK_H4)
    for w in range(1, 140):
        assert tdi._bucket_for(w, 4) == jdi._bucket_for(w, 4)
    np.testing.assert_array_equal(
        tdi._bucket_for(np.arange(1, 140), np.arange(139, 0, -1)),
        [jdi._bucket_for(w, 140 - w) for w in range(1, 140)])


def _plans_equal(a, b):
    for f in ("mi", "tx", "coeffs", "palettes", "color_map", "lr",
              "warps"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert (a.mi_rows, a.mi_cols) == (b.mi_rows, b.mi_cols)


def _schedules_equal(a, b):
    assert sorted(a.classes) == sorted(b.classes)
    for key in a.classes:
        ca, cb = a.classes[key], b.classes[key]
        np.testing.assert_array_equal(ca.levels_sorted, cb.levels_sorted)
        for f in ca.packed:
            np.testing.assert_array_equal(ca.packed[f], cb.packed[f], f)
    for attr in ("n_levels", "res_count", "res_recs", "alloc_dims",
                 "valid_dims", "plane_base", "flat_len"):
        assert getattr(a, attr) == getattr(b, attr), attr
    assert sorted(a.pal_preds) == sorted(b.pal_preds)
    for key in a.pal_preds:
        for pa, pb in zip(a.pal_preds[key], b.pal_preds[key]):
            np.testing.assert_array_equal(pa, pb)


def _nested_equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _nested_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", intra_streams())
def test_host_half_equal_on_stream(name, native_lib):
    from av1dec_tpu.ops.kernels import cdef as jc
    from av1dec_tpu.ops.spec.deblock import build_deblock_maps as jmaps
    from av1dec_tpu.pipeline.device_recon import DeviceRecon as JDR
    from av1dec_tpu.pipeline.device_recon import prep_batch as jprep
    from av1dec_tpu_torch.ops.kernels import cdef as tc
    from av1dec_tpu_torch.ops.spec.deblock import build_deblock_maps as tmaps
    from av1dec_tpu_torch.pipeline.device_recon import DeviceRecon as TDR
    from av1dec_tpu_torch.pipeline.device_recon import prep_batch as tprep
    from av1dec_tpu_torch.pipeline.device_recon import (batch_residuals,
                                                        to_torch_inputs)
    jf, tf = parse(name, "jax"), parse(name, "torch")
    assert len(jf) == len(tf) > 0
    for (js, jh, jp), (ts, th, tp) in zip(jf, tf):
        assert js == ts and jh == th
        _plans_equal(jp, tp)
        jd, td = JDR(js, jh, jp), TDR(ts, th, tp)
        _schedules_equal(jd.sch, td.sch)
        np.testing.assert_array_equal(jd._residuals_flat_np(),
                                      td._residuals_flat_np())
        n = td.sch.num_planes
        _nested_equal(jmaps(js, jh, jp, n), tmaps(ts, th, tp, n))
        _nested_equal(jc.compute_gates(js, jh, jp, n, jd.sch.bd),
                      tc.compute_gates(ts, th, tp, n, td.sch.bd))
        if td._needs_pre_cdef():
            _nested_equal(jd._lr_wiener_args(), td._lr_wiener_args())
        if th.get("use_superres"):
            _nested_equal(jd._superres_args(), td._superres_args())
        # one-frame batches: the JAX rows carry power-of-two padding
        jb, tb = jprep([jd]), tprep([td])
        for t in tb["inputs_np"]:
            rows, starts, counts = tb["inputs_np"][t]
            jrows, jstarts, jcounts = jb["inputs_np"][t]
            np.testing.assert_array_equal(rows, jrows[:len(rows)])
            np.testing.assert_array_equal(starts, jstarts)
            np.testing.assert_array_equal(counts, jcounts)
            P = tb["pal_np"][t].shape[0]
            np.testing.assert_array_equal(tb["pal_np"][t],
                                          jb["pal_np"][t][:P])
        # the port's residuals, from its packed levels where the frame
        # takes the device's route, computed on the CPU
        res = batch_residuals(to_torch_inputs(tb, "cpu")).numpy()
        assert (tb["res_np"] is None) == (tb["res_levels"] is not None)
        rf = td._res_px_tot
        np.testing.assert_array_equal(res[:rf], jb["res_np"][:rf])
        assert tb["config"] == jb["config"]


def test_palette_pred_lifted(native_lib):
    from av1dec_tpu.pipeline.recon import FrameRecon
    from av1dec_tpu_torch.pipeline.wavefront import _palette_pred
    seen = 0
    for seq, hdr, plans in parse("palette", "jax"):
        fr = FrameRecon(seq, hdr, plans)
        pal_y, pal_uv = plans.grid("palette_y"), plans.grid("palette_uv")
        for rec in plans.tx:
            plane, x4, y4, tsz = (int(v) for v in rec[:4])
            mi_r, mi_c = divmod(int(rec[7]), plans.mi_cols)
            if (pal_y if plane == 0 else pal_uv)[mi_r, mi_c] <= 0:
                continue
            from av1dec_tpu.ops.spec.itx import TX_DIMS
            w, h = (4, 4) if tsz == 19 else TX_DIMS[tsz]
            np.testing.assert_array_equal(
                _palette_pred(plans, fr.sub_x, fr.sub_y, plane, mi_r, mi_c,
                              x4 * 4, y4 * 4, w, h),
                fr._palette_pred(plane, mi_r, mi_c, x4 * 4, y4 * 4, w, h))
            seen += 1
    assert seen > 0
