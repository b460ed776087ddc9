"""The host half of av1dec_tpu_torch is a copy of av1dec_tpu's: each
copy is locked to its original, in source and on the committed streams
(parsed plans, schedules, residuals, deblock maps, CDEF gates, LR and
superres arguments, constant tables)."""
import ast
import filecmp
import os

import numpy as np
import pytest

from torch_port_helpers import parse, small_streams

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "av1dec_tpu", "av1dec_tpu_torch"

# copied whole: identical but for the package name in imports
WHOLE = ["config.py", "ops/tables_data.py", "ops/qm_data.py",
         "ops/spec/__init__.py", "ops/spec/intra.py", "ops/spec/itx.py",
         "ops/spec/dequant.py", "ops/spec/deblock.py", "ops/spec/cdef.py",
         "ops/spec/superres.py", "ops/spec/superres_filter.py",
         "ops/spec/lr.py"]

# (port module, reference module, top-level names that may differ)
PARTIAL = [
    ("container.py", "container.py", set()),
    ("bindings.py", "bindings.py", {"_LIB_PATH", "_load"}),
    ("pipeline/wavefront.py", "pipeline/wavefront.py",
     {"build_schedule_fast"}),
    ("ops/kernels/wavefront.py", "ops/kernels/wavefront.py",
     {"_gather_edges", "_edge_filter", "_upsample", "_dir_lut",
      "_predict_dir", "_predict_fi", "_smooth_all", "_paeth_b",
      "_cfl_adjust", "_apply_bucket", "run_wavefront"}),
    ("ops/kernels/cdef.py", "ops/kernels/cdef.py",
     {"_PROJ_FLAT", "_DIV", "_UV_DIR_422", "_directions", "_ilog2",
      "_constrain", "_filter_plane", "_cdef_core", "cdef_frame"}),
    ("pipeline/device_recon.py", "pipeline/device_recon.py",
     {"_superres_dev", "_postfilter_chain", "DeviceRecon", "prep_batch",
      "dispatch_batch"}),
]
# methods of DeviceRecon copied as they are
DR_METHODS = ["_needs_pre_cdef", "_residuals_flat_np", "_bucket_rows",
              "_palette_tensor", "_lr_wiener_args", "_superres_args",
              "finish_host"]


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
        match, mismatch, errors = filecmp.cmpfiles(a, b, names,
                                                   shallow=False)
        assert not mismatch and not errors, (mismatch, errors)
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
    for name in shared:
        assert ast.dump(port[name]) == ast.dump(ref[name]), \
            f"{port_rel}: {name} differs from {REF}/{ref_rel}"


def test_device_recon_methods_copied():
    def methods(src):
        cls = _defs(src)["DeviceRecon"]
        return {n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)}
    port = methods(_read(PORT, "pipeline/device_recon.py"))
    ref = methods(_ref_src("pipeline/device_recon.py"))
    for name in DR_METHODS:
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


@pytest.mark.parametrize("name", small_streams())
def test_host_half_equal_on_stream(name, native_lib):
    from av1dec_tpu.ops.kernels import cdef as jc
    from av1dec_tpu.ops.spec.deblock import build_deblock_maps as jmaps
    from av1dec_tpu.pipeline.device_recon import DeviceRecon as JDR
    from av1dec_tpu.pipeline.device_recon import prep_batch as jprep
    from av1dec_tpu_torch.ops.kernels import cdef as tc
    from av1dec_tpu_torch.ops.spec.deblock import build_deblock_maps as tmaps
    from av1dec_tpu_torch.pipeline.device_recon import DeviceRecon as TDR
    from av1dec_tpu_torch.pipeline.device_recon import prep_batch as tprep
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
        res = tb["res_np"]
        np.testing.assert_array_equal(res, jb["res_np"][:len(res)])
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
