// C API for the Python/ctypes binding.
//
// Header-level information (sequence + frame headers, tile layout) is
// exported as JSON — it is small, cold data and JSON keeps the ABI trivial.
// Hot data (coefficient plans, mode-info grids) is exported as packed
// binary buffers (see plans.cc).
#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <memory>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

#include "cdf.h"
#include "decoder.h"
#include "plans.h"
#include "tile_decode.h"

using namespace av1;

namespace {

struct Handle {
  DecoderState st;
  std::vector<std::string> frame_jsons;  // JSON per completed frame in TU
  std::vector<std::shared_ptr<FramePlans>> frame_plans;  // parallel array
  std::string last_error;
  int decode_tiles = 1;  // 0 = headers only
  int threads = 1;       // tile-parallel entropy decode [SURVEY §2.4]
};

// Merge a per-tile FramePlans into the frame-level one (tile-parallel
// decode path).  mi-grid writes are disjoint by tile rect; the record
// vectors concatenate in tile order, which equals the serial decode
// order the reconstruction consumes.
void merge_tile_plans(FramePlans* dst, const FramePlans& src, int r0, int r1,
                      int c0, int c1) {
  for (int f = 0; f < N_MI_FIELDS; f++)
    for (int r = r0; r < r1; r++)
      memcpy(dst->mi.data() + ((size_t)f * dst->mi_rows + r) * dst->mi_cols +
                 c0,
             src.mi.data() +
                 ((size_t)f * src.mi_rows + (r - src.mi_row0)) * src.mi_cols +
                 (c0 - src.mi_col0),
             (size_t)(c1 - c0) * sizeof(int16_t));
  const int32_t coef_base = (int32_t)dst->coeffs.size();
  const int32_t cmap_base = (int32_t)dst->color_map.size();
  size_t txn = src.tx_records.size() / N_TXR_FIELDS;
  for (size_t i = 0; i < txn; i++) {
    const int32_t* r = &src.tx_records[i * N_TXR_FIELDS];
    int32_t rec[N_TXR_FIELDS];
    memcpy(rec, r, sizeof(rec));
    if (rec[TXR_COEF_OFF] >= 0) rec[TXR_COEF_OFF] += coef_base;
    dst->tx_records.insert(dst->tx_records.end(), rec, rec + N_TXR_FIELDS);
  }
  dst->coeffs.insert(dst->coeffs.end(), src.coeffs.begin(), src.coeffs.end());
  dst->palettes.insert(dst->palettes.end(), src.palettes.begin(),
                       src.palettes.end());
  for (int32_t off : src.color_map_off)  // keep the -1 "no map" sentinel
    dst->color_map_off.push_back(off < 0 ? off : off + cmap_base);
  dst->color_map.insert(dst->color_map.end(), src.color_map.begin(),
                        src.color_map.end());
  dst->lr_units.insert(dst->lr_units.end(), src.lr_units.begin(),
                       src.lr_units.end());
  dst->warps.insert(dst->warps.end(), src.warps.begin(), src.warps.end());
}

void json_kv(std::ostringstream& o, const char* k, long v, bool comma = true) {
  o << '"' << k << "\":" << v;
  if (comma) o << ',';
}

template <typename T>
void json_arr(std::ostringstream& o, const char* k, const T* v, int n,
              bool comma = true) {
  o << '"' << k << "\":[";
  for (int i = 0; i < n; i++) {
    if (i) o << ',';
    o << (long)v[i];
  }
  o << ']';
  if (comma) o << ',';
}

std::string seq_to_json(const SequenceHeader& s) {
  std::ostringstream o;
  o << '{';
  json_kv(o, "seq_profile", s.seq_profile);
  json_kv(o, "still_picture", s.still_picture);
  json_kv(o, "reduced_still_picture_header", s.reduced_still_picture_header);
  json_kv(o, "max_frame_width", s.max_frame_width);
  json_kv(o, "max_frame_height", s.max_frame_height);
  json_kv(o, "frame_id_numbers_present", s.frame_id_numbers_present);
  json_kv(o, "use_128x128_superblock", s.use_128x128_superblock);
  json_kv(o, "enable_filter_intra", s.enable_filter_intra);
  json_kv(o, "enable_intra_edge_filter", s.enable_intra_edge_filter);
  json_kv(o, "enable_interintra_compound", s.enable_interintra_compound);
  json_kv(o, "enable_masked_compound", s.enable_masked_compound);
  json_kv(o, "enable_warped_motion", s.enable_warped_motion);
  json_kv(o, "enable_dual_filter", s.enable_dual_filter);
  json_kv(o, "enable_order_hint", s.enable_order_hint);
  json_kv(o, "enable_jnt_comp", s.enable_jnt_comp);
  json_kv(o, "enable_ref_frame_mvs", s.enable_ref_frame_mvs);
  json_kv(o, "seq_force_screen_content_tools",
          s.seq_force_screen_content_tools);
  json_kv(o, "seq_force_integer_mv", s.seq_force_integer_mv);
  json_kv(o, "order_hint_bits", s.order_hint_bits);
  json_kv(o, "enable_superres", s.enable_superres);
  json_kv(o, "enable_cdef", s.enable_cdef);
  json_kv(o, "enable_restoration", s.enable_restoration);
  json_kv(o, "bit_depth", s.bit_depth);
  json_kv(o, "mono_chrome", s.mono_chrome);
  json_kv(o, "subsampling_x", s.subsampling_x);
  json_kv(o, "subsampling_y", s.subsampling_y);
  json_kv(o, "separate_uv_delta_q", s.separate_uv_delta_q);
  json_kv(o, "film_grain_params_present", s.film_grain_params_present);
  json_kv(o, "color_range", s.color_range);
  json_kv(o, "matrix_coefficients", s.matrix_coefficients, false);
  o << '}';
  return o.str();
}

std::string frame_to_json(const DecoderState& st) {
  const FrameHeader& h = st.hdr;
  std::ostringstream o;
  o << '{';
  json_kv(o, "show_existing_frame", h.show_existing_frame);
  json_kv(o, "frame_to_show_map_idx", h.frame_to_show_map_idx);
  json_kv(o, "frame_type", h.frame_type);
  json_kv(o, "show_frame", h.show_frame);
  json_kv(o, "showable_frame", h.showable_frame);
  json_kv(o, "error_resilient_mode", h.error_resilient_mode);
  json_kv(o, "disable_cdf_update", h.disable_cdf_update);
  json_kv(o, "allow_screen_content_tools", h.allow_screen_content_tools);
  json_kv(o, "force_integer_mv", h.force_integer_mv);
  json_kv(o, "order_hint", h.order_hint);
  json_kv(o, "primary_ref_frame", h.primary_ref_frame);
  json_kv(o, "refresh_frame_flags", h.refresh_frame_flags);
  json_kv(o, "allow_intrabc", h.allow_intrabc);
  json_arr(o, "ref_frame_idx", h.ref_frame_idx, REFS_PER_FRAME);
  json_kv(o, "allow_high_precision_mv", h.allow_high_precision_mv);
  json_kv(o, "interpolation_filter", h.interpolation_filter);
  json_kv(o, "is_motion_mode_switchable", h.is_motion_mode_switchable);
  json_kv(o, "use_ref_frame_mvs", h.use_ref_frame_mvs);
  json_kv(o, "disable_frame_end_update_cdf", h.disable_frame_end_update_cdf);
  json_kv(o, "allow_warped_motion", h.allow_warped_motion);
  json_kv(o, "reduced_tx_set", h.reduced_tx_set);
  json_kv(o, "tx_mode", h.tx_mode);
  json_kv(o, "reference_select", h.reference_select);
  json_kv(o, "skip_mode_present", h.skip_mode_present);
  json_kv(o, "frame_width", h.frame_width);
  json_kv(o, "frame_height", h.frame_height);
  json_kv(o, "upscaled_width", h.upscaled_width);
  json_kv(o, "render_width", h.render_width);
  json_kv(o, "render_height", h.render_height);
  json_kv(o, "use_superres", h.use_superres);
  json_kv(o, "superres_denom", h.superres_denom);
  json_kv(o, "mi_cols", h.mi_cols);
  json_kv(o, "mi_rows", h.mi_rows);
  json_kv(o, "coded_lossless", h.coded_lossless);
  json_kv(o, "all_lossless", h.all_lossless);
  json_kv(o, "delta_q_present", h.delta_q_present);
  json_kv(o, "delta_q_res", h.delta_q_res);
  json_kv(o, "delta_lf_present", h.delta_lf_present);
  json_kv(o, "delta_lf_res", h.delta_lf_res);
  json_kv(o, "delta_lf_multi", h.delta_lf_multi);

  o << "\"quant\":{";
  json_kv(o, "base_q_idx", h.quant.base_q_idx);
  json_kv(o, "delta_q_y_dc", h.quant.delta_q_y_dc);
  json_kv(o, "delta_q_u_dc", h.quant.delta_q_u_dc);
  json_kv(o, "delta_q_u_ac", h.quant.delta_q_u_ac);
  json_kv(o, "delta_q_v_dc", h.quant.delta_q_v_dc);
  json_kv(o, "delta_q_v_ac", h.quant.delta_q_v_ac);
  json_kv(o, "using_qmatrix", h.quant.using_qmatrix);
  json_kv(o, "qm_y", h.quant.qm_y);
  json_kv(o, "qm_u", h.quant.qm_u);
  json_kv(o, "qm_v", h.quant.qm_v, false);
  o << "},";

  o << "\"lf\":{";
  json_arr(o, "level", h.lf.level, 4);
  json_kv(o, "sharpness", h.lf.sharpness);
  json_kv(o, "delta_enabled", h.lf.delta_enabled);
  json_arr(o, "ref_deltas", h.lf.ref_deltas, TOTAL_REFS_PER_FRAME);
  json_arr(o, "mode_deltas", h.lf.mode_deltas, 2, false);
  o << "},";

  o << "\"seg\":{";
  json_kv(o, "enabled", h.seg.enabled);
  json_kv(o, "update_map", h.seg.update_map);
  json_kv(o, "temporal_update", h.seg.temporal_update);
  json_kv(o, "seg_id_pre_skip", h.seg.seg_id_pre_skip);
  json_kv(o, "last_active_seg_id", h.seg.last_active_seg_id);
  json_arr(o, "feature_enabled", &h.seg.feature_enabled[0][0],
           MAX_SEGMENTS * SEG_LVL_MAX);
  json_arr(o, "feature_data", &h.seg.feature_data[0][0],
           MAX_SEGMENTS * SEG_LVL_MAX, false);
  o << "},";

  o << "\"cdef\":{";
  json_kv(o, "damping", h.cdef.damping);
  json_kv(o, "bits", h.cdef.bits);
  json_arr(o, "y_pri", h.cdef.y_pri, 8);
  json_arr(o, "y_sec", h.cdef.y_sec, 8);
  json_arr(o, "uv_pri", h.cdef.uv_pri, 8);
  json_arr(o, "uv_sec", h.cdef.uv_sec, 8, false);
  o << "},";

  o << "\"lr\":{";
  json_arr(o, "frame_restoration_type", h.lr.frame_restoration_type, 3);
  json_arr(o, "loop_restoration_size", h.lr.loop_restoration_size, 3, false);
  o << "},";

  o << "\"tiles\":{";
  json_kv(o, "cols", h.tiles.tile_cols);
  json_kv(o, "rows", h.tiles.tile_rows);
  json_kv(o, "cols_log2", h.tiles.tile_cols_log2);
  json_kv(o, "rows_log2", h.tiles.tile_rows_log2);
  json_kv(o, "context_update_tile_id", h.tiles.context_update_tile_id);
  json_arr(o, "mi_col_starts", h.tiles.mi_col_starts, h.tiles.tile_cols + 1);
  json_arr(o, "mi_row_starts", h.tiles.mi_row_starts, h.tiles.tile_rows + 1,
           false);
  o << "},";

  o << "\"grain\":{";
  json_kv(o, "apply_grain", h.grain.apply_grain);
  json_kv(o, "grain_seed", h.grain.grain_seed);
  json_kv(o, "update_grain", h.grain.update_grain);
  json_kv(o, "num_y_points", h.grain.num_y_points);
  json_arr(o, "point_y_value", h.grain.point_y_value, 14);
  json_arr(o, "point_y_scaling", h.grain.point_y_scaling, 14);
  json_kv(o, "chroma_scaling_from_luma", h.grain.chroma_scaling_from_luma);
  json_kv(o, "num_cb_points", h.grain.num_cb_points);
  json_kv(o, "num_cr_points", h.grain.num_cr_points);
  json_arr(o, "point_cb_value", h.grain.point_cb_value, 10);
  json_arr(o, "point_cb_scaling", h.grain.point_cb_scaling, 10);
  json_arr(o, "point_cr_value", h.grain.point_cr_value, 10);
  json_arr(o, "point_cr_scaling", h.grain.point_cr_scaling, 10);
  json_kv(o, "grain_scaling", h.grain.grain_scaling);
  json_kv(o, "ar_coeff_lag", h.grain.ar_coeff_lag);
  json_arr(o, "ar_coeffs_y", h.grain.ar_coeffs_y, 24);
  json_arr(o, "ar_coeffs_cb", h.grain.ar_coeffs_cb, 25);
  json_arr(o, "ar_coeffs_cr", h.grain.ar_coeffs_cr, 25);
  json_kv(o, "ar_coeff_shift", h.grain.ar_coeff_shift);
  json_kv(o, "grain_scale_shift", h.grain.grain_scale_shift);
  json_kv(o, "cb_mult", h.grain.cb_mult);
  json_kv(o, "cb_luma_mult", h.grain.cb_luma_mult);
  json_kv(o, "cb_offset", h.grain.cb_offset);
  json_kv(o, "cr_mult", h.grain.cr_mult);
  json_kv(o, "cr_luma_mult", h.grain.cr_luma_mult);
  json_kv(o, "cr_offset", h.grain.cr_offset);
  json_kv(o, "overlap_flag", h.grain.overlap_flag);
  json_kv(o, "clip_to_restricted_range", h.grain.clip_to_restricted_range,
          false);
  o << "},";

  o << "\"gm\":{";
  json_arr(o, "type", h.gm.gm_type, NUM_REF_FRAMES);
  json_arr(o, "params", &h.gm.gm_params[0][0], NUM_REF_FRAMES * 6, false);
  o << "},";

  // OrderHints[1..7] of this frame's refs (for compound distance weights)
  {
    long hints[TOTAL_REFS_PER_FRAME] = {0};
    int rw[TOTAL_REFS_PER_FRAME] = {0}, rh[TOTAL_REFS_PER_FRAME] = {0};
    if (!h.frame_is_intra) {
      for (int rf = LAST_FRAME; rf <= ALTREF_FRAME; rf++) {
        const RefSlot& slot = st.ref[h.ref_frame_idx[rf - LAST_FRAME]];
        hints[rf] = slot.order_hint;
        rw[rf] = slot.upscaled_width;
        rh[rf] = slot.frame_height;
      }
    }
    json_arr(o, "order_hints", hints, TOTAL_REFS_PER_FRAME);
    json_arr(o, "ref_widths", rw, TOTAL_REFS_PER_FRAME);
    json_arr(o, "ref_heights", rh, TOTAL_REFS_PER_FRAME);
  }
  json_kv(o, "frame_is_intra", h.frame_is_intra);
  json_kv(o, "cur_frame_force_integer_mv", h.cur_frame_force_integer_mv);
  json_arr(o, "skip_mode_frame", h.skip_mode_frame, 2);
  json_kv(o, "enable_order_hint_seq", st.seq.enable_order_hint);
  json_kv(o, "order_hint_bits", st.seq.order_hint_bits);
  json_kv(o, "temporal_id", st.temporal_id);
  json_kv(o, "spatial_id", st.spatial_id);

  o << "\"metadata\":{";
  json_kv(o, "have_cll", st.metadata.have_cll);
  json_kv(o, "max_cll", st.metadata.max_cll);
  json_kv(o, "max_fall", st.metadata.max_fall);
  json_kv(o, "have_mdcv", st.metadata.have_mdcv);
  json_arr(o, "primaries", &st.metadata.primaries[0][0], 6);
  json_arr(o, "white_point", st.metadata.white_point, 2);
  json_kv(o, "max_luminance", (long)st.metadata.max_luminance);
  json_kv(o, "min_luminance", (long)st.metadata.min_luminance);
  json_kv(o, "n_itut_t35", st.metadata.n_itut_t35, false);
  o << "},";

  o << "\"num_tiles\":" << (long)st.tiles.size() << ',';
  o << "\"tile_sizes\":[";
  for (size_t i = 0; i < st.tiles.size(); i++) {
    if (i) o << ',';
    o << st.tiles[i].size;
  }
  o << "]}";
  return o.str();
}

int on_frame_ready_cb(DecoderState* st, void* user) {
  Handle* h = (Handle*)user;
  h->frame_jsons.push_back(frame_to_json(*st));

  std::shared_ptr<FramePlans> plans;
  if (!st->hdr.show_existing_frame && h->decode_tiles) {
    // Per-frame CDF init [SPEC §7.20]: defaults or loaded from the
    // primary reference's saved end-state.
    auto frame_cdf = std::make_shared<CdfContext>();
    if (st->hdr.primary_ref_frame == PRIMARY_REF_NONE ||
        !st->ref[st->hdr.ref_frame_idx[st->hdr.primary_ref_frame]]
             .saved_cdfs) {
      init_non_coeff_cdfs(frame_cdf.get());
      init_coeff_cdfs(frame_cdf.get(), st->hdr.quant.base_q_idx);
    } else {
      *frame_cdf =
          *st->ref[st->hdr.ref_frame_idx[st->hdr.primary_ref_frame]]
               .saved_cdfs;
    }

    plans = std::make_shared<FramePlans>();
    plans->init(st->hdr.mi_rows, st->hdr.mi_cols);
    // one decoder per frame: frame-level neighbor grids (seg ids, cdef,
    // palette) persist across tiles; per-tile contexts reset inside
    // decode_tile.  Each tile starts from the frame CDF [SPEC §8.2.1].
    TileDecoder td(st->seq, st->hdr, nullptr, plans.get());
    FrameMotionContext mctx;
    if (!st->hdr.frame_is_intra) {
      setup_motion_context(st, &mctx);  // [SPEC §7.9, §7.21]
      td.set_motion_ctx(&mctx);
    }
    CdfContext saved_cdf = *frame_cdf;  // frame-end context
    const int n_tiles = (int)st->tiles.size();
    if (h->threads > 1 && n_tiles > 1) {
      // Tile-parallel entropy decode [SPEC §5.11 tiles are
      // entropy-independent; SURVEY §2.4 row "tile parallelism"]:
      // one TileDecoder + CDF clone + private FramePlans per tile,
      // merged in tile order afterwards.
      std::vector<FramePlans> tile_plans(n_tiles);
      std::vector<CdfContext> tile_cdfs(n_tiles);
      std::vector<int> rcs(n_tiles, 0);
      std::vector<std::thread> pool;
      std::atomic<int> cursor{0};
      int nw = h->threads < n_tiles ? h->threads : n_tiles;
      for (int wkr = 0; wkr < nw; wkr++) {
        pool.emplace_back([&, wkr]() {
          for (;;) {
            int ti = cursor.fetch_add(1);
            if (ti >= n_tiles) break;
            const TileGroupRange& tr = st->tiles[ti];
            const TileInfo& ti_info = st->hdr.tiles;
            tile_plans[ti].init(
                ti_info.mi_row_starts[tr.tile_row + 1] -
                    ti_info.mi_row_starts[tr.tile_row],
                ti_info.mi_col_starts[tr.tile_col + 1] -
                    ti_info.mi_col_starts[tr.tile_col],
                ti_info.mi_row_starts[tr.tile_row],
                ti_info.mi_col_starts[tr.tile_col]);
            tile_cdfs[ti] = *frame_cdf;
            TileDecoder ttd(st->seq, st->hdr, &tile_cdfs[ti],
                            &tile_plans[ti]);
            if (!st->hdr.frame_is_intra) ttd.set_motion_ctx(&mctx);
            rcs[ti] = ttd.decode_tile(tr.data, tr.size, tr.tile_row,
                                      tr.tile_col);
          }
        });
      }
      for (auto& t : pool) t.join();
      for (int ti = 0; ti < n_tiles; ti++) {
        if (rcs[ti] < 0) {
          h->last_error = "tile decode failed";
          return -1;
        }
        const TileGroupRange& tr = st->tiles[ti];
        const TileInfo& tinfo = st->hdr.tiles;
        merge_tile_plans(plans.get(), tile_plans[ti],
                         tinfo.mi_row_starts[tr.tile_row],
                         tinfo.mi_row_starts[tr.tile_row + 1],
                         tinfo.mi_col_starts[tr.tile_col],
                         tinfo.mi_col_starts[tr.tile_col + 1]);
        if (ti == tinfo.context_update_tile_id) saved_cdf = tile_cdfs[ti];
      }
    } else {
      CdfContext tile_cdf;
      int tile_idx = 0;
      for (const TileGroupRange& tr : st->tiles) {
        tile_cdf = *frame_cdf;
        td.set_cdf(&tile_cdf);
        if (td.decode_tile(tr.data, tr.size, tr.tile_row, tr.tile_col) < 0) {
          h->last_error = "tile decode failed";
          return -1;
        }
        if (tile_idx == st->hdr.tiles.context_update_tile_id)
          saved_cdf = tile_cdf;
        tile_idx++;
      }
    }
    if (!st->hdr.disable_frame_end_update_cdf) {
      *frame_cdf = saved_cdf;
      reset_cdf_counters(frame_cdf.get());
    }
    // stash for reference update below
    st->pending_cdfs = frame_cdf;
    store_frame_motion(st, *plans);  // [SPEC §7.19-7.20]
  }
  h->frame_plans.push_back(plans);

  if (!st->hdr.show_existing_frame) reference_frame_update(st);
  return 0;
}


// ---------------------------------------------------------------------------
// Decoder-state checkpoint [SPEC §7.20 state; SURVEY §5.4 mid-GOP resume]
//
// Serializes the complete header-level reference state — sequence
// header, per-slot saved params/CDF contexts/segment maps/motion
// fields — so a decode can resume at ANY temporal-unit boundary, not
// just keyframes.  The pixel-level DPB (plane arrays) is serialized by
// the Python layer; together they are the full decode state.  Blobs
// embed the struct sizes and reject mismatched builds.

struct Ser {
  uint8_t* buf;       // null = measuring
  int64_t cap = 0, off = 0;
  bool ok = true;
  void put(const void* d, int64_t n) {
    if (buf) {
      if (off + n > cap) { ok = false; return; }
      memcpy(buf + off, d, (size_t)n);
    }
    off += n;
  }
  template <typename T> void put_pod(const T& v) { put(&v, sizeof(T)); }
  template <typename V>
  void put_vec(const std::shared_ptr<V>& v) {
    int64_t n = v ? (int64_t)v->size() : -1;
    put_pod(n);
    if (n > 0) put(v->data(), n * (int64_t)sizeof(typename V::value_type));
  }
};

struct Des {
  const uint8_t* buf;
  int64_t size, off = 0;
  bool ok = true;
  void get(void* d, int64_t n) {
    if (off + n > size) { ok = false; return; }
    memcpy(d, buf + off, (size_t)n);
    off += n;
  }
  template <typename T> void get_pod(T* v) { get(v, sizeof(T)); }
  // a vector's length is checked against the bytes left before
  // anything is allocated (-1 is put_vec's null vector)
  template <typename V>
  void get_vec(std::shared_ptr<V>* v) {
    const int64_t elem = (int64_t)sizeof(typename V::value_type);
    int64_t n = 0;
    get_pod(&n);
    v->reset();
    if (!ok || n == -1) return;
    if (n < 0 || n > (size - off) / elem) {
      ok = false;
      return;
    }
    *v = std::make_shared<V>((size_t)n);
    get((*v)->data(), n * elem);
  }
};

const uint64_t kStateMagic = 0x41563153544154ULL;  // "AV1STAT"
const uint32_t kStateVersion = 1;

void state_serialize(const DecoderState& st, Ser& s) {
  s.put_pod(kStateMagic);
  s.put_pod(kStateVersion);
  uint32_t sizes[3] = {(uint32_t)sizeof(SequenceHeader),
                       (uint32_t)sizeof(FrameHeader),
                       (uint32_t)sizeof(CdfContext)};
  s.put(sizes, sizeof(sizes));
  s.put_pod(st.seq);
  s.put_pod(st.hdr);
  s.put_pod(st.metadata);
  int32_t misc[4] = {st.temporal_id, st.spatial_id, st.operating_point_idc,
                     st.chosen_operating_point};
  s.put(misc, sizeof(misc));
  for (int i = 0; i < NUM_REF_FRAMES; i++) {
    const RefSlot& r = st.ref[i];
    int32_t head[16] = {r.valid, r.frame_type, r.frame_id, r.order_hint,
                        r.upscaled_width, r.frame_width, r.frame_height,
                        r.render_width, r.render_height, r.mi_cols,
                        r.mi_rows, r.bit_depth, r.subsampling_x,
                        r.subsampling_y, r.showable_frame, 0};
    s.put(head, sizeof(head));
    s.put(r.ref_order_hints, sizeof(r.ref_order_hints));
    s.put_pod(r.saved_gm);
    s.put_pod(r.saved_lf);
    s.put_pod(r.saved_seg);
    s.put_pod(r.saved_grain);
    uint8_t has_cdfs = r.saved_cdfs ? 1 : 0;
    s.put_pod(has_cdfs);
    if (has_cdfs) s.put(r.saved_cdfs.get(), sizeof(CdfContext));
    s.put_vec(r.saved_seg_ids);
    s.put_vec(r.saved_mvs);
    s.put_vec(r.saved_mv_ref);
  }
}

int state_deserialize(DecoderState* st, Des& d) {
  uint64_t magic; uint32_t ver;
  d.get_pod(&magic);
  d.get_pod(&ver);
  uint32_t sizes[3];
  d.get(sizes, sizeof(sizes));
  if (!d.ok || magic != kStateMagic || ver != kStateVersion ||
      sizes[0] != sizeof(SequenceHeader) ||
      sizes[1] != sizeof(FrameHeader) || sizes[2] != sizeof(CdfContext))
    return -1;
  d.get_pod(&st->seq);
  d.get_pod(&st->hdr);
  d.get_pod(&st->metadata);
  int32_t misc[4];
  d.get(misc, sizeof(misc));
  st->temporal_id = misc[0];
  st->spatial_id = misc[1];
  st->operating_point_idc = misc[2];
  st->chosen_operating_point = misc[3];
  for (int i = 0; i < NUM_REF_FRAMES; i++) {
    RefSlot& r = st->ref[i];
    int32_t head[16];
    d.get(head, sizeof(head));
    r.valid = head[0]; r.frame_type = head[1]; r.frame_id = head[2];
    r.order_hint = head[3]; r.upscaled_width = head[4];
    r.frame_width = head[5]; r.frame_height = head[6];
    r.render_width = head[7]; r.render_height = head[8];
    r.mi_cols = head[9]; r.mi_rows = head[10]; r.bit_depth = head[11];
    r.subsampling_x = head[12]; r.subsampling_y = head[13];
    r.showable_frame = head[14];
    d.get(r.ref_order_hints, sizeof(r.ref_order_hints));
    d.get_pod(&r.saved_gm);
    d.get_pod(&r.saved_lf);
    d.get_pod(&r.saved_seg);
    d.get_pod(&r.saved_grain);
    uint8_t has_cdfs = 0; d.get_pod(&has_cdfs);
    if (d.ok && has_cdfs) {
      r.saved_cdfs = std::make_shared<CdfContext>();
      d.get(r.saved_cdfs.get(), sizeof(CdfContext));
    } else {
      r.saved_cdfs.reset();
    }
    d.get_vec(&r.saved_seg_ids);
    d.get_vec(&r.saved_mvs);
    d.get_vec(&r.saved_mv_ref);
  }
  st->seen_frame_header = 0;
  st->tiles.clear();
  st->tile_group_end = -1;
  return d.ok ? 0 : -1;
}

}  // namespace

extern "C" {


// Wavefront ASAP level assignment [SURVEY §7.1]: the per-block
// dependency DP of pipeline/wavefront._level_for, moved to native code
// (the Python loop dominated the host-side schedule-build cost).
// g4 grids: one per plane group (luma; chroma shared dims).  For each
// block in tx-record order: level = 1 + max(above-row window, left-col
// window, CfL co-located luma), then stamp the block's cells.
// `skip_dep` (optional, may be null): records whose prediction does not
// read reconstructed neighbors (inter blocks: MC runs before the scan)
// — they take level 1 unconditionally and stamp their cells with 1.
int av1n_wavefront_levels(int n, const int32_t* plane, const int32_t* x4,
                          const int32_t* y4, const int32_t* w4,
                          const int32_t* h4, const uint8_t* ext_above,
                          const uint8_t* ext_left, const uint8_t* cfl_dep,
                          int mi_rows, int mi_cols, int sub_x, int sub_y,
                          int num_planes, int32_t* out_levels,
                          const uint8_t* skip_dep) {
  int rows_c = ((mi_rows * 4 >> sub_y) + 3) / 4;
  int cols_c = ((mi_cols * 4 >> sub_x) + 3) / 4;
  std::vector<int32_t> g_y((size_t)mi_rows * mi_cols, 0);
  std::vector<int32_t> g_u, g_v;
  if (num_planes > 1) {
    g_u.assign((size_t)rows_c * cols_c, 0);
    g_v.assign((size_t)rows_c * cols_c, 0);
  }
  int max_level = 0;
  for (int i = 0; i < n; i++) {
    int pl = plane[i];
    int32_t* G = pl == 0 ? g_y.data() : pl == 1 ? g_u.data() : g_v.data();
    int R = pl == 0 ? mi_rows : rows_c;
    int C = pl == 0 ? mi_cols : cols_c;
    int bx = x4[i], by = y4[i], bw = w4[i], bh = h4[i];
    int dep = 0;
    if (skip_dep && skip_dep[i]) {
      out_levels[i] = 1;
      if (1 > max_level) max_level = 1;
      for (int r = by; r < by + bh && r < R; r++) {
        int32_t* row = G + (size_t)r * C;
        for (int c = bx; c < bx + bw && c < C; c++) row[c] = 1;
      }
      continue;
    }
    if (by > 0) {
      int c0 = bx > 0 ? bx - 1 : 0;
      int c1 = bx + (ext_above[i] ? 2 * bw : bw) + 1;
      if (c1 > C) c1 = C;
      const int32_t* row = G + (size_t)(by - 1) * C;
      for (int c = c0; c < c1; c++)
        if (row[c] > dep) dep = row[c];
    }
    if (bx > 0) {
      int r1 = by + (ext_left[i] ? 2 * bh : bh) + 1;
      if (r1 > R) r1 = R;
      for (int r = by; r < r1; r++) {
        int v = G[(size_t)r * C + bx - 1];
        if (v > dep) dep = v;
      }
    }
    if (cfl_dep[i]) {
      int ly0 = by << sub_y, lx0 = bx << sub_x;
      int ly1 = ly0 + (bh << sub_y);
      int lx1 = lx0 + (bw << sub_x);
      if (ly1 > mi_rows) ly1 = mi_rows;
      if (lx1 > mi_cols) lx1 = mi_cols;
      for (int r = ly0; r < ly1; r++) {
        const int32_t* row = g_y.data() + (size_t)r * mi_cols;
        for (int c = lx0; c < lx1; c++)
          if (row[c] > dep) dep = row[c];
      }
    }
    int L = dep + 1;
    out_levels[i] = L;
    if (L > max_level) max_level = L;
    for (int r = by; r < by + bh && r < R; r++) {
      int32_t* row = G + (size_t)r * C;
      for (int c = bx; c < bx + bw && c < C; c++) row[c] = L;
    }
  }
  return max_level;
}

int64_t av1n_state_size(void* hp) {
  Handle* h = (Handle*)hp;
  Ser s{nullptr};
  state_serialize(h->st, s);
  return s.off;
}

int av1n_state_save(void* hp, uint8_t* buf, int64_t cap) {
  Handle* h = (Handle*)hp;
  Ser s{buf};
  s.cap = cap;
  state_serialize(h->st, s);
  return (s.ok && s.off <= cap) ? 0 : -1;
}

// Restores into a copy of the state and commits it only when the whole
// blob reads: a bad blob leaves the decoder as it was.
int av1n_state_restore(void* hp, const uint8_t* buf, int64_t size) {
  Handle* h = (Handle*)hp;
  if (!buf || size < 0) return -1;
  try {
    auto tmp = std::make_unique<DecoderState>(h->st);
    Des d{buf, size};
    if (state_deserialize(tmp.get(), d) != 0) return -1;
    h->st = std::move(*tmp);
  } catch (const std::exception&) {
    return -1;
  }
  return 0;
}

void* av1n_create() { return new Handle(); }

void av1n_destroy(void* hp) { delete (Handle*)hp; }

// Parse one temporal unit.  Returns number of completed frames, <0 on error.
int av1n_parse_tu(void* hp, const uint8_t* data, size_t size) {
  Handle* h = (Handle*)hp;
  h->frame_jsons.clear();
  h->frame_plans.clear();
  int rc = parse_temporal_unit(&h->st, data, size, on_frame_ready_cb, h);
  if (rc < 0) return rc;
  return (int)h->frame_jsons.size();
}

const char* av1n_seq_json(void* hp) {
  Handle* h = (Handle*)hp;
  static thread_local std::string out;
  out = seq_to_json(h->st.seq);
  return out.c_str();
}

const char* av1n_frame_json(void* hp, int idx) {
  Handle* h = (Handle*)hp;
  if (idx < 0 || idx >= (int)h->frame_jsons.size()) return nullptr;
  return h->frame_jsons[idx].c_str();
}

int av1n_version() { return 1; }

void av1n_set_decode_tiles(void* hp, int v) {
  ((Handle*)hp)->decode_tiles = v;
}

void av1n_set_threads(void* hp, int v) {
  ((Handle*)hp)->threads = v < 1 ? 1 : v;
}

void av1n_set_operating_point(void* hp, int op) {
  ((Handle*)hp)->st.chosen_operating_point = op;
}

const char* av1n_last_error(void* hp) {
  return ((Handle*)hp)->last_error.c_str();
}

// ---- plan tensor export (hot data: raw pointers + sizes) ----

static FramePlans* get_plans(void* hp, int idx) {
  Handle* h = (Handle*)hp;
  if (idx < 0 || idx >= (int)h->frame_plans.size()) return nullptr;
  return h->frame_plans[idx].get();
}

// out[0..8] = mi_rows, mi_cols, n_tx_records, n_coeffs, n_palettes,
//             color_map_size, n_lr_units, n_mi_fields, n_warps
int av1n_plans_shape(void* hp, int idx, int64_t* out) {
  FramePlans* p = get_plans(hp, idx);
  if (!p) return -1;
  out[0] = p->mi_rows;
  out[1] = p->mi_cols;
  out[2] = (int64_t)(p->tx_records.size() / N_TXR_FIELDS);
  out[3] = (int64_t)p->coeffs.size();
  out[4] = (int64_t)p->palettes.size();
  out[5] = (int64_t)p->color_map.size();
  out[6] = (int64_t)p->lr_units.size();
  out[7] = N_MI_FIELDS;
  out[8] = (int64_t)p->warps.size();
  return 0;
}

const int32_t* av1n_plans_warps(void* hp, int idx) {
  FramePlans* p = get_plans(hp, idx);
  return p && !p->warps.empty()
             ? reinterpret_cast<const int32_t*>(p->warps.data())
             : nullptr;
}

const int16_t* av1n_plans_mi(void* hp, int idx) {
  FramePlans* p = get_plans(hp, idx);
  return p ? p->mi.data() : nullptr;
}

const int32_t* av1n_plans_tx(void* hp, int idx) {
  FramePlans* p = get_plans(hp, idx);
  return p ? p->tx_records.data() : nullptr;
}

const int32_t* av1n_plans_coeffs(void* hp, int idx) {
  FramePlans* p = get_plans(hp, idx);
  return p ? p->coeffs.data() : nullptr;
}

const int32_t* av1n_plans_palettes(void* hp, int idx) {
  FramePlans* p = get_plans(hp, idx);
  return p && !p->palettes.empty()
             ? reinterpret_cast<const int32_t*>(p->palettes.data())
             : nullptr;
}

const uint8_t* av1n_plans_color_map(void* hp, int idx) {
  FramePlans* p = get_plans(hp, idx);
  return p && !p->color_map.empty() ? p->color_map.data() : nullptr;
}

const int32_t* av1n_plans_color_map_off(void* hp, int idx) {
  FramePlans* p = get_plans(hp, idx);
  return p && !p->color_map_off.empty() ? p->color_map_off.data() : nullptr;
}

const int32_t* av1n_plans_lr(void* hp, int idx) {
  FramePlans* p = get_plans(hp, idx);
  return p && !p->lr_units.empty()
             ? reinterpret_cast<const int32_t*>(p->lr_units.data())
             : nullptr;
}

}  // extern "C"
