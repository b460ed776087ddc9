// Sequence header [SPEC §5.5], frame header [SPEC §5.9] and the associated
// per-reference bookkeeping [SPEC §7.20/7.21].  Pure header-level parsing:
// no entropy-coded data is touched here.
#include <algorithm>
#include <cstring>

#include "bitreader.h"
#include "decoder.h"

namespace av1 {

// ---------------------------------------------------------------------------
// Sequence header [SPEC §5.5.1]
// ---------------------------------------------------------------------------

static void parse_color_config(BitReader& b, SequenceHeader* s) {
  // [SPEC §5.5.2]
  int high_bitdepth = b.f(1);
  if (s->seq_profile == 2 && high_bitdepth) {
    int twelve_bit = b.f(1);
    s->bit_depth = twelve_bit ? 12 : 10;
  } else {
    s->bit_depth = high_bitdepth ? 10 : 8;
  }
  s->mono_chrome = (s->seq_profile == 1) ? 0 : (int)b.f(1);
  int color_description_present = b.f(1);
  if (color_description_present) {
    s->color_primaries = b.f(8);
    s->transfer_characteristics = b.f(8);
    s->matrix_coefficients = b.f(8);
  } else {
    s->color_primaries = CP_UNSPECIFIED;
    s->transfer_characteristics = TC_UNSPECIFIED;
    s->matrix_coefficients = MC_UNSPECIFIED;
  }
  if (s->mono_chrome) {
    s->color_range = b.f(1);
    s->subsampling_x = s->subsampling_y = 1;
    s->chroma_sample_position = CSP_UNKNOWN;
    s->separate_uv_delta_q = 0;
    return;
  } else if (s->color_primaries == 1 /*CP_BT_709*/ &&
             s->transfer_characteristics == 13 /*TC_SRGB*/ &&
             s->matrix_coefficients == MC_IDENTITY) {
    s->color_range = 1;
    s->subsampling_x = s->subsampling_y = 0;
  } else {
    s->color_range = b.f(1);
    if (s->seq_profile == 0) {
      s->subsampling_x = s->subsampling_y = 1;
    } else if (s->seq_profile == 1) {
      s->subsampling_x = s->subsampling_y = 0;
    } else {
      if (s->bit_depth == 12) {
        s->subsampling_x = b.f(1);
        s->subsampling_y = s->subsampling_x ? (int)b.f(1) : 0;
      } else {
        s->subsampling_x = 1;
        s->subsampling_y = 0;
      }
    }
    if (s->subsampling_x && s->subsampling_y) {
      s->chroma_sample_position = b.f(2);
    }
  }
  s->separate_uv_delta_q = b.f(1);
}

int parse_sequence_header(BitReader& b, SequenceHeader* s) {
  *s = SequenceHeader();
  s->seq_profile = b.f(3);
  s->still_picture = b.f(1);
  s->reduced_still_picture_header = b.f(1);
  if (s->reduced_still_picture_header) {
    s->timing_info_present = 0;
    s->decoder_model_info_present = 0;
    s->initial_display_delay_present = 0;
    s->operating_points_cnt = 1;
    s->op[0].idc = 0;
    s->op[0].seq_level_idx = b.f(5);
    s->op[0].seq_tier = 0;
  } else {
    s->timing_info_present = b.f(1);
    if (s->timing_info_present) {
      // timing_info() [SPEC §5.5.3]
      s->num_units_in_display_tick = b.f(32);
      s->time_scale = b.f(32);
      s->equal_picture_interval = b.f(1);
      if (s->equal_picture_interval) s->num_ticks_per_picture = b.uvlc() + 1;
      s->decoder_model_info_present = b.f(1);
      if (s->decoder_model_info_present) {
        // decoder_model_info() [SPEC §5.5.4]
        s->buffer_delay_length = b.f(5) + 1;
        s->num_units_in_decoding_tick = b.f(32);
        s->buffer_removal_time_length = b.f(5) + 1;
        s->frame_presentation_time_length = b.f(5) + 1;
      }
    } else {
      s->decoder_model_info_present = 0;
    }
    s->initial_display_delay_present = b.f(1);
    s->operating_points_cnt = b.f(5) + 1;
    for (int i = 0; i < s->operating_points_cnt; i++) {
      s->op[i].idc = b.f(12);
      s->op[i].seq_level_idx = b.f(5);
      s->op[i].seq_tier = (s->op[i].seq_level_idx > 7) ? (int)b.f(1) : 0;
      if (s->decoder_model_info_present) {
        s->op[i].decoder_model_present = b.f(1);
        if (s->op[i].decoder_model_present) {
          // operating_parameters_info() [SPEC §5.5.5]
          b.f64(s->buffer_delay_length);  // decoder_buffer_delay
          b.f64(s->buffer_delay_length);  // encoder_buffer_delay
          b.f(1);                         // low_delay_mode_flag
        }
      }
      if (s->initial_display_delay_present) {
        if (b.f(1)) s->op[i].initial_display_delay = b.f(4) + 1;
      }
    }
  }
  s->frame_width_bits = b.f(4) + 1;
  s->frame_height_bits = b.f(4) + 1;
  s->max_frame_width = b.f(s->frame_width_bits) + 1;
  s->max_frame_height = b.f(s->frame_height_bits) + 1;
  s->frame_id_numbers_present =
      s->reduced_still_picture_header ? 0 : (int)b.f(1);
  if (s->frame_id_numbers_present) {
    s->delta_frame_id_length = b.f(4) + 2;
    s->additional_frame_id_length = b.f(3) + 1;
  }
  s->use_128x128_superblock = b.f(1);
  s->enable_filter_intra = b.f(1);
  s->enable_intra_edge_filter = b.f(1);
  if (s->reduced_still_picture_header) {
    s->enable_interintra_compound = 0;
    s->enable_masked_compound = 0;
    s->enable_warped_motion = 0;
    s->enable_dual_filter = 0;
    s->enable_order_hint = 0;
    s->enable_jnt_comp = 0;
    s->enable_ref_frame_mvs = 0;
    s->seq_force_screen_content_tools = SELECT_SCREEN_CONTENT_TOOLS;
    s->seq_force_integer_mv = SELECT_INTEGER_MV;
    s->order_hint_bits = 0;
  } else {
    s->enable_interintra_compound = b.f(1);
    s->enable_masked_compound = b.f(1);
    s->enable_warped_motion = b.f(1);
    s->enable_dual_filter = b.f(1);
    s->enable_order_hint = b.f(1);
    if (s->enable_order_hint) {
      s->enable_jnt_comp = b.f(1);
      s->enable_ref_frame_mvs = b.f(1);
    } else {
      s->enable_jnt_comp = 0;
      s->enable_ref_frame_mvs = 0;
    }
    int seq_choose_screen_content_tools = b.f(1);
    s->seq_force_screen_content_tools =
        seq_choose_screen_content_tools ? SELECT_SCREEN_CONTENT_TOOLS
                                        : (int)b.f(1);
    if (s->seq_force_screen_content_tools > 0) {
      int seq_choose_integer_mv = b.f(1);
      s->seq_force_integer_mv =
          seq_choose_integer_mv ? SELECT_INTEGER_MV : (int)b.f(1);
    } else {
      s->seq_force_integer_mv = SELECT_INTEGER_MV;
    }
    s->order_hint_bits = s->enable_order_hint ? (int)b.f(3) + 1 : 0;
  }
  s->enable_superres = b.f(1);
  s->enable_cdef = b.f(1);
  s->enable_restoration = b.f(1);
  parse_color_config(b, s);
  s->film_grain_params_present = b.f(1);
  s->valid = 1;
  return b.overrun() ? -1 : 0;
}

// ---------------------------------------------------------------------------
// Frame size [SPEC §5.9.5-5.9.8]
// ---------------------------------------------------------------------------

static void compute_image_size(FrameHeader* h) {
  // [SPEC §5.9.9]
  h->mi_cols = 2 * ((h->frame_width + 7) >> 3);
  h->mi_rows = 2 * ((h->frame_height + 7) >> 3);
}

static void superres_params(BitReader& b, const SequenceHeader& s,
                            FrameHeader* h) {
  // [SPEC §5.9.8]
  h->use_superres = s.enable_superres ? (int)b.f(1) : 0;
  h->superres_denom = h->use_superres
                          ? (int)b.f(SUPERRES_DENOM_BITS) + SUPERRES_DENOM_MIN
                          : SUPERRES_NUM;
  h->upscaled_width = h->frame_width;
  h->frame_width =
      (h->upscaled_width * SUPERRES_NUM + (h->superres_denom / 2)) /
      h->superres_denom;
}

static void frame_size(BitReader& b, const SequenceHeader& s, FrameHeader* h) {
  // [SPEC §5.9.5]
  if (h->frame_size_override) {
    h->frame_width = b.f(s.frame_width_bits) + 1;
    h->frame_height = b.f(s.frame_height_bits) + 1;
  } else {
    h->frame_width = s.max_frame_width;
    h->frame_height = s.max_frame_height;
  }
  superres_params(b, s, h);
  compute_image_size(h);
}

static void render_size(BitReader& b, FrameHeader* h) {
  // [SPEC §5.9.6]
  if (b.f(1)) {
    h->render_width = b.f(16) + 1;
    h->render_height = b.f(16) + 1;
  } else {
    h->render_width = h->upscaled_width;
    h->render_height = h->frame_height;
  }
}

static void frame_size_with_refs(BitReader& b, DecoderState* st) {
  // [SPEC §5.9.7]
  FrameHeader* h = &st->hdr;
  int found_ref = 0;
  for (int i = 0; i < REFS_PER_FRAME; i++) {
    found_ref = b.f(1);
    if (found_ref) {
      const RefSlot& r = st->ref[h->ref_frame_idx[i]];
      h->upscaled_width = r.upscaled_width;
      h->frame_width = h->upscaled_width;
      h->frame_height = r.frame_height;
      h->render_width = r.render_width;
      h->render_height = r.render_height;
      break;
    }
  }
  if (!found_ref) {
    frame_size(b, st->seq, h);
    render_size(b, h);
  } else {
    superres_params(b, st->seq, h);
    compute_image_size(h);
  }
}

// ---------------------------------------------------------------------------
// Tile info [SPEC §5.9.15]
// ---------------------------------------------------------------------------

static void tile_info(BitReader& b, const SequenceHeader& s, FrameHeader* h) {
  TileInfo* t = &h->tiles;
  *t = TileInfo();
  int sbShift = s.use_128x128_superblock ? 5 : 4;
  int sbCols = s.use_128x128_superblock ? ((h->mi_cols + 31) >> 5)
                                        : ((h->mi_cols + 15) >> 4);
  int sbRows = s.use_128x128_superblock ? ((h->mi_rows + 31) >> 5)
                                        : ((h->mi_rows + 15) >> 4);
  int sbSize = sbShift + 2;
  int maxTileWidthSb = MAX_TILE_WIDTH >> sbSize;
  int maxTileAreaSb = MAX_TILE_AREA >> (2 * sbSize);
  int minLog2TileCols = tile_log2(maxTileWidthSb, sbCols);
  int maxLog2TileCols = tile_log2(1, std::min(sbCols, MAX_TILE_COLS));
  int maxLog2TileRows = tile_log2(1, std::min(sbRows, MAX_TILE_ROWS));
  int minLog2Tiles =
      std::max(minLog2TileCols,
               tile_log2(maxTileAreaSb, std::max(sbRows * sbCols, 1)));

  t->uniform_tile_spacing = b.f(1);
  if (t->uniform_tile_spacing) {
    t->tile_cols_log2 = minLog2TileCols;
    while (t->tile_cols_log2 < maxLog2TileCols) {
      if (b.f(1))
        t->tile_cols_log2++;
      else
        break;
    }
    int tileWidthSb = (sbCols + (1 << t->tile_cols_log2) - 1) >>
                      t->tile_cols_log2;
    int i = 0;
    for (int startSb = 0; startSb < sbCols; startSb += tileWidthSb) {
      t->mi_col_starts[i] = startSb << sbShift;
      i++;
    }
    t->mi_col_starts[i] = h->mi_cols;
    t->tile_cols = i;

    int minLog2TileRows = std::max(minLog2Tiles - t->tile_cols_log2, 0);
    t->tile_rows_log2 = minLog2TileRows;
    while (t->tile_rows_log2 < maxLog2TileRows) {
      if (b.f(1))
        t->tile_rows_log2++;
      else
        break;
    }
    int tileHeightSb = (sbRows + (1 << t->tile_rows_log2) - 1) >>
                       t->tile_rows_log2;
    i = 0;
    for (int startSb = 0; startSb < sbRows; startSb += tileHeightSb) {
      t->mi_row_starts[i] = startSb << sbShift;
      i++;
    }
    t->mi_row_starts[i] = h->mi_rows;
    t->tile_rows = i;
  } else {
    int widestTileSb = 0;
    int startSb = 0;
    int i = 0;
    for (; startSb < sbCols; i++) {
      t->mi_col_starts[i] = startSb << sbShift;
      int maxWidth = std::min(sbCols - startSb, maxTileWidthSb);
      int sizeSb = b.ns(maxWidth) + 1;
      widestTileSb = std::max(sizeSb, widestTileSb);
      startSb += sizeSb;
    }
    t->mi_col_starts[i] = h->mi_cols;
    t->tile_cols = i;
    t->tile_cols_log2 = tile_log2(1, t->tile_cols);

    if (minLog2Tiles > 0)
      maxTileAreaSb = (sbRows * sbCols) >> (minLog2Tiles + 1);
    else
      maxTileAreaSb = sbRows * sbCols;
    int maxTileHeightSb = std::max(maxTileAreaSb / std::max(widestTileSb, 1), 1);

    startSb = 0;
    i = 0;
    for (; startSb < sbRows; i++) {
      t->mi_row_starts[i] = startSb << sbShift;
      int maxHeight = std::min(sbRows - startSb, maxTileHeightSb);
      int sizeSb = b.ns(maxHeight) + 1;
      startSb += sizeSb;
    }
    t->mi_row_starts[i] = h->mi_rows;
    t->tile_rows = i;
    t->tile_rows_log2 = tile_log2(1, t->tile_rows);
  }
  if (t->tile_cols_log2 > 0 || t->tile_rows_log2 > 0) {
    t->context_update_tile_id = b.f(t->tile_rows_log2 + t->tile_cols_log2);
    t->tile_size_bytes = b.f(2) + 1;
  } else {
    t->context_update_tile_id = 0;
  }
}

// ---------------------------------------------------------------------------
// Quantization / segmentation / deltas [SPEC §5.9.12-5.9.14, §5.9.17-18]
// ---------------------------------------------------------------------------

static void quantization_params(BitReader& b, const SequenceHeader& s,
                                FrameHeader* h) {
  QuantizationParams* q = &h->quant;
  q->base_q_idx = b.f(8);
  q->delta_q_y_dc = b.delta_q();
  if (s.num_planes() > 1) {
    int diff_uv_delta = s.separate_uv_delta_q ? (int)b.f(1) : 0;
    q->delta_q_u_dc = b.delta_q();
    q->delta_q_u_ac = b.delta_q();
    if (diff_uv_delta) {
      q->delta_q_v_dc = b.delta_q();
      q->delta_q_v_ac = b.delta_q();
    } else {
      q->delta_q_v_dc = q->delta_q_u_dc;
      q->delta_q_v_ac = q->delta_q_u_ac;
    }
  } else {
    q->delta_q_u_dc = q->delta_q_u_ac = 0;
    q->delta_q_v_dc = q->delta_q_v_ac = 0;
  }
  q->using_qmatrix = b.f(1);
  if (q->using_qmatrix) {
    q->qm_y = b.f(4);
    q->qm_u = b.f(4);
    q->qm_v = s.separate_uv_delta_q ? (int)b.f(4) : q->qm_u;
  }
}

// [SPEC §5.9.14 tables]
static const int kSegFeatureBits[SEG_LVL_MAX] = {8, 6, 6, 6, 6, 3, 0, 0};
static const int kSegFeatureSigned[SEG_LVL_MAX] = {1, 1, 1, 1, 1, 0, 0, 0};
static const int kSegFeatureMax[SEG_LVL_MAX] = {
    255, MAX_LOOP_FILTER, MAX_LOOP_FILTER, MAX_LOOP_FILTER, MAX_LOOP_FILTER,
    7,   0,               0};
constexpr int SEG_LVL_REF_FRAME = 5;

static void segmentation_params(BitReader& b, DecoderState* st) {
  FrameHeader* h = &st->hdr;
  SegmentationParams* g = &h->seg;
  g->enabled = b.f(1);
  if (g->enabled) {
    if (h->primary_ref_frame == PRIMARY_REF_NONE) {
      g->update_map = 1;
      g->temporal_update = 0;
      g->update_data = 1;
    } else {
      g->update_map = b.f(1);
      g->temporal_update = g->update_map ? (int)b.f(1) : 0;
      g->update_data = b.f(1);
    }
    if (g->update_data) {
      for (int i = 0; i < MAX_SEGMENTS; i++) {
        for (int j = 0; j < SEG_LVL_MAX; j++) {
          int feature_value = 0;
          int enabled = b.f(1);
          g->feature_enabled[i][j] = enabled;
          int clippedValue = 0;
          if (enabled) {
            int bitsToRead = kSegFeatureBits[j];
            int limit = kSegFeatureMax[j];
            if (kSegFeatureSigned[j]) {
              feature_value = b.su(bitsToRead);
              clippedValue = std::clamp(feature_value, -limit, limit);
            } else {
              feature_value = b.f(bitsToRead);
              clippedValue = std::clamp(feature_value, 0, limit);
            }
          }
          g->feature_data[i][j] = clippedValue;
        }
      }
    }
  } else {
    // [SPEC §5.9.13] disabled => clear everything
    std::memset(g->feature_enabled, 0, sizeof(g->feature_enabled));
    std::memset(g->feature_data, 0, sizeof(g->feature_data));
    g->update_map = 0;
    g->temporal_update = 0;
    g->update_data = 0;
  }
  g->seg_id_pre_skip = 0;
  g->last_active_seg_id = 0;
  for (int i = 0; i < MAX_SEGMENTS; i++) {
    for (int j = 0; j < SEG_LVL_MAX; j++) {
      if (g->feature_enabled[i][j]) {
        g->last_active_seg_id = i;
        if (j >= SEG_LVL_REF_FRAME) g->seg_id_pre_skip = 1;
      }
    }
  }
}

static void delta_q_params(BitReader& b, FrameHeader* h) {
  h->delta_q_res = 0;
  h->delta_q_present = 0;
  if (h->quant.base_q_idx > 0) h->delta_q_present = b.f(1);
  if (h->delta_q_present) h->delta_q_res = b.f(2);
}

static void delta_lf_params(BitReader& b, FrameHeader* h) {
  h->delta_lf_present = 0;
  h->delta_lf_res = 0;
  h->delta_lf_multi = 0;
  if (h->delta_q_present) {
    if (!h->allow_intrabc) h->delta_lf_present = b.f(1);
    if (h->delta_lf_present) {
      h->delta_lf_res = b.f(2);
      h->delta_lf_multi = b.f(1);
    }
  }
}

// ---------------------------------------------------------------------------
// Loop filter / CDEF / LR [SPEC §5.9.11, §5.9.19, §5.9.20]
// ---------------------------------------------------------------------------

static void loop_filter_params(BitReader& b, const SequenceHeader& s,
                               FrameHeader* h) {
  LoopFilterParams* lf = &h->lf;
  if (h->coded_lossless || h->allow_intrabc) {
    lf->level[0] = lf->level[1] = lf->level[2] = lf->level[3] = 0;
    lf->ref_deltas[INTRA_FRAME] = 1;
    lf->ref_deltas[LAST_FRAME] = 0;
    lf->ref_deltas[LAST2_FRAME] = 0;
    lf->ref_deltas[LAST3_FRAME] = 0;
    lf->ref_deltas[BWDREF_FRAME] = 0;
    lf->ref_deltas[GOLDEN_FRAME] = -1;
    lf->ref_deltas[ALTREF_FRAME] = -1;
    lf->ref_deltas[ALTREF2_FRAME] = -1;
    lf->mode_deltas[0] = lf->mode_deltas[1] = 0;
    return;
  }
  lf->level[0] = b.f(6);
  lf->level[1] = b.f(6);
  if (s.num_planes() > 1) {
    if (lf->level[0] || lf->level[1]) {
      lf->level[2] = b.f(6);
      lf->level[3] = b.f(6);
    }
  }
  lf->sharpness = b.f(3);
  lf->delta_enabled = b.f(1);
  if (lf->delta_enabled) {
    lf->delta_update = b.f(1);
    if (lf->delta_update) {
      for (int i = 0; i < TOTAL_REFS_PER_FRAME; i++) {
        if (b.f(1)) lf->ref_deltas[i] = b.su(6);
      }
      for (int i = 0; i < 2; i++) {
        if (b.f(1)) lf->mode_deltas[i] = b.su(6);
      }
    }
  }
}

static void cdef_params(BitReader& b, const SequenceHeader& s,
                        FrameHeader* h) {
  CdefParams* c = &h->cdef;
  if (h->coded_lossless || h->allow_intrabc || !s.enable_cdef) {
    c->bits = 0;
    c->y_pri[0] = 0;
    c->y_sec[0] = 0;
    c->uv_pri[0] = 0;
    c->uv_sec[0] = 0;
    c->damping = 3;
    return;
  }
  c->damping = b.f(2) + 3;
  c->bits = b.f(2);
  for (int i = 0; i < (1 << c->bits); i++) {
    c->y_pri[i] = b.f(4);
    c->y_sec[i] = b.f(2);
    if (c->y_sec[i] == 3) c->y_sec[i] += 1;
    if (s.num_planes() > 1) {
      c->uv_pri[i] = b.f(4);
      c->uv_sec[i] = b.f(2);
      if (c->uv_sec[i] == 3) c->uv_sec[i] += 1;
    }
  }
}

static void lr_params(BitReader& b, const SequenceHeader& s, FrameHeader* h) {
  LrParams* lr = &h->lr;
  if (h->all_lossless || h->allow_intrabc || !s.enable_restoration) {
    lr->frame_restoration_type[0] = RESTORE_NONE;
    lr->frame_restoration_type[1] = RESTORE_NONE;
    lr->frame_restoration_type[2] = RESTORE_NONE;
    lr->uses_lr = 0;
    return;
  }
  // Remap_Lr_Type [SPEC §5.9.20]
  static const int remap[4] = {RESTORE_NONE, RESTORE_SWITCHABLE,
                               RESTORE_WIENER, RESTORE_SGRPROJ};
  lr->uses_lr = 0;
  int usesChromaLr = 0;
  for (int i = 0; i < s.num_planes(); i++) {
    int lr_type = b.f(2);
    lr->frame_restoration_type[i] = remap[lr_type];
    if (lr->frame_restoration_type[i] != RESTORE_NONE) {
      lr->uses_lr = 1;
      if (i > 0) usesChromaLr = 1;
    }
  }
  if (lr->uses_lr) {
    int lr_unit_shift;
    if (s.use_128x128_superblock) {
      lr_unit_shift = b.f(1) + 1;
    } else {
      lr_unit_shift = b.f(1);
      if (lr_unit_shift) lr_unit_shift += b.f(1);
    }
    lr->loop_restoration_size[0] = 256 >> (2 - lr_unit_shift);
    int lr_uv_shift = 0;
    if (s.subsampling_x && s.subsampling_y && usesChromaLr) {
      lr_uv_shift = b.f(1);
    }
    lr->loop_restoration_size[1] = lr->loop_restoration_size[0] >> lr_uv_shift;
    lr->loop_restoration_size[2] = lr->loop_restoration_size[0] >> lr_uv_shift;
  }
}

// ---------------------------------------------------------------------------
// Global motion [SPEC §5.9.24-5.9.26]
// ---------------------------------------------------------------------------

static int inverse_recenter(int r, int v) {
  // [SPEC §5.9.27]
  if (v > 2 * r)
    return v;
  else if (v & 1)
    return r + ((v + 1) >> 1);
  else
    return r - (v >> 1);
}

static int decode_subexp(BitReader& b, int numSyms) {
  // [SPEC §5.9.26]
  int i = 0;
  int mk = 0;
  int k = 3;
  while (1) {
    int b2 = i ? k + i - 1 : k;
    int a = 1 << b2;
    if (numSyms <= mk + 3 * a) {
      return (int)b.ns(numSyms - mk) + mk;
    } else {
      if (b.f(1)) {
        i++;
        mk += a;
      } else {
        return (int)b.f(b2) + mk;
      }
    }
  }
}

static int decode_unsigned_subexp_with_ref(BitReader& b, int mx, int r) {
  // [SPEC §5.9.25]
  int v = decode_subexp(b, mx);
  if ((r << 1) <= mx) {
    return inverse_recenter(r, v);
  } else {
    return mx - 1 - inverse_recenter(mx - 1 - r, v);
  }
}

static int decode_signed_subexp_with_ref(BitReader& b, int low, int high,
                                         int r) {
  int x = decode_unsigned_subexp_with_ref(b, high - low, r - low);
  return x + low;
}

static void read_global_param(BitReader& b, FrameHeader* h,
                              const GlobalMotionParams& prev, int type,
                              int ref, int idx) {
  // [SPEC §5.9.24 read_global_param]
  int absBits = GM_ABS_ALPHA_BITS;
  int precBits = GM_ALPHA_PREC_BITS;
  if (idx < 2) {
    if (type == TRANSLATION) {
      absBits = GM_ABS_TRANS_ONLY_BITS - !h->allow_high_precision_mv;
      precBits = GM_TRANS_ONLY_PREC_BITS - !h->allow_high_precision_mv;
    } else {
      absBits = GM_ABS_TRANS_BITS;
      precBits = GM_TRANS_PREC_BITS;
    }
  }
  int precDiff = WARPEDMODEL_PREC_BITS - precBits;
  int round = (idx % 3) == 2 ? (1 << WARPEDMODEL_PREC_BITS) : 0;
  int sub = (idx % 3) == 2 ? (1 << precBits) : 0;
  int mx = 1 << absBits;
  int r = (prev.gm_params[ref][idx] >> precDiff) - sub;
  h->gm.gm_params[ref][idx] =
      (decode_signed_subexp_with_ref(b, -mx, mx + 1, r) << precDiff) + round;
}

static void default_gm(GlobalMotionParams* gm) {
  for (int ref = 0; ref < NUM_REF_FRAMES; ref++) {
    gm->gm_type[ref] = IDENTITY;
    gm->gm_invalid[ref] = 0;
    int32_t* p = gm->gm_params[ref];
    p[0] = 0;
    p[1] = 0;
    p[2] = 1 << WARPEDMODEL_PREC_BITS;
    p[3] = 0;
    p[4] = 0;
    p[5] = 1 << WARPEDMODEL_PREC_BITS;
  }
}

static void global_motion_params(BitReader& b, DecoderState* st,
                                 const GlobalMotionParams& prev) {
  FrameHeader* h = &st->hdr;
  default_gm(&h->gm);
  if (h->frame_is_intra) return;
  for (int ref = LAST_FRAME; ref <= ALTREF_FRAME; ref++) {
    int type = IDENTITY;
    if (b.f(1)) {  // is_global
      if (b.f(1)) {  // is_rot_zoom
        type = ROTZOOM;
      } else {
        type = b.f(1) ? TRANSLATION : AFFINE;
      }
    }
    h->gm.gm_type[ref] = type;
    if (type >= ROTZOOM) {
      read_global_param(b, h, prev, type, ref, 2);
      read_global_param(b, h, prev, type, ref, 3);
      if (type == AFFINE) {
        read_global_param(b, h, prev, type, ref, 4);
        read_global_param(b, h, prev, type, ref, 5);
      } else {
        h->gm.gm_params[ref][4] = -h->gm.gm_params[ref][3];
        h->gm.gm_params[ref][5] = h->gm.gm_params[ref][2];
      }
    }
    if (type >= TRANSLATION) {
      read_global_param(b, h, prev, type, ref, 0);
      read_global_param(b, h, prev, type, ref, 1);
    }
  }
}

// ---------------------------------------------------------------------------
// Film grain [SPEC §5.9.30]
// ---------------------------------------------------------------------------

static void film_grain_params(BitReader& b, DecoderState* st) {
  const SequenceHeader& s = st->seq;
  FrameHeader* h = &st->hdr;
  FilmGrainParams* fg = &h->grain;
  *fg = FilmGrainParams();
  if (!s.film_grain_params_present ||
      (!h->show_frame && !h->showable_frame)) {
    return;  // reset_grain_params()
  }
  fg->apply_grain = b.f(1);
  if (!fg->apply_grain) {
    *fg = FilmGrainParams();
    return;
  }
  fg->grain_seed = b.f(16);
  fg->update_grain = (h->frame_type == INTER_FRAME) ? (int)b.f(1) : 1;
  if (!fg->update_grain) {
    fg->film_grain_params_ref_idx = b.f(3);
    // load_grain_params: copy everything except grain_seed [SPEC §5.9.30]
    int seed = fg->grain_seed;
    int apply = fg->apply_grain;
    *fg = st->ref[fg->film_grain_params_ref_idx].saved_grain;
    fg->grain_seed = seed;
    fg->apply_grain = apply;
    fg->update_grain = 0;
    return;
  }
  fg->num_y_points = b.f(4);
  for (int i = 0; i < fg->num_y_points; i++) {
    fg->point_y_value[i] = b.f(8);
    fg->point_y_scaling[i] = b.f(8);
  }
  fg->chroma_scaling_from_luma = s.mono_chrome ? 0 : (int)b.f(1);
  if (s.mono_chrome || fg->chroma_scaling_from_luma ||
      (s.subsampling_x == 1 && s.subsampling_y == 1 &&
       fg->num_y_points == 0)) {
    fg->num_cb_points = 0;
    fg->num_cr_points = 0;
  } else {
    fg->num_cb_points = b.f(4);
    for (int i = 0; i < fg->num_cb_points; i++) {
      fg->point_cb_value[i] = b.f(8);
      fg->point_cb_scaling[i] = b.f(8);
    }
    fg->num_cr_points = b.f(4);
    for (int i = 0; i < fg->num_cr_points; i++) {
      fg->point_cr_value[i] = b.f(8);
      fg->point_cr_scaling[i] = b.f(8);
    }
  }
  fg->grain_scaling = b.f(2) + 8;
  fg->ar_coeff_lag = b.f(2);
  int numPosLuma = 2 * fg->ar_coeff_lag * (fg->ar_coeff_lag + 1);
  int numPosChroma = numPosLuma;
  if (fg->num_y_points) {
    numPosChroma = numPosLuma + 1;
    for (int i = 0; i < numPosLuma; i++)
      fg->ar_coeffs_y[i] = (int)b.f(8) - 128;
  }
  if (fg->chroma_scaling_from_luma || fg->num_cb_points) {
    for (int i = 0; i < numPosChroma; i++)
      fg->ar_coeffs_cb[i] = (int)b.f(8) - 128;
  }
  if (fg->chroma_scaling_from_luma || fg->num_cr_points) {
    for (int i = 0; i < numPosChroma; i++)
      fg->ar_coeffs_cr[i] = (int)b.f(8) - 128;
  }
  fg->ar_coeff_shift = b.f(2) + 6;
  fg->grain_scale_shift = b.f(2);
  if (fg->num_cb_points) {
    fg->cb_mult = b.f(8);
    fg->cb_luma_mult = b.f(8);
    fg->cb_offset = b.f(9);
  }
  if (fg->num_cr_points) {
    fg->cr_mult = b.f(8);
    fg->cr_luma_mult = b.f(8);
    fg->cr_offset = b.f(9);
  }
  fg->overlap_flag = b.f(1);
  fg->clip_to_restricted_range = b.f(1);
}

// ---------------------------------------------------------------------------
// setup_past_independence / load_previous [SPEC §7.20/§7.21]
// ---------------------------------------------------------------------------

void setup_past_independence(FrameHeader* h) {
  // [SPEC §6.8.2 / setup_past_independence]: reset FeatureData handled when
  // seg parsed; reset deltas + gm defaults
  for (int i = 0; i < MAX_SEGMENTS; i++)
    for (int j = 0; j < SEG_LVL_MAX; j++) {
      h->seg.feature_data[i][j] = 0;
      h->seg.feature_enabled[i][j] = 0;
    }
  h->lf.ref_deltas[INTRA_FRAME] = 1;
  h->lf.ref_deltas[LAST_FRAME] = 0;
  h->lf.ref_deltas[LAST2_FRAME] = 0;
  h->lf.ref_deltas[LAST3_FRAME] = 0;
  h->lf.ref_deltas[BWDREF_FRAME] = 0;
  h->lf.ref_deltas[GOLDEN_FRAME] = -1;
  h->lf.ref_deltas[ALTREF_FRAME] = -1;
  h->lf.ref_deltas[ALTREF2_FRAME] = -1;
  h->lf.mode_deltas[0] = 0;
  h->lf.mode_deltas[1] = 0;
}

// ---------------------------------------------------------------------------
// set_frame_refs [SPEC §7.8] — short signalling ref selection
// ---------------------------------------------------------------------------

static void set_frame_refs(DecoderState* st, int last_frame_idx,
                           int gold_frame_idx) {
  FrameHeader* h = &st->hdr;
  const SequenceHeader& s = st->seq;
  int usedFrame[NUM_REF_FRAMES] = {};
  for (int i = 0; i < REFS_PER_FRAME; i++) h->ref_frame_idx[i] = -1;
  h->ref_frame_idx[LAST_FRAME - LAST_FRAME] = last_frame_idx;
  h->ref_frame_idx[GOLDEN_FRAME - LAST_FRAME] = gold_frame_idx;
  usedFrame[last_frame_idx] = 1;
  usedFrame[gold_frame_idx] = 1;

  int curFrameHint = 1 << (s.order_hint_bits - 1);
  int shiftedOrderHints[NUM_REF_FRAMES];
  for (int i = 0; i < NUM_REF_FRAMES; i++) {
    shiftedOrderHints[i] =
        curFrameHint +
        st->get_relative_dist(st->ref[i].order_hint, h->order_hint);
  }
  int lastOrderHint = shiftedOrderHints[last_frame_idx];
  int goldOrderHint = shiftedOrderHints[gold_frame_idx];
  (void)lastOrderHint;
  (void)goldOrderHint;

  // find ALTREF (most future)
  auto find_latest_backward = [&]() {
    int ref = -1, latestOrderHint = -1;
    for (int i = 0; i < NUM_REF_FRAMES; i++) {
      int hint = shiftedOrderHints[i];
      if (!usedFrame[i] && hint >= curFrameHint &&
          (ref < 0 || hint >= latestOrderHint)) {
        ref = i;
        latestOrderHint = hint;
      }
    }
    return ref;
  };
  auto find_earliest_backward = [&]() {
    int ref = -1, earliestOrderHint = -1;
    for (int i = 0; i < NUM_REF_FRAMES; i++) {
      int hint = shiftedOrderHints[i];
      if (!usedFrame[i] && hint >= curFrameHint &&
          (ref < 0 || hint < earliestOrderHint)) {
        ref = i;
        earliestOrderHint = hint;
      }
    }
    return ref;
  };
  auto find_latest_forward = [&]() {
    int ref = -1, latestOrderHint = -1;
    for (int i = 0; i < NUM_REF_FRAMES; i++) {
      int hint = shiftedOrderHints[i];
      if (!usedFrame[i] && hint < curFrameHint &&
          (ref < 0 || hint >= latestOrderHint)) {
        ref = i;
        latestOrderHint = hint;
      }
    }
    return ref;
  };

  int ref = find_latest_backward();
  if (ref >= 0) {
    h->ref_frame_idx[ALTREF_FRAME - LAST_FRAME] = ref;
    usedFrame[ref] = 1;
  }
  ref = find_earliest_backward();
  if (ref >= 0) {
    h->ref_frame_idx[BWDREF_FRAME - LAST_FRAME] = ref;
    usedFrame[ref] = 1;
  }
  ref = find_earliest_backward();
  if (ref >= 0) {
    h->ref_frame_idx[ALTREF2_FRAME - LAST_FRAME] = ref;
    usedFrame[ref] = 1;
  }
  // remaining forward refs, closest first: LAST2, LAST3
  static const int Ref_Frame_List[REFS_PER_FRAME - 2] = {
      LAST2_FRAME, LAST3_FRAME, BWDREF_FRAME, ALTREF2_FRAME, ALTREF_FRAME};
  for (int i = 0; i < REFS_PER_FRAME - 2; i++) {
    int refFrame = Ref_Frame_List[i];
    if (h->ref_frame_idx[refFrame - LAST_FRAME] < 0) {
      ref = find_latest_forward();
      if (ref >= 0) {
        h->ref_frame_idx[refFrame - LAST_FRAME] = ref;
        usedFrame[ref] = 1;
      }
    }
  }
  // fill remaining with earliest
  {
    int earliest = -1, earliestOrderHint = -1;
    for (int i = 0; i < NUM_REF_FRAMES; i++) {
      int hint = shiftedOrderHints[i];
      if (earliest < 0 || hint < earliestOrderHint) {
        earliest = i;
        earliestOrderHint = hint;
      }
    }
    for (int i = 0; i < REFS_PER_FRAME; i++) {
      if (h->ref_frame_idx[i] < 0) h->ref_frame_idx[i] = earliest;
    }
  }
}

// ---------------------------------------------------------------------------
// Skip mode [SPEC §5.9.22]
// ---------------------------------------------------------------------------

static void skip_mode_params(BitReader& b, DecoderState* st) {
  FrameHeader* h = &st->hdr;
  const SequenceHeader& s = st->seq;
  int skipModeAllowed = 0;
  h->skip_mode_frame[0] = h->skip_mode_frame[1] = 0;
  if (!(h->frame_is_intra || !h->reference_select || !s.enable_order_hint)) {
    int forwardIdx = -1, backwardIdx = -1;
    int forwardHint = -1, backwardHint = -1;
    for (int i = 0; i < REFS_PER_FRAME; i++) {
      int refHint = st->ref[h->ref_frame_idx[i]].order_hint;
      if (st->get_relative_dist(refHint, h->order_hint) < 0) {
        if (forwardIdx < 0 ||
            st->get_relative_dist(refHint, forwardHint) > 0) {
          forwardIdx = i;
          forwardHint = refHint;
        }
      } else if (st->get_relative_dist(refHint, h->order_hint) > 0) {
        if (backwardIdx < 0 ||
            st->get_relative_dist(refHint, backwardHint) < 0) {
          backwardIdx = i;
          backwardHint = refHint;
        }
      }
    }
    if (forwardIdx < 0) {
      skipModeAllowed = 0;
    } else if (backwardIdx >= 0) {
      skipModeAllowed = 1;
      h->skip_mode_frame[0] =
          LAST_FRAME + std::min(forwardIdx, backwardIdx);
      h->skip_mode_frame[1] =
          LAST_FRAME + std::max(forwardIdx, backwardIdx);
    } else {
      int secondForwardIdx = -1, secondForwardHint = -1;
      for (int i = 0; i < REFS_PER_FRAME; i++) {
        int refHint = st->ref[h->ref_frame_idx[i]].order_hint;
        if (st->get_relative_dist(refHint, forwardHint) < 0) {
          if (secondForwardIdx < 0 ||
              st->get_relative_dist(refHint, secondForwardHint) > 0) {
            secondForwardIdx = i;
            secondForwardHint = refHint;
          }
        }
      }
      if (secondForwardIdx < 0) {
        skipModeAllowed = 0;
      } else {
        skipModeAllowed = 1;
        h->skip_mode_frame[0] =
            LAST_FRAME + std::min(forwardIdx, secondForwardIdx);
        h->skip_mode_frame[1] =
            LAST_FRAME + std::max(forwardIdx, secondForwardIdx);
      }
    }
  }
  h->skip_mode_present = skipModeAllowed ? (int)b.f(1) : 0;
}

// ---------------------------------------------------------------------------
// Frame header [SPEC §5.9.2 uncompressed_header]
// ---------------------------------------------------------------------------

int parse_frame_header(BitReader& b, DecoderState* st) {
  const SequenceHeader& s = st->seq;
  if (!s.valid) return -1;
  FrameHeader* h = &st->hdr;
  *h = FrameHeader();

  int idLen = 0;
  if (s.frame_id_numbers_present)
    idLen = s.delta_frame_id_length + s.additional_frame_id_length;
  const int allFrames = (1 << NUM_REF_FRAMES) - 1;

  if (s.reduced_still_picture_header) {
    h->show_existing_frame = 0;
    h->frame_type = KEY_FRAME;
    h->frame_is_intra = 1;
    h->show_frame = 1;
    h->showable_frame = 0;
  } else {
    h->show_existing_frame = b.f(1);
    if (h->show_existing_frame) {
      h->frame_to_show_map_idx = b.f(3);
      if (s.decoder_model_info_present && !s.equal_picture_interval) {
        b.f64(s.frame_presentation_time_length);  // temporal_point_info
      }
      h->refresh_frame_flags = 0;
      if (s.frame_id_numbers_present) {
        b.f(idLen);  // display_frame_id
      }
      h->frame_type = st->ref[h->frame_to_show_map_idx].frame_type;
      if (h->frame_type == KEY_FRAME) {
        h->refresh_frame_flags = allFrames;
      }
      // film grain for re-shown frame is loaded from the slot by the
      // pipeline; header parse complete.
      return 0;
    }
    h->frame_type = b.f(2);
    h->frame_is_intra =
        (h->frame_type == INTRA_ONLY_FRAME || h->frame_type == KEY_FRAME);
    h->show_frame = b.f(1);
    if (h->show_frame && s.decoder_model_info_present &&
        !s.equal_picture_interval) {
      b.f64(s.frame_presentation_time_length);  // temporal_point_info
    }
    if (h->show_frame) {
      h->showable_frame = h->frame_type != KEY_FRAME;
    } else {
      h->showable_frame = b.f(1);
    }
    if (h->frame_type == SWITCH_FRAME ||
        (h->frame_type == KEY_FRAME && h->show_frame)) {
      h->error_resilient_mode = 1;
    } else {
      h->error_resilient_mode = b.f(1);
    }
  }

  if (h->frame_type == KEY_FRAME && h->show_frame) {
    for (int i = 0; i < NUM_REF_FRAMES; i++) {
      st->ref[i].valid = 0;
      st->ref[i].order_hint = 0;
    }
  }

  h->disable_cdf_update = b.f(1);
  if (s.seq_force_screen_content_tools == SELECT_SCREEN_CONTENT_TOOLS) {
    h->allow_screen_content_tools = b.f(1);
  } else {
    h->allow_screen_content_tools = s.seq_force_screen_content_tools;
  }
  if (h->allow_screen_content_tools) {
    if (s.seq_force_integer_mv == SELECT_INTEGER_MV) {
      h->force_integer_mv = b.f(1);
    } else {
      h->force_integer_mv = s.seq_force_integer_mv;
    }
  } else {
    h->force_integer_mv = 0;
  }
  if (h->frame_is_intra) h->force_integer_mv = 1;
  h->cur_frame_force_integer_mv = h->force_integer_mv;

  if (s.frame_id_numbers_present) {
    h->current_frame_id = b.f(idLen);
    // mark_ref_frames(idLen) [SPEC §5.9.4]
    int diffLen = s.delta_frame_id_length;
    for (int i = 0; i < NUM_REF_FRAMES; i++) {
      if (h->current_frame_id > (1 << diffLen)) {
        if (st->ref[i].frame_id > h->current_frame_id ||
            st->ref[i].frame_id < h->current_frame_id - (1 << diffLen))
          st->ref[i].valid = 0;
      } else {
        if (st->ref[i].frame_id > h->current_frame_id &&
            st->ref[i].frame_id <
                (1 << idLen) + h->current_frame_id - (1 << diffLen))
          st->ref[i].valid = 0;
      }
    }
  } else {
    h->current_frame_id = 0;
  }

  if (h->frame_type == SWITCH_FRAME) {
    h->frame_size_override = 1;
  } else if (s.reduced_still_picture_header) {
    h->frame_size_override = 0;
  } else {
    h->frame_size_override = b.f(1);
  }
  h->order_hint = b.f(s.order_hint_bits);

  if (h->frame_is_intra || h->error_resilient_mode) {
    h->primary_ref_frame = PRIMARY_REF_NONE;
  } else {
    h->primary_ref_frame = b.f(3);
  }

  if (s.decoder_model_info_present) {
    if (b.f(1)) {  // buffer_removal_time_present_flag
      for (int opNum = 0; opNum < s.operating_points_cnt; opNum++) {
        if (s.op[opNum].decoder_model_present) {
          int opPtIdc = s.op[opNum].idc;
          int inTemporalLayer = (opPtIdc >> st->temporal_id) & 1;
          int inSpatialLayer = (opPtIdc >> (st->spatial_id + 8)) & 1;
          if (opPtIdc == 0 || (inTemporalLayer && inSpatialLayer)) {
            b.f64(s.buffer_removal_time_length);  // buffer_removal_time
          }
        }
      }
    }
  }

  h->allow_high_precision_mv = 0;
  h->use_ref_frame_mvs = 0;
  h->allow_intrabc = 0;
  if (h->frame_type == SWITCH_FRAME ||
      (h->frame_type == KEY_FRAME && h->show_frame)) {
    h->refresh_frame_flags = allFrames;
  } else {
    h->refresh_frame_flags = b.f(8);
  }
  if (!h->frame_is_intra || h->refresh_frame_flags != allFrames) {
    if (h->error_resilient_mode && s.enable_order_hint) {
      for (int i = 0; i < NUM_REF_FRAMES; i++) {
        int ref_order_hint = b.f(s.order_hint_bits);
        h->ref_order_hint[i] = ref_order_hint;
        if (ref_order_hint != st->ref[i].order_hint) st->ref[i].valid = 0;
      }
    }
  }

  if (h->frame_is_intra) {
    frame_size(b, s, h);
    render_size(b, h);
    if (h->allow_screen_content_tools &&
        h->upscaled_width == h->frame_width) {
      h->allow_intrabc = b.f(1);
    }
  } else {
    h->frame_refs_short_signaling = 0;
    if (s.enable_order_hint) {
      h->frame_refs_short_signaling = b.f(1);
      if (h->frame_refs_short_signaling) {
        int last_frame_idx = b.f(3);
        int gold_frame_idx = b.f(3);
        set_frame_refs(st, last_frame_idx, gold_frame_idx);
      }
    }
    for (int i = 0; i < REFS_PER_FRAME; i++) {
      if (!h->frame_refs_short_signaling) {
        h->ref_frame_idx[i] = b.f(3);
      }
      if (s.frame_id_numbers_present) {
        int delta_frame_id = b.f(s.delta_frame_id_length) + 1;
        int expectedFrameId =
            ((h->current_frame_id + (1 << idLen) - delta_frame_id) %
             (1 << idLen));
        h->delta_frame_id[i] = expectedFrameId;
      }
    }
    if (h->frame_size_override && !h->error_resilient_mode) {
      frame_size_with_refs(b, st);
    } else {
      frame_size(b, s, h);
      render_size(b, h);
    }
    if (h->force_integer_mv) {
      h->allow_high_precision_mv = 0;
    } else {
      h->allow_high_precision_mv = b.f(1);
    }
    // read_interpolation_filter [SPEC §5.9.10]
    int is_filter_switchable = b.f(1);
    h->interpolation_filter =
        is_filter_switchable ? SWITCHABLE : (int)b.f(2);
    h->is_motion_mode_switchable = b.f(1);
    if (h->error_resilient_mode || !s.enable_ref_frame_mvs) {
      h->use_ref_frame_mvs = 0;
    } else {
      h->use_ref_frame_mvs = b.f(1);
    }
  }

  if (s.reduced_still_picture_header || h->disable_cdf_update) {
    h->disable_frame_end_update_cdf = 1;
  } else {
    h->disable_frame_end_update_cdf = b.f(1);
  }

  // CDF/context init-vs-load handled by caller (entropy layer); here we
  // handle only the header-level load_previous() / setup_past_independence()
  GlobalMotionParams prev_gm;
  default_gm(&prev_gm);
  if (h->primary_ref_frame == PRIMARY_REF_NONE) {
    setup_past_independence(h);
  } else {
    const RefSlot& prev = st->ref[h->ref_frame_idx[h->primary_ref_frame]];
    prev_gm = prev.saved_gm;
    h->lf.ref_deltas[0] = prev.saved_lf.ref_deltas[0];
    std::memcpy(h->lf.ref_deltas, prev.saved_lf.ref_deltas,
                sizeof(h->lf.ref_deltas));
    std::memcpy(h->lf.mode_deltas, prev.saved_lf.mode_deltas,
                sizeof(h->lf.mode_deltas));
    std::memcpy(h->seg.feature_enabled, prev.saved_seg.feature_enabled,
                sizeof(h->seg.feature_enabled));
    std::memcpy(h->seg.feature_data, prev.saved_seg.feature_data,
                sizeof(h->seg.feature_data));
  }

  tile_info(b, s, h);
  quantization_params(b, s, h);
  segmentation_params(b, st);
  delta_q_params(b, h);
  delta_lf_params(b, h);

  // CodedLossless [SPEC §5.9.12 derivation]
  auto get_qindex_for_seg = [&](int segId) {
    // ignoring delta_q (CurrentQIndex) at header level: seg feature alt-q
    constexpr int SEG_LVL_ALT_Q = 0;
    if (h->seg.enabled && h->seg.feature_enabled[segId][SEG_LVL_ALT_Q]) {
      int data = h->seg.feature_data[segId][SEG_LVL_ALT_Q];
      int qindex = h->quant.base_q_idx + data;
      return std::clamp(qindex, 0, 255);
    }
    return h->quant.base_q_idx;
  };
  h->coded_lossless = 1;
  for (int segId = 0; segId < MAX_SEGMENTS; segId++) {
    int qindex = get_qindex_for_seg(segId);
    h->lossless[segId] =
        (qindex == 0 && h->quant.delta_q_y_dc == 0 &&
         h->quant.delta_q_u_ac == 0 && h->quant.delta_q_u_dc == 0 &&
         h->quant.delta_q_v_ac == 0 && h->quant.delta_q_v_dc == 0);
    if (!h->lossless[segId]) h->coded_lossless = 0;
  }
  h->all_lossless = h->coded_lossless && (h->frame_width == h->upscaled_width);

  loop_filter_params(b, s, h);
  cdef_params(b, s, h);
  lr_params(b, s, h);
  // read_tx_mode [SPEC §5.9.21]
  h->tx_mode = h->coded_lossless ? ONLY_4X4
                                 : (b.f(1) ? TX_MODE_SELECT : TX_MODE_LARGEST);
  // frame_reference_mode [SPEC §5.9.23]
  h->reference_select = h->frame_is_intra ? 0 : (int)b.f(1);
  skip_mode_params(b, st);
  if (h->frame_is_intra || h->error_resilient_mode ||
      !s.enable_warped_motion) {
    h->allow_warped_motion = 0;
  } else {
    h->allow_warped_motion = b.f(1);
  }
  h->reduced_tx_set = b.f(1);
  global_motion_params(b, st, prev_gm);
  film_grain_params(b, st);

  return b.overrun() ? -1 : 0;
}

// ---------------------------------------------------------------------------
// reference_frame_update (header-level) [SPEC §7.20]
// ---------------------------------------------------------------------------

void reference_frame_update(DecoderState* st) {
  const FrameHeader& h = st->hdr;
  // the order hints of this frame's references, read before any slot is
  // refreshed: a refreshed slot may be one of them [SPEC §7.20
  // SavedOrderHints; libaom av1_setup_frame_buf_refs]
  int ref_hints[NUM_REF_FRAMES] = {};
  if (!h.frame_is_intra) {
    for (int j = LAST_FRAME; j <= ALTREF_FRAME; j++)
      ref_hints[j] = st->ref[h.ref_frame_idx[j - LAST_FRAME]].order_hint;
  }
  for (int i = 0; i < NUM_REF_FRAMES; i++) {
    if ((h.refresh_frame_flags >> i) & 1) {
      RefSlot* r = &st->ref[i];
      r->valid = 1;
      r->frame_id = h.current_frame_id;
      r->frame_type = h.frame_type;
      r->order_hint = h.order_hint;
      r->upscaled_width = h.upscaled_width;
      r->frame_width = h.frame_width;
      r->frame_height = h.frame_height;
      r->render_width = h.render_width;
      r->render_height = h.render_height;
      r->mi_cols = h.mi_cols;
      r->mi_rows = h.mi_rows;
      r->bit_depth = st->seq.bit_depth;
      r->subsampling_x = st->seq.subsampling_x;
      r->subsampling_y = st->seq.subsampling_y;
      r->showable_frame = h.showable_frame;
      for (int j = 0; j < NUM_REF_FRAMES; j++)
        r->ref_order_hints[j] = ref_hints[j];
      r->saved_gm = h.gm;
      r->saved_lf = h.lf;
      r->saved_seg = h.seg;
      r->saved_grain = h.grain;
      r->saved_cdfs = st->pending_cdfs;
      r->saved_seg_ids = st->pending_seg_ids;
      r->saved_mvs = st->pending_mvs;
      r->saved_mv_ref = st->pending_mv_ref;
    }
  }
}

}  // namespace av1
