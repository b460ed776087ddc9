// Tile decoding: superblock loop, partition tree, mode info, and
// coefficient decode, emitting plan tensors.  [SPEC §5.11]
//
// This file implements the intra syntax path (KEY/INTRA_ONLY frames);
// inter mode-info lands in a follow-up unit.
#include "tile_decode.h"

#include <algorithm>
#include <cstring>

#include "tables.h"

namespace av1 {

// Labeled syntax trace (AV1N_SYN=1): block/tx-level decode events for
// debugging bit-exactness failures.
static bool syn_trace() {
  // init-once (thread-safe static init; no later writes)
  static const bool v = [] {
    const char* e = std::getenv("AV1N_SYN");
    return e && *e == '1';
  }();
  return v;
}
#define SYN(...) \
  do { \
    if (syn_trace()) fprintf(stderr, __VA_ARGS__); \
  } while (0)

namespace {

inline int floor_log2(int x) {
  int n = -1;
  while (x) {
    n++;
    x >>= 1;
  }
  return n;
}

inline int ceil_log2(int x) {
  if (x < 2) return 0;
  int n = 1, p = 2;
  while (p < x) {
    n++;
    p <<= 1;
  }
  return n;
}

// partition context bytes: bit k set <=> stored block narrower than
// 1<<k mi units, i.e. STRICTLY smaller than the querying block size
// (equal-size neighbor => ctx bit 0).  byte = ~((2 << w) - 1).
inline uint8_t part_ctx_above(int bsize) {
  return 63 ^ ((2 << kMiWidthLog2[bsize]) - 1);
}
inline uint8_t part_ctx_left(int bsize) {
  return 63 ^ ((2 << kMiHeightLog2[bsize]) - 1);
}

// chroma subsampled block size [SPEC Subsampled_Size table]
const int8_t kSubsampled[BLOCK_SIZES_ALL][2][2] = {
    {{BLOCK_4X4, BLOCK_4X4}, {BLOCK_4X4, BLOCK_4X4}},
    {{BLOCK_4X8, BLOCK_4X4}, {BLOCK_INVALID, BLOCK_4X4}},
    {{BLOCK_8X4, BLOCK_INVALID}, {BLOCK_4X4, BLOCK_4X4}},
    {{BLOCK_8X8, BLOCK_8X4}, {BLOCK_4X8, BLOCK_4X4}},
    {{BLOCK_8X16, BLOCK_8X8}, {BLOCK_INVALID, BLOCK_4X8}},
    {{BLOCK_16X8, BLOCK_INVALID}, {BLOCK_8X8, BLOCK_8X4}},
    {{BLOCK_16X16, BLOCK_16X8}, {BLOCK_8X16, BLOCK_8X8}},
    {{BLOCK_16X32, BLOCK_16X16}, {BLOCK_INVALID, BLOCK_8X16}},
    {{BLOCK_32X16, BLOCK_INVALID}, {BLOCK_16X16, BLOCK_16X8}},
    {{BLOCK_32X32, BLOCK_32X16}, {BLOCK_16X32, BLOCK_16X16}},
    {{BLOCK_32X64, BLOCK_32X32}, {BLOCK_INVALID, BLOCK_16X32}},
    {{BLOCK_64X32, BLOCK_INVALID}, {BLOCK_32X32, BLOCK_32X16}},
    {{BLOCK_64X64, BLOCK_64X32}, {BLOCK_32X64, BLOCK_32X32}},
    {{BLOCK_64X128, BLOCK_64X64}, {BLOCK_INVALID, BLOCK_32X64}},
    {{BLOCK_128X64, BLOCK_INVALID}, {BLOCK_64X64, BLOCK_64X32}},
    {{BLOCK_128X128, BLOCK_128X64}, {BLOCK_64X128, BLOCK_64X64}},
    {{BLOCK_4X16, BLOCK_4X8}, {BLOCK_INVALID, BLOCK_4X8}},
    {{BLOCK_16X4, BLOCK_INVALID}, {BLOCK_8X4, BLOCK_8X4}},
    {{BLOCK_8X32, BLOCK_8X16}, {BLOCK_INVALID, BLOCK_4X16}},
    {{BLOCK_32X8, BLOCK_INVALID}, {BLOCK_16X8, BLOCK_16X4}},
    {{BLOCK_16X64, BLOCK_16X32}, {BLOCK_INVALID, BLOCK_8X32}},
    {{BLOCK_64X16, BLOCK_INVALID}, {BLOCK_32X16, BLOCK_32X8}},
};

const int kWienerTapsMin[3] = {-5, -23, -17};
const int kWienerTapsMax[3] = {10, 8, 46};
const int kWienerTapsK[3] = {1, 2, 3};
const int kSgrXqdMin[2] = {-96, -32};
const int kSgrXqdMax[2] = {31, 95};
constexpr int SGRPROJ_PRJ_SUBEXP_K = 4;
constexpr int SGRPROJ_PRJ_BITS = 7;
// Sgr_Params[set] = {r0, e0, r1, e1} [SPEC §9.3]
// Sgr_Params[set] = {r0, s0, r1, s1} [SPEC §7.17.3]; cross-validated
// against libaom's av1_sgr_params .rodata (r0,r1,s0,s1 layout).
const int kSgrParams[16][4] = {
    {2, 140, 1, 3236}, {2, 112, 1, 2158}, {2, 93, 1, 1618},
    {2, 80, 1, 1438},  {2, 70, 1, 1295},  {2, 58, 1, 1177},
    {2, 47, 1, 1079},  {2, 37, 1, 996},   {2, 30, 1, 925},
    {2, 25, 1, 863},   {0, 0, 1, 2589},   {0, 0, 1, 1618},
    {0, 0, 1, 1177},   {0, 0, 1, 925},    {2, 56, 0, 0},
    {2, 22, 0, 0}};

const int8_t kPaletteColorContext[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};
const int kPaletteHashMult[3] = {1, 2, 2};

// filter-intra mode -> intra direction for tx-type ctx [SPEC]
const uint8_t kFimodeToIntraDir[FILTER_INTRA_MODES] = {
    DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};

bool is_directional_mode(int mode) {
  return mode >= V_PRED && mode <= D67_PRED;
}

int neg_deinterleave(int diff, int ref, int max) {
  if (!ref) return diff;
  if (ref >= (max - 1)) return max - diff - 1;
  if (2 * ref < max) {
    if (diff <= 2 * ref) {
      if (diff & 1)
        return ref + ((diff + 1) >> 1);
      else
        return ref - (diff >> 1);
    }
    return diff;
  } else {
    if (diff <= 2 * (max - ref - 1)) {
      if (diff & 1)
        return ref + ((diff + 1) >> 1);
      else
        return ref - (diff >> 1);
    }
    return max - (diff + 1);
  }
}

int inverse_recenter_i(int r, int v) {
  // [SPEC §8.?] odd v recenters BELOW r, even v above (libaom
  // inv_recenter_nonneg)
  if (v > 2 * r) return v;
  if (v & 1) return r - ((v + 1) >> 1);
  return r + (v >> 1);
}

}  // namespace

TileDecoder::TileDecoder(const SequenceHeader& seq, const FrameHeader& hdr,
                         CdfContext* cdf, FramePlans* plans)
    : seq_(seq), hdr_(hdr), cdf_(cdf), plans_(plans) {
  init_scan_tables();
  mi_rows_ = hdr.mi_rows;
  mi_cols_ = hdr.mi_cols;
  int planes = seq.num_planes();
  for (int p = 0; p < planes; p++) {
    int subx = p ? seq.subsampling_x : 0;
    int suby = p ? seq.subsampling_y : 0;
    above_ctx_[p].assign((size_t)(mi_cols_ >> subx) + 32, 0);
    left_ctx_[p].assign((size_t)(mi_rows_ >> suby) + 32, 0);
  }
  above_part_.assign(mi_cols_ + 32, 0);
  left_part_.assign(mi_rows_ + 32, 0);
  above_tx_.assign(mi_cols_ + 32, 64);
  left_tx_.assign(mi_rows_ + 32, 64);
  seg_ids_.assign((size_t)mi_rows_ * mi_cols_, 0);
  cdef_idx_.assign((size_t)((mi_rows_ + 15) / 16) * ((mi_cols_ + 15) / 16),
                   -1);
  pal_grid_.assign((size_t)mi_rows_ * mi_cols_, -1);
  ref0_grid_.assign((size_t)mi_rows_ * mi_cols_, -1);  // NONE = undecoded
  ref1_grid_.assign((size_t)mi_rows_ * mi_cols_, -1);
  comp_group_grid_.assign((size_t)mi_rows_ * mi_cols_, 0);
  compound_idx_grid_.assign((size_t)mi_rows_ * mi_cols_, 0);
  inter_tx_sizes_.assign((size_t)mi_rows_ * mi_cols_, TX_4X4);
  tx_types_.assign((size_t)mi_rows_ * mi_cols_, 0);
  above_seg_pred_.assign(mi_cols_ + 32, 0);
  left_seg_pred_.assign(mi_rows_ + 32, 0);
}

int TileDecoder::decode_tile(const uint8_t* data, size_t size, int tile_row,
                             int tile_col) {
  const TileInfo& t = hdr_.tiles;
  mi_row_start_ = t.mi_row_starts[tile_row];
  mi_row_end_ = t.mi_row_starts[tile_row + 1];
  mi_col_start_ = t.mi_col_starts[tile_col];
  mi_col_end_ = t.mi_col_starts[tile_col + 1];
  r_.init(data, size, !hdr_.disable_cdf_update);

  current_qindex_ = hdr_.quant.base_q_idx;
  for (int i = 0; i < 4; i++) delta_lf_[i] = 0;
  // LR prediction refs reset per tile [SPEC §5.11.57]
  for (int p = 0; p < 3; p++) {
    for (int pass = 0; pass < 2; pass++) {
      lr_ref_wiener_[p][pass][0] = 3;
      lr_ref_wiener_[p][pass][1] = -7;
      lr_ref_wiener_[p][pass][2] = 15;
    }
    lr_ref_sgr_[p][0] = -32;
    lr_ref_sgr_[p][1] = 31;
  }

  int planes = seq_.num_planes();
  for (int p = 0; p < planes; p++) {
    int subx = p ? seq_.subsampling_x : 0;
    std::fill(above_ctx_[p].begin() + (mi_col_start_ >> subx),
              above_ctx_[p].begin() + ((mi_col_end_ >> subx) + 2), 0);
  }
  std::fill(above_part_.begin() + mi_col_start_,
            above_part_.begin() + mi_col_end_, 0);
  std::fill(above_tx_.begin() + mi_col_start_,
            above_tx_.begin() + mi_col_end_, 64);
  std::fill(above_seg_pred_.begin() + mi_col_start_,
            above_seg_pred_.begin() + mi_col_end_, 0);

  int sb4 = seq_.use_128x128_superblock ? 32 : 16;
  int sb_size = seq_.use_128x128_superblock ? BLOCK_128X128 : BLOCK_64X64;
  for (int r = mi_row_start_; r < mi_row_end_; r += sb4) {
    for (int p = 0; p < planes; p++) {
      int suby = p ? seq_.subsampling_y : 0;
      std::fill(left_ctx_[p].begin() + (mi_row_start_ >> suby),
                left_ctx_[p].begin() + ((mi_row_end_ >> suby) + 2), 0);
    }
    std::fill(left_part_.begin() + mi_row_start_,
              left_part_.begin() + mi_row_end_, 0);
    std::fill(left_tx_.begin() + mi_row_start_,
              left_tx_.begin() + mi_row_end_, 64);
    std::fill(left_seg_pred_.begin() + mi_row_start_,
              left_seg_pred_.begin() + mi_row_end_, 0);
    for (int c = mi_col_start_; c < mi_col_end_; c += sb4) {
      read_deltas_ = hdr_.delta_q_present;
      // clear_cdef [SPEC §5.11.55]
      int stride = (mi_cols_ + 15) / 16;
      for (int i = 0; i < sb4; i += 16)
        for (int j = 0; j < sb4; j += 16)
          if (r + i < mi_rows_ && c + j < mi_cols_)
            cdef_idx_[((r + i) >> 4) * stride + ((c + j) >> 4)] = -1;
      clear_block_decoded(r, c, sb4);
      read_lr(r, c, sb_size);
      if (decode_partition(r, c, sb_size) < 0) return -1;
    }
  }
  // Backfill MI_CDEF with the final per-64x64 indices: blocks that
  // decode BEFORE their unit's first non-skip block snapshot a stale -1
  // (the index applies to the whole 64x64 unit [SPEC §7.15.1]).
  {
    int stride = (mi_cols_ + 15) / 16;
    for (int rr = mi_row_start_; rr < mi_row_end_; rr++)
      for (int cc = mi_col_start_; cc < mi_col_end_; cc++)
        plans_->at(MI_CDEF, rr, cc) =
            (int16_t)cdef_idx_[(rr >> 4) * stride + (cc >> 4)];
  }
  return 0;
}

void TileDecoder::clear_block_decoded(int sb_r, int sb_c, int sb4) {
  // [SPEC clear_block_decoded_flags]: above/left borders marked decoded up
  // to the TILE edge (sbWidth4/sbHeight4 = remaining tile extent), so the
  // top border extends one past the SB when the tile continues to the
  // right — this is what makes haveAboveRight available on SB top rows.
  // Interior cleared; below-left corner [sbSize4][-1] forced 0.
  for (int plane = 0; plane < seq_.num_planes(); plane++) {
    int subx = plane ? seq_.subsampling_x : 0;
    int suby = plane ? seq_.subsampling_y : 0;
    int sbW = sb4 >> subx, sbH = sb4 >> suby;
    int sbWidth4 = (mi_col_end_ - sb_c) >> subx;
    int sbHeight4 = (mi_row_end_ - sb_r) >> suby;
    for (int y = -1; y <= sbH; y++) {
      for (int x = -1; x <= sbW; x++) {
        uint8_t v;
        if (y < 0 && x < sbWidth4)
          v = 1;
        else if (x < 0 && y < sbHeight4)
          v = 1;
        else
          v = 0;
        block_decoded_[plane][y + 1][x + 1] = v;
      }
    }
    block_decoded_[plane][sbH + 1][0] = 0;  // [sbH][-1]
  }
}

// ---------------------------------------------------------------------------
// Loop restoration coefficients [SPEC §5.11.57-58]
// ---------------------------------------------------------------------------

int TileDecoder::decode_subexp_bool(int numSyms, int k) {
  int i = 0, mk = 0;
  while (1) {
    int b2 = i ? k + i - 1 : k;
    int a = 1 << b2;
    if (numSyms <= mk + 3 * a) {
      // ns() with equiprobable bool reads [SPEC §5.9.26 via §8.2.5]
      int n = numSyms - mk;
      int w = floor_log2(n) + 1;
      int m = (1 << w) - n;
      int v = (int)r_.decode_literal(w - 1);
      if (v < m) return v + mk;
      int extra = (int)r_.decode_literal(1);
      return ((v << 1) - m + extra) + mk;
    } else {
      if (r_.decode_literal(1)) {
        i++;
        mk += a;
      } else {
        return (int)r_.decode_literal(b2) + mk;
      }
    }
  }
}

int TileDecoder::decode_signed_subexp_with_ref_bool(int low, int high, int k,
                                                    int ref) {
  int mx = high - low;
  int rr = ref - low;
  int v = decode_subexp_bool(mx, k);
  int x;
  if ((rr << 1) <= mx) {
    x = inverse_recenter_i(rr, v);
  } else {
    x = mx - 1 - inverse_recenter_i(mx - 1 - rr, v);
  }
  return x + low;
}

void TileDecoder::read_lr(int r, int c, int bSize) {
  if (hdr_.allow_intrabc) return;
  int w4 = kBlockWidth4[bSize], h4 = kBlockHeight4[bSize];
  for (int plane = 0; plane < seq_.num_planes(); plane++) {
    if (hdr_.lr.frame_restoration_type[plane] == RESTORE_NONE) continue;
    int subx = plane ? seq_.subsampling_x : 0;
    int suby = plane ? seq_.subsampling_y : 0;
    int unitSize = hdr_.lr.loop_restoration_size[plane];
    auto count_units = [&](int frameSize) {
      return std::max((frameSize + (unitSize >> 1)) / unitSize, 1);
    };
    int unitRows = count_units((hdr_.frame_height + suby) >> suby);
    int unitCols = count_units((hdr_.upscaled_width + subx) >> subx);
    int unitRowStart = (r * (4 >> suby) + unitSize - 1) / unitSize;
    int unitRowEnd = std::min(
        unitRows, ((r + h4) * (4 >> suby) + unitSize - 1) / unitSize);
    int numerator, denominator;
    if (hdr_.use_superres) {
      numerator = (4 >> subx) * hdr_.superres_denom;
      denominator = unitSize * SUPERRES_NUM;
    } else {
      numerator = 4 >> subx;
      denominator = unitSize;
    }
    int unitColStart = (c * numerator + denominator - 1) / denominator;
    int unitColEnd = std::min(
        unitCols, ((c + w4) * numerator + denominator - 1) / denominator);
    for (int ur = unitRowStart; ur < unitRowEnd; ur++)
      for (int uc = unitColStart; uc < unitColEnd; uc++)
        read_lr_unit(plane, ur, uc);
  }
}

void TileDecoder::read_lr_unit(int plane, int unitRow, int unitCol) {
  LrUnit u;
  u.plane = plane;
  u.unit_row = unitRow;
  u.unit_col = unitCol;
  u.sgr_set = 0;
  u.sgr_xqd[0] = u.sgr_xqd[1] = 0;
  std::memset(u.wiener, 0, sizeof(u.wiener));
  int frt = hdr_.lr.frame_restoration_type[plane];
  int restoration_type;
  if (frt == RESTORE_WIENER) {
    restoration_type =
        r_.decode_bool(cdf_->restore_wiener) ? RESTORE_WIENER : RESTORE_NONE;
  } else if (frt == RESTORE_SGRPROJ) {
    restoration_type = r_.decode_bool(cdf_->restore_sgrproj)
                           ? RESTORE_SGRPROJ
                           : RESTORE_NONE;
  } else {
    restoration_type = r_.decode_symbol(cdf_->restore_switchable, 3);
  }
  u.type = restoration_type;
  if (restoration_type == RESTORE_WIENER) {
    for (int pass = 0; pass < 2; pass++) {
      int firstCoeff = 0;
      if (plane) {
        firstCoeff = 1;
        u.wiener[pass][0] = 0;
      }
      for (int j = firstCoeff; j < 3; j++) {
        int v = decode_signed_subexp_with_ref_bool(
            kWienerTapsMin[j], kWienerTapsMax[j] + 1, kWienerTapsK[j],
            lr_ref_wiener_[plane][pass][j]);
        u.wiener[pass][j] = v;
        lr_ref_wiener_[plane][pass][j] = v;
      }
    }
  } else if (restoration_type == RESTORE_SGRPROJ) {
    u.sgr_set = (int)r_.decode_literal(4);
    for (int i = 0; i < 2; i++) {
      int radius = kSgrParams[u.sgr_set][i * 2];
      int v;
      if (radius) {
        v = decode_signed_subexp_with_ref_bool(
            kSgrXqdMin[i], kSgrXqdMax[i] + 1, SGRPROJ_PRJ_SUBEXP_K,
            lr_ref_sgr_[plane][i]);
      } else {
        v = 0;
        if (i == 1) {
          v = std::clamp((1 << SGRPROJ_PRJ_BITS) - u.sgr_xqd[0],
                         kSgrXqdMin[i], kSgrXqdMax[i]);
        }
      }
      u.sgr_xqd[i] = v;
      lr_ref_sgr_[plane][i] = v;
    }
  }
  plans_->lr_units.push_back(u);
}

// ---------------------------------------------------------------------------
// Partition tree [SPEC §5.11.4]
// ---------------------------------------------------------------------------

int TileDecoder::decode_partition(int r, int c, int bSize) {
  if (r >= mi_rows_ || c >= mi_cols_) return 0;
  int num4x4 = kBlockWidth4[bSize];
  int half = num4x4 >> 1;
  int quarter = half >> 1;
  bool hasRows = (r + half) < mi_rows_;
  bool hasCols = (c + half) < mi_cols_;
  int partition = PARTITION_NONE;
  int bsl = kMiWidthLog2[bSize];

  if (bSize >= BLOCK_8X8) {
    int above = (above_part_[c] >> bsl) & 1;
    int left = (left_part_[r] >> bsl) & 1;
    int ctx = (bsl - 1) * 4 + left * 2 + above;
    if (hasRows && hasCols) {
      int nsyms = bSize == BLOCK_8X8 ? 4
                  : bSize == BLOCK_128X128 ? 8
                                           : EXT_PARTITION_TYPES;
      partition = r_.decode_symbol(cdf_->partition[ctx], nsyms);
    } else if (hasCols) {
      // bottom half off-screen: choices HORZ vs SPLIT
      uint16_t g[3] = {gather_partition_prob(ctx, bSize, /*vert=*/true), 0,
                       0};
      partition = r_.decode_symbol_noadapt(g, 2) ? PARTITION_SPLIT
                                                 : PARTITION_HORZ;
    } else if (hasRows) {
      uint16_t g[3] = {gather_partition_prob(ctx, bSize, /*vert=*/false), 0,
                       0};
      partition = r_.decode_symbol_noadapt(g, 2) ? PARTITION_SPLIT
                                                 : PARTITION_VERT;
    } else {
      partition = PARTITION_SPLIT;
    }
  }
  int subSize = kPartitionSubsize[partition][bSize];
  int splitSize = kPartitionSubsize[PARTITION_SPLIT][bSize];
  if (subSize == BLOCK_INVALID) return -1;

  switch (partition) {
    case PARTITION_NONE:
      if (decode_block(r, c, subSize) < 0) return -1;
      break;
    case PARTITION_HORZ:
      if (decode_block(r, c, subSize) < 0) return -1;
      if (hasRows)
        if (decode_block(r + half, c, subSize) < 0) return -1;
      break;
    case PARTITION_VERT:
      if (decode_block(r, c, subSize) < 0) return -1;
      if (hasCols)
        if (decode_block(r, c + half, subSize) < 0) return -1;
      break;
    case PARTITION_SPLIT:
      if (decode_partition(r, c, subSize) < 0) return -1;
      if (decode_partition(r, c + half, subSize) < 0) return -1;
      if (decode_partition(r + half, c, subSize) < 0) return -1;
      if (decode_partition(r + half, c + half, subSize) < 0) return -1;
      break;
    case PARTITION_HORZ_A:
      if (decode_block(r, c, splitSize) < 0) return -1;
      if (decode_block(r, c + half, splitSize) < 0) return -1;
      if (decode_block(r + half, c, subSize) < 0) return -1;
      break;
    case PARTITION_HORZ_B:
      if (decode_block(r, c, subSize) < 0) return -1;
      if (decode_block(r + half, c, splitSize) < 0) return -1;
      if (decode_block(r + half, c + half, splitSize) < 0) return -1;
      break;
    case PARTITION_VERT_A:
      if (decode_block(r, c, splitSize) < 0) return -1;
      if (decode_block(r + half, c, splitSize) < 0) return -1;
      if (decode_block(r, c + half, subSize) < 0) return -1;
      break;
    case PARTITION_VERT_B:
      if (decode_block(r, c, subSize) < 0) return -1;
      if (decode_block(r, c + half, splitSize) < 0) return -1;
      if (decode_block(r + half, c + half, splitSize) < 0) return -1;
      break;
    case PARTITION_HORZ_4:
      for (int i = 0; i < 4; i++) {
        int rr = r + i * quarter;
        if (i > 0 && rr >= mi_rows_) break;
        if (decode_block(rr, c, subSize) < 0) return -1;
      }
      break;
    case PARTITION_VERT_4:
      for (int i = 0; i < 4; i++) {
        int cc = c + i * quarter;
        if (i > 0 && cc >= mi_cols_) break;
        if (decode_block(r, cc, subSize) < 0) return -1;
      }
      break;
    default:
      return -1;
  }
  // [libaom update_ext_partition_context]
  if (bSize >= BLOCK_8X8 &&
      (partition != PARTITION_SPLIT || bSize == BLOCK_8X8)) {
    auto update = [&](int rr, int cc, int sub, int over) {
      int bw = kBlockWidth4[over], bh = kBlockHeight4[over];
      uint8_t a = part_ctx_above(sub), l = part_ctx_left(sub);
      for (int i = 0; i < bw && cc + i < mi_cols_; i++)
        above_part_[cc + i] = a;
      for (int i = 0; i < bh && rr + i < mi_rows_; i++)
        left_part_[rr + i] = l;
    };
    switch (partition) {
      case PARTITION_HORZ_A:
        update(r, c, splitSize, subSize);
        update(r + half, c, subSize, subSize);
        break;
      case PARTITION_HORZ_B:
        update(r, c, subSize, subSize);
        update(r + half, c, splitSize, subSize);
        break;
      case PARTITION_VERT_A:
        update(r, c, splitSize, subSize);
        update(r, c + half, subSize, subSize);
        break;
      case PARTITION_VERT_B:
        update(r, c, subSize, subSize);
        update(r, c + half, splitSize, subSize);
        break;
      default:
        update(r, c, subSize, bSize);
        break;
    }
  }
  return 0;
}

uint16_t TileDecoder::gather_partition_prob(int ctx, int bSize, bool vert) {
  // [libaom partition_gather_{vert,horz}_alike]: build a 2-symbol icdf
  // where symbol 1 (icdf value) = P(partition with center split edge)
  const uint16_t* in = cdf_->partition[ctx];
  auto elem_prob = [&](int i) {
    return (int)((i > 0 ? in[i - 1] : 32768) - in[i]);
  };
  int p = 0;
  if (vert) {
    p += elem_prob(PARTITION_VERT);
    p += elem_prob(PARTITION_SPLIT);
    p += elem_prob(PARTITION_HORZ_A);
    p += elem_prob(PARTITION_VERT_A);
    p += elem_prob(PARTITION_VERT_B);
    if (bSize != BLOCK_128X128) p += elem_prob(PARTITION_VERT_4);
  } else {
    p += elem_prob(PARTITION_HORZ);
    p += elem_prob(PARTITION_SPLIT);
    p += elem_prob(PARTITION_HORZ_A);
    p += elem_prob(PARTITION_HORZ_B);
    p += elem_prob(PARTITION_VERT_A);
    if (bSize != BLOCK_128X128) p += elem_prob(PARTITION_HORZ_4);
  }
  return (uint16_t)p;
}

// ---------------------------------------------------------------------------
// Block decode [SPEC §5.11.5]
// ---------------------------------------------------------------------------

int TileDecoder::decode_block(int r, int c, int bSize) {
  mi_row_ = r;
  mi_col_ = c;
  bsize_ = bSize;
  bw4_ = kBlockWidth4[bSize];
  bh4_ = kBlockHeight4[bSize];
  avail_u_ = r > mi_row_start_;
  avail_l_ = c > mi_col_start_;
  has_chroma_ = seq_.num_planes() > 1 &&
                ((r & 1) || !(bh4_ & 1) || !seq_.subsampling_y) &&
                ((c & 1) || !(bw4_ & 1) || !seq_.subsampling_x);
  // chroma availability: the chroma block spans the 4x4 pair [SPEC §5.11.5]
  avail_u_chroma_ = avail_u_;
  avail_l_chroma_ = avail_l_;
  if (has_chroma_) {
    if (seq_.subsampling_y && bh4_ == 1)
      avail_u_chroma_ = (r - 1) > mi_row_start_;
    if (seq_.subsampling_x && bw4_ == 1)
      avail_l_chroma_ = (c - 1) > mi_col_start_;
  } else {
    avail_u_chroma_ = avail_l_chroma_ = false;
  }
  cur_palette_ = -1;

  SYN("B r=%d c=%d bs=%d pos=%ld\n", r, c, bSize, r_.trace_pos());
  if (hdr_.frame_is_intra) {
    if (intra_frame_mode_info() < 0) return -1;
  } else {
    if (inter_frame_mode_info() < 0) return -1;
  }
  SYN("  mi inter=%d mode=%d ref=%d,%d mv=%d,%d skip=%d uv=%d fi=%d\n",
      is_inter_, y_mode_, ref_frame_[0], ref_frame_[1], mv_[0][0], mv_[0][1],
      skip_, uv_mode_, filter_intra_mode_);
  if (palette_size_[0] || palette_size_[1]) palette_tokens();

  // TX size: inter/intrabc non-skip SELECT-mode blocks use the recursive
  // var-tx tree [SPEC §5.11.16]; everything else the block-level read.
  bool inter_tx = is_inter_ || use_intrabc_;
  bool var_tx = hdr_.tx_mode == TX_MODE_SELECT && bsize_ > BLOCK_4X4 &&
                inter_tx && !skip_ && !hdr_.lossless[segment_id_];
  if (var_tx) {
    int maxTxSz = kMaxTxSizeRect[bsize_];
    int txH4 = kTxHeight4[maxTxSz], txW4 = kTxWidth4[maxTxSz];
    for (int row = r; row < r + bh4_; row += txH4)
      for (int col = c; col < c + bw4_; col += txW4)
        read_var_tx_size(row, col, maxTxSz, 0);
    tx_size_ = kMaxTxSizeRect[bsize_];
  } else {
    read_block_tx_size();
    for (int y = 0; y < bh4_ && r + y < mi_rows_; y++)
      for (int x = 0; x < bw4_ && c + x < mi_cols_; x++)
        inter_tx_sizes_[(size_t)(r + y) * mi_cols_ + (c + x)] =
            (uint8_t)tx_size_;
  }

  int mm_for_plans = is_inter_ ? motion_mode_ : 0;
  if (is_inter_ && motion_mode_ == 2 /*WARPED*/) {
    WarpRecord wr;
    wr.mi = r * mi_cols_ + c;
    wr.invalid = warp_invalid_;
    for (int i = 0; i < 6; i++) wr.params[i] = warp_params_[i];
    plans_->warps.push_back(wr);
  }

  for (int y = 0; y < bh4_ && r + y < mi_rows_; y++) {
    for (int x = 0; x < bw4_ && c + x < mi_cols_; x++) {
      plans_->at(MI_BSIZE, r + y, c + x) = (int16_t)bSize;
      plans_->at(MI_MODE, r + y, c + x) = (int16_t)y_mode_;
      plans_->at(MI_UV_MODE, r + y, c + x) = (int16_t)uv_mode_;
      plans_->at(MI_ANGLE_Y, r + y, c + x) = (int16_t)angle_delta_y_;
      plans_->at(MI_ANGLE_UV, r + y, c + x) = (int16_t)angle_delta_uv_;
      plans_->at(MI_SKIP, r + y, c + x) = (int16_t)skip_;
      plans_->at(MI_SEG_ID, r + y, c + x) = (int16_t)segment_id_;
      plans_->at(MI_CFL_ALPHA_IDX, r + y, c + x) = (int16_t)cfl_alpha_idx_;
      plans_->at(MI_CFL_SIGNS, r + y, c + x) = (int16_t)cfl_signs_;
      plans_->at(MI_FILTER_INTRA, r + y, c + x) =
          (int16_t)filter_intra_mode_;
      plans_->at(MI_PALETTE_Y, r + y, c + x) = (int16_t)palette_size_[0];
      plans_->at(MI_PALETTE_UV, r + y, c + x) = (int16_t)palette_size_[1];
      plans_->at(MI_TX_SIZE, r + y, c + x) = (int16_t)tx_size_;
      plans_->at(MI_QINDEX, r + y, c + x) = (int16_t)block_qindex();
      plans_->at(MI_DELTA_LF0, r + y, c + x) = (int16_t)delta_lf_[0];
      plans_->at(MI_DELTA_LF1, r + y, c + x) = (int16_t)delta_lf_[1];
      plans_->at(MI_DELTA_LF2, r + y, c + x) = (int16_t)delta_lf_[2];
      plans_->at(MI_DELTA_LF3, r + y, c + x) = (int16_t)delta_lf_[3];
      plans_->at(MI_CDEF, r + y, c + x) =
          (int16_t)cdef_idx_[((r + y) >> 4) * ((mi_cols_ + 15) / 16) +
                             ((c + x) >> 4)];
      plans_->at(MI_IS_INTER, r + y, c + x) = (int16_t)is_inter_;
      plans_->at(MI_INTRABC, r + y, c + x) = (int16_t)use_intrabc_;
      plans_->at(MI_REF0, r + y, c + x) = (int16_t)ref_frame_[0];
      plans_->at(MI_REF1, r + y, c + x) = (int16_t)ref_frame_[1];
      plans_->at(MI_MV0X, r + y, c + x) = mv_[0][1];
      plans_->at(MI_MV0Y, r + y, c + x) = mv_[0][0];
      plans_->at(MI_MV1X, r + y, c + x) = mv_[1][1];
      plans_->at(MI_MV1Y, r + y, c + x) = mv_[1][0];
      plans_->at(MI_INTERP, r + y, c + x) =
          (int16_t)(interp_filter_[0] | (interp_filter_[1] << 4));
      plans_->at(MI_MOTION_MODE, r + y, c + x) = (int16_t)mm_for_plans;
      plans_->at(MI_COMPOUND_TYPE, r + y, c + x) = (int16_t)compound_type_;
      plans_->at(MI_WEDGE, r + y, c + x) = (int16_t)wedge_packed_;
      plans_->at(MI_BX, r + y, c + x) = (int16_t)c;
      plans_->at(MI_BY, r + y, c + x) = (int16_t)r;
      plans_->at(MI_INTERINTRA, r + y, c + x) = (int16_t)interintra_;
      plans_->at(MI_II_WEDGE, r + y, c + x) = (int16_t)ii_wedge_packed_;
      plans_->at(MI_SKIP_MODE, r + y, c + x) = (int16_t)skip_mode_;
      plans_->at(MI_LOSSLESS, r + y, c + x) =
          (int16_t)hdr_.lossless[segment_id_];
      seg_ids_[(size_t)(r + y) * mi_cols_ + (c + x)] = (uint8_t)segment_id_;
      pal_grid_[(size_t)(r + y) * mi_cols_ + (c + x)] = cur_palette_;
      size_t g = (size_t)(r + y) * mi_cols_ + (c + x);
      ref0_grid_[g] = (int8_t)ref_frame_[0];
      ref1_grid_[g] = (int8_t)ref_frame_[1];
      comp_group_grid_[g] = (uint8_t)comp_group_cur_;
      compound_idx_grid_[g] = (uint8_t)compound_idx_cur_;
    }
  }

  residual();

  if (!var_tx) {
    // txfm context update: skipped inter blocks register their full block
    // dims [libaom set_txfm_ctxs]; others their tx dims
    int txw = tx_size_wide(tx_size_), txh = tx_size_high(tx_size_);
    if (inter_tx && skip_) {
      txw = 4 * bw4_;
      txh = 4 * bh4_;
    }
    for (int x = 0; x < bw4_ && c + x < mi_cols_; x++)
      above_tx_[c + x] = (uint8_t)txw;
    for (int y = 0; y < bh4_ && r + y < mi_rows_; y++)
      left_tx_[r + y] = (uint8_t)txh;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Var-tx size tree [SPEC §5.11.16]
// ---------------------------------------------------------------------------

void TileDecoder::read_var_tx_size(int row, int col, int txSz, int depth) {
  if (row >= mi_rows_ || col >= mi_cols_) return;
  int txfm_split;
  if (txSz == TX_4X4 || depth == MAX_TX_DEPTH) {
    txfm_split = 0;
  } else {
    // ctx [libaom txfm_partition_context]
    int maxDim = std::max(4 * bw4_, 4 * bh4_);
    int maxTx;  // square tx size of the block's larger dimension, cap 64
    if (maxDim >= 64)
      maxTx = TX_64X64;
    else if (maxDim >= 32)
      maxTx = TX_32X32;
    else if (maxDim >= 16)
      maxTx = TX_16X16;
    else
      maxTx = TX_8X8;
    int category = ((int)kTxSizeSqrUp[txSz] != maxTx && maxTx > TX_8X8) +
                   (TX_SIZES - 1 - maxTx) * 2;
    int above = above_tx_[col] < tx_size_wide(txSz);
    int left = left_tx_[row] < tx_size_high(txSz);
    int ctx = category * 3 + above + left;
    txfm_split = r_.decode_bool(cdf_->txfm_partition[ctx]);
  }
  int w4 = kTxWidth4[txSz], h4 = kTxHeight4[txSz];
  if (txfm_split) {
    int subTx = kSplitTxSize[txSz];
    int stepW = kTxWidth4[subTx], stepH = kTxHeight4[subTx];
    for (int i = 0; i < h4; i += stepH)
      for (int j = 0; j < w4; j += stepW)
        read_var_tx_size(row + i, col + j, subTx, depth + 1);
  } else {
    for (int i = 0; i < h4 && row + i < mi_rows_; i++)
      for (int j = 0; j < w4 && col + j < mi_cols_; j++)
        inter_tx_sizes_[(size_t)(row + i) * mi_cols_ + (col + j)] =
            (uint8_t)txSz;
    for (int j = 0; j < w4 && col + j < mi_cols_; j++)
      above_tx_[col + j] = (uint8_t)tx_size_wide(txSz);
    for (int i = 0; i < h4 && row + i < mi_rows_; i++)
      left_tx_[row + i] = (uint8_t)tx_size_high(txSz);
  }
}

int TileDecoder::base_qindex_for_segment() const {
  // get_qindex(ignoreDeltaQ=1, segId) [SPEC §7.12.2 semantics]
  constexpr int SEG_LVL_ALT_Q = 0;
  if (hdr_.seg.enabled &&
      hdr_.seg.feature_enabled[segment_id_][SEG_LVL_ALT_Q]) {
    int data = hdr_.seg.feature_data[segment_id_][SEG_LVL_ALT_Q];
    return std::clamp(hdr_.quant.base_q_idx + data, 0, 255);
  }
  return hdr_.quant.base_q_idx;
}

int TileDecoder::block_qindex() const {
  constexpr int SEG_LVL_ALT_Q = 0;
  if (hdr_.seg.enabled &&
      hdr_.seg.feature_enabled[segment_id_][SEG_LVL_ALT_Q]) {
    int data = hdr_.seg.feature_data[segment_id_][SEG_LVL_ALT_Q];
    return std::clamp(current_qindex_ + data, 0, 255);
  }
  return current_qindex_;
}

// ---------------------------------------------------------------------------
// Intra mode info [SPEC §5.11.8-5.11.14]
// ---------------------------------------------------------------------------

void TileDecoder::intra_segment_id() {
  if (hdr_.seg.enabled && hdr_.seg.update_map) {
    read_segment_id(false);
  } else {
    segment_id_ = 0;
  }
}

void TileDecoder::read_segment_id(bool skip) {
  int prev_ul = -1, prev_u = -1, prev_l = -1;
  int r = mi_row_, c = mi_col_;
  if (avail_u_ && avail_l_)
    prev_ul = seg_ids_[(size_t)(r - 1) * mi_cols_ + (c - 1)];
  if (avail_u_) prev_u = seg_ids_[(size_t)(r - 1) * mi_cols_ + c];
  if (avail_l_) prev_l = seg_ids_[(size_t)r * mi_cols_ + (c - 1)];
  int pred;
  if (prev_u == -1)
    pred = prev_l == -1 ? 0 : prev_l;
  else if (prev_l == -1)
    pred = prev_u;
  else
    pred = (prev_ul == prev_u) ? prev_u : prev_l;
  if (skip) {
    segment_id_ = pred;
    return;
  }
  int cdf_num;
  if (prev_ul < 0)
    cdf_num = 0;
  else if (prev_ul == prev_u && prev_ul == prev_l)
    cdf_num = 2;
  else if (prev_ul == prev_u || prev_ul == prev_l || prev_u == prev_l)
    cdf_num = 1;
  else
    cdf_num = 0;
  int coded = r_.decode_symbol(cdf_->segment_id[cdf_num], MAX_SEGMENTS);
  segment_id_ =
      neg_deinterleave(coded, pred, hdr_.seg.last_active_seg_id + 1);
}

void TileDecoder::read_skip() {
  constexpr int SEG_LVL_SKIP = 6;
  if (hdr_.seg.seg_id_pre_skip && hdr_.seg.enabled &&
      hdr_.seg.feature_enabled[segment_id_][SEG_LVL_SKIP]) {
    skip_ = 1;
  } else {
    int above = avail_u_ ? plans_->at(MI_SKIP, mi_row_ - 1, mi_col_) : 0;
    int left = avail_l_ ? plans_->at(MI_SKIP, mi_row_, mi_col_ - 1) : 0;
    skip_ = r_.decode_bool(cdf_->skip[above + left]);
  }
}

void TileDecoder::read_cdef() {
  // [SPEC §5.11.56]: one index per 64x64, read at the first non-skip block
  if (skip_ || hdr_.coded_lossless || !seq_.enable_cdef ||
      hdr_.allow_intrabc)
    return;
  int stride = (mi_cols_ + 15) / 16;
  int r1 = (mi_row_ & ~15) >> 4;
  int c1 = (mi_col_ & ~15) >> 4;
  if (cdef_idx_[r1 * stride + c1] == -1) {
    int v = (int)r_.decode_literal(hdr_.cdef.bits);
    // copy to all 64x64 units covered by this block
    int h64 = std::max(1, bh4_ >> 4), w64 = std::max(1, bw4_ >> 4);
    for (int i = 0; i < h64; i++)
      for (int j = 0; j < w64; j++) {
        int rr = r1 + i, cc = c1 + j;
        if (rr * 16 < mi_rows_ && cc * 16 < mi_cols_)
          cdef_idx_[rr * stride + cc] = v;
      }
  }
}

int TileDecoder::read_delta_abs(uint16_t* cdf, int nsyms) {
  int abs = r_.decode_symbol(cdf, nsyms);
  if (abs == nsyms - 1) {
    int rem_bits = (int)r_.decode_literal(3) + 1;
    int bits = (int)r_.decode_literal(rem_bits);
    abs = bits + (1 << rem_bits) + 1;
  }
  if (abs) {
    if (r_.decode_literal(1)) abs = -abs;
  }
  return abs;
}

void TileDecoder::read_delta_qindex() {
  int sbSize = seq_.use_128x128_superblock ? BLOCK_128X128 : BLOCK_64X64;
  if (bsize_ == sbSize && skip_) return;
  if (!read_deltas_) return;
  if (hdr_.delta_q_present) {
    int v = read_delta_abs(cdf_->delta_q, 4);
    current_qindex_ =
        std::clamp(current_qindex_ + (v << hdr_.delta_q_res), 1, 255);
  }
}

void TileDecoder::read_delta_lf() {
  int sbSize = seq_.use_128x128_superblock ? BLOCK_128X128 : BLOCK_64X64;
  if (bsize_ == sbSize && skip_) return;
  if (!read_deltas_ || !hdr_.delta_lf_present) return;
  int count = hdr_.delta_lf_multi ? (seq_.num_planes() > 1 ? 4 : 2) : 1;
  for (int i = 0; i < count; i++) {
    uint16_t* cdf =
        hdr_.delta_lf_multi ? cdf_->delta_lf_multi[i] : cdf_->delta_lf;
    int v = read_delta_abs(cdf, 4);
    delta_lf_[i] =
        std::clamp(delta_lf_[i] + (v << hdr_.delta_lf_res), -63, 63);
  }
  if (!hdr_.delta_lf_multi) {
    for (int i = 1; i < 4; i++) delta_lf_[i] = delta_lf_[0];
  }
}

int TileDecoder::intra_frame_mode_info() {
  skip_ = 0;
  segment_id_ = 0;
  use_intrabc_ = 0;
  is_inter_ = 0;
  skip_mode_ = 0;
  palette_size_[0] = palette_size_[1] = 0;
  filter_intra_mode_ = -1;
  cfl_alpha_idx_ = 0;
  cfl_signs_ = 0;
  angle_delta_y_ = angle_delta_uv_ = 0;
  ref_frame_[0] = INTRA_FRAME;
  ref_frame_[1] = NONE_FRAME;
  mv_[0][0] = mv_[0][1] = mv_[1][0] = mv_[1][1] = 0;
  motion_mode_ = 0;
  compound_type_ = 0;
  wedge_packed_ = 0;
  interintra_ = 0;
  ii_wedge_packed_ = 0;
  interp_filter_[0] = interp_filter_[1] = EIGHTTAP;
  comp_group_cur_ = 0;
  compound_idx_cur_ = 1;

  if (hdr_.seg.seg_id_pre_skip) intra_segment_id();
  read_skip();
  if (!hdr_.seg.seg_id_pre_skip) intra_segment_id();
  read_cdef();
  read_delta_qindex();
  read_delta_lf();
  read_deltas_ = 0;

  if (hdr_.allow_intrabc) {
    use_intrabc_ = r_.decode_bool(cdf_->intrabc);
  }
  if (use_intrabc_) {
    // IntraBC: DC modes, bilinear filter, DV via the MV stack
    // [SPEC §5.11.6 intrabc arm]
    y_mode_ = DC_PRED;
    uv_mode_ = DC_PRED;
    interp_filter_[0] = interp_filter_[1] = BILINEAR;
    find_mv_stack(false);
    assign_mv(false);
    return 0;
  }

  int above_mode =
      avail_u_ ? plans_->at(MI_MODE, mi_row_ - 1, mi_col_) : DC_PRED;
  int left_mode =
      avail_l_ ? plans_->at(MI_MODE, mi_row_, mi_col_ - 1) : DC_PRED;
  int above_ctx = kIntraModeContext[above_mode];
  int left_ctx = kIntraModeContext[left_mode];
  y_mode_ =
      r_.decode_symbol(cdf_->kf_y_mode[above_ctx][left_ctx], INTRA_MODES);
  intra_angle_info_y();

  if (has_chroma_) {
    int cfl_allowed;
    if (hdr_.lossless[segment_id_]) {
      // lossless: CFL allowed iff the CHROMA residual block is 4x4
      // [SPEC intra_frame_mode_info]
      int cw4 = std::max(1, kBlockWidth4[bsize_] >> seq_.subsampling_x);
      int ch4 = std::max(1, kBlockHeight4[bsize_] >> seq_.subsampling_y);
      cfl_allowed = (cw4 == 1 && ch4 == 1);
    } else {
      cfl_allowed = kBlockWidth4[bsize_] <= 8 && kBlockHeight4[bsize_] <= 8;
    }
    uv_mode_ = r_.decode_symbol(cdf_->uv_mode[cfl_allowed][y_mode_],
                                cfl_allowed ? UV_INTRA_MODES
                                            : UV_INTRA_MODES - 1);
    if (uv_mode_ == UV_CFL_PRED) read_cfl_alphas();
    intra_angle_info_uv();
  } else {
    uv_mode_ = DC_PRED;
  }

  if (bsize_ >= BLOCK_8X8 && kBlockWidth4[bsize_] <= 16 &&
      kBlockHeight4[bsize_] <= 16 && hdr_.allow_screen_content_tools) {
    palette_mode_info();
  }
  filter_intra_mode_info();
  return 0;
}

void TileDecoder::intra_angle_info_y() {
  angle_delta_y_ = 0;
  if (bsize_ >= BLOCK_8X8 && is_directional_mode(y_mode_)) {
    int sym = r_.decode_symbol(cdf_->angle_delta[y_mode_ - V_PRED],
                               2 * MAX_ANGLE_DELTA + 1);
    angle_delta_y_ = sym - MAX_ANGLE_DELTA;
  }
}

void TileDecoder::intra_angle_info_uv() {
  angle_delta_uv_ = 0;
  if (bsize_ >= BLOCK_8X8 && is_directional_mode(uv_mode_)) {
    int sym = r_.decode_symbol(cdf_->angle_delta[uv_mode_ - V_PRED],
                               2 * MAX_ANGLE_DELTA + 1);
    angle_delta_uv_ = sym - MAX_ANGLE_DELTA;
  }
}

void TileDecoder::read_cfl_alphas() {
  // [SPEC §5.11.45]
  int joint = r_.decode_symbol(cdf_->cfl_sign, 8);
  cfl_signs_ = joint;
  int sign_u = (joint + 1) / 3;
  int sign_v = (joint + 1) % 3;
  int idx = 0;
  if (sign_u != 0) {
    int ctx = joint - 2;
    idx = r_.decode_symbol(cdf_->cfl_alpha[ctx], 16) << 4;
  }
  if (sign_v != 0) {
    int ctx = sign_v * 3 + sign_u - 3;
    idx += r_.decode_symbol(cdf_->cfl_alpha[ctx], 16);
  }
  cfl_alpha_idx_ = idx;
}

void TileDecoder::filter_intra_mode_info() {
  filter_intra_mode_ = -1;
  if (seq_.enable_filter_intra && y_mode_ == DC_PRED &&
      palette_size_[0] == 0 &&
      std::max(kBlockWidth4[bsize_], kBlockHeight4[bsize_]) <= 8) {
    if (r_.decode_bool(cdf_->filter_intra[bsize_])) {
      filter_intra_mode_ =
          r_.decode_symbol(cdf_->filter_intra_mode, FILTER_INTRA_MODES);
    }
  }
}

// ---------------------------------------------------------------------------
// Palette [SPEC §5.11.46-5.11.50]
// ---------------------------------------------------------------------------

const PaletteRecord* TileDecoder::palette_at(int r, int c) const {
  int32_t idx = pal_grid_[(size_t)r * mi_cols_ + c];
  if (idx < 0) return nullptr;
  return &plans_->palettes[idx];
}

int TileDecoder::get_palette_cache(int plane, uint16_t* cache) {
  // [SPEC get_palette_cache]: merge above (same 64-row band) + left
  const PaletteRecord* above = nullptr;
  const PaletteRecord* left = nullptr;
  if (avail_u_ && (mi_row_ & 15)) above = palette_at(mi_row_ - 1, mi_col_);
  if (avail_l_) left = palette_at(mi_row_, mi_col_ - 1);
  int comp = plane;  // 0 = Y colors, 1 = U colors
  auto size_of = [&](const PaletteRecord* p) {
    if (!p) return 0;
    if (comp == 0) return (int)p->size;
    return (int)p->size_uv;
  };
  int aboveN = size_of(above), leftN = size_of(left);
  const int32_t* ac = above ? above->colors[comp] : nullptr;
  const int32_t* lc = left ? left->colors[comp] : nullptr;
  int ai = 0, li = 0, n = 0;
  while (ai < aboveN && li < leftN) {
    uint16_t a = (uint16_t)ac[ai], l = (uint16_t)lc[li];
    if (a < l) {
      if (n == 0 || a != cache[n - 1]) cache[n++] = a;
      ai++;
    } else {
      if (n == 0 || l != cache[n - 1]) cache[n++] = l;
      li++;
    }
  }
  while (ai < aboveN) {
    uint16_t a = (uint16_t)ac[ai++];
    if (n == 0 || a != cache[n - 1]) cache[n++] = a;
  }
  while (li < leftN) {
    uint16_t l = (uint16_t)lc[li++];
    if (n == 0 || l != cache[n - 1]) cache[n++] = l;
  }
  return n;
}

void TileDecoder::palette_mode_info() {
  int bsize_ctx = kMiWidthLog2[bsize_] + kMiHeightLog2[bsize_] - 2;
  if (y_mode_ == DC_PRED) {
    int above =
        avail_u_ && plans_->at(MI_PALETTE_Y, mi_row_ - 1, mi_col_) > 0;
    int left = avail_l_ && plans_->at(MI_PALETTE_Y, mi_row_, mi_col_ - 1) > 0;
    if (r_.decode_bool(cdf_->palette_y_mode[bsize_ctx][above + left])) {
      palette_size_[0] =
          r_.decode_symbol(cdf_->palette_y_size[bsize_ctx], 7) + 2;
      read_palette_colors_y();
    }
  }
  if (has_chroma_ && uv_mode_ == DC_PRED) {
    int ctx = palette_size_[0] > 0;
    if (r_.decode_bool(cdf_->palette_uv_mode[ctx])) {
      palette_size_[1] =
          r_.decode_symbol(cdf_->palette_uv_size[bsize_ctx], 7) + 2;
      read_palette_colors_uv();
    }
  }
  if (palette_size_[0] || palette_size_[1]) {
    PaletteRecord rec;
    rec.mi_row = mi_row_;
    rec.mi_col = mi_col_;
    rec.size = palette_size_[0];
    rec.size_uv = palette_size_[1];
    std::memset(rec.colors, 0, sizeof(rec.colors));
    for (int i = 0; i < palette_size_[0]; i++)
      rec.colors[0][i] = palette_colors_[0][i];
    for (int i = 0; i < palette_size_[1]; i++) {
      rec.colors[1][i] = palette_colors_[1][i];
      rec.colors[2][i] = palette_colors_[2][i];
    }
    plans_->palettes.push_back(rec);
    cur_palette_ = (int)plans_->palettes.size() - 1;
    plans_->color_map_off.resize(2 * plans_->palettes.size(), -1);
  }
}

void TileDecoder::read_palette_colors_y() {
  uint16_t cache[16];
  int cacheN = get_palette_cache(0, cache);
  int n = palette_size_[0];
  int idx = 0;
  for (int i = 0; i < cacheN && idx < n; i++) {
    if (r_.decode_literal(1)) palette_colors_[0][idx++] = cache[i];
  }
  if (idx < n) {
    // first new color precedes the extra-bits field [SPEC §5.11.45]
    palette_colors_[0][idx++] = (int)r_.decode_literal(seq_.bit_depth);
    int bits = 0;
    if (idx < n)
      bits = (seq_.bit_depth - 3) + (int)r_.decode_literal(2);
    while (idx < n) {
      int delta = (int)r_.decode_literal(bits) + 1;
      int v = std::min(palette_colors_[0][idx - 1] + delta,
                       (1 << seq_.bit_depth) - 1);
      palette_colors_[0][idx++] = v;
      int range = (1 << seq_.bit_depth) - v - 1;
      if (idx < n) bits = std::min(bits, ceil_log2(range));
    }
  }
  std::sort(palette_colors_[0], palette_colors_[0] + n);
}

void TileDecoder::read_palette_colors_uv() {
  uint16_t cache[16];
  int n = palette_size_[1];
  // U colors: cache + ascending deltas (no +1 offset) [SPEC §5.11.48]
  int cacheN = get_palette_cache(1, cache);
  int idx = 0;
  for (int i = 0; i < cacheN && idx < n; i++) {
    if (r_.decode_literal(1)) palette_colors_[1][idx++] = cache[i];
  }
  if (idx < n) {
    // first new color precedes the extra-bits field [SPEC §5.11.46]
    palette_colors_[1][idx++] = (int)r_.decode_literal(seq_.bit_depth);
    int bits = 0;
    if (idx < n)
      bits = (seq_.bit_depth - 3) + (int)r_.decode_literal(2);
    while (idx < n) {
      int delta = (int)r_.decode_literal(bits);
      int v = std::min(palette_colors_[1][idx - 1] + delta,
                       (1 << seq_.bit_depth) - 1);
      palette_colors_[1][idx++] = v;
      int range = (1 << seq_.bit_depth) - v;
      if (idx < n) bits = std::min(bits, ceil_log2(range));
    }
  }
  std::sort(palette_colors_[1], palette_colors_[1] + n);
  // V colors [SPEC §5.11.48]: either raw list or signed wraparound deltas
  int maxVal = (1 << seq_.bit_depth) - 1;
  if (r_.decode_literal(1)) {
    int minBits = seq_.bit_depth - 4;  // V deltas: bd-4 [SPEC §5.11.46]
    int bits = minBits + (int)r_.decode_literal(2);
    palette_colors_[2][0] = (int)r_.decode_literal(seq_.bit_depth);
    for (int i = 1; i < n; i++) {
      int delta = (int)r_.decode_literal(bits);
      if (delta && r_.decode_literal(1)) delta = -delta;
      int v = palette_colors_[2][i - 1] + delta;
      if (v < 0) v += maxVal + 1;
      if (v > maxVal) v -= maxVal + 1;
      palette_colors_[2][i] = v;
    }
  } else {
    for (int i = 0; i < n; i++)
      palette_colors_[2][i] = (int)r_.decode_literal(seq_.bit_depth);
  }
}

void TileDecoder::palette_tokens() {
  // [SPEC §5.11.49]: diagonal-wavefront color index map decode
  for (int planePair = 0; planePair < 2; planePair++) {
    int n = palette_size_[planePair];
    if (!n) continue;
    int subx = planePair ? seq_.subsampling_x : 0;
    int suby = planePair ? seq_.subsampling_y : 0;
    int bw = (4 * bw4_) >> subx;
    int bh = (4 * bh4_) >> suby;
    int maxX = ((mi_cols_ * 4) >> subx) - ((mi_col_ * 4) >> subx);
    int maxY = ((mi_rows_ * 4) >> suby) - ((mi_row_ * 4) >> suby);
    int ow = std::min(bw, maxX);
    int oh = std::min(bh, maxY);
    // a chroma map under 4 samples wide (high), a 4x16 or 16x4 block's,
    // covers 2 more [SPEC §5.11.49]
    if (bw < 4) {
      bw += 2;
      ow += 2;
    }
    if (bh < 4) {
      bh += 2;
      oh += 2;
    }
    std::vector<uint8_t> map((size_t)bh * bw, 0);
    // first sample is NS(n) coded (non-symmetric uniform) [SPEC §4.10.7]
    {
      int w = ceil_log2(n);
      int m = (1 << w) - n;
      int v = w > 1 ? (int)r_.decode_literal(w - 1) : 0;
      map[0] = (uint8_t)(v < m ? v
                                : (v << 1) - m + (int)r_.decode_literal(1));
    }
    auto cdf_arr =
        planePair == 0 ? cdf_->palette_y_color : cdf_->palette_uv_color;
    for (int i = 1; i < oh + ow - 1; i++) {
      for (int j = std::min(i, ow - 1); j >= std::max(0, i - oh + 1); j--) {
        int rr = i - j, cc = j;
        int scores[8] = {};
        if (cc > 0) scores[map[(size_t)rr * bw + cc - 1]] += 2;
        if (rr > 0 && cc > 0)
          scores[map[(size_t)(rr - 1) * bw + cc - 1]] += 1;
        if (rr > 0) scores[map[(size_t)(rr - 1) * bw + cc]] += 2;
        int order[8];
        for (int k = 0; k < 8; k++) order[k] = k;
        for (int k = 0; k < 3; k++) {
          int maxScore = scores[k], maxIdx = k;
          for (int m = k + 1; m < n; m++) {
            if (scores[m] > maxScore) {
              maxScore = scores[m];
              maxIdx = m;
            }
          }
          if (maxIdx != k) {
            int saveOrd = order[maxIdx];
            for (int m = maxIdx; m > k; m--) {
              scores[m] = scores[m - 1];
              order[m] = order[m - 1];
            }
            scores[k] = maxScore;
            order[k] = saveOrd;
          }
        }
        int hash = 0;
        for (int k = 0; k < 3; k++) hash += scores[k] * kPaletteHashMult[k];
        int ctx = kPaletteColorContext[hash];
        int sym = r_.decode_symbol(cdf_arr[n - 2][ctx], n);
        map[(size_t)rr * bw + cc] = (uint8_t)order[sym];
      }
    }
    for (int rr = 0; rr < oh; rr++)
      for (int cc = ow; cc < bw; cc++)
        map[(size_t)rr * bw + cc] = map[(size_t)rr * bw + ow - 1];
    for (int rr = oh; rr < bh; rr++)
      for (int cc = 0; cc < bw; cc++)
        map[(size_t)rr * bw + cc] = map[(size_t)(rr - 1) * bw + cc];
    if (cur_palette_ >= 0) {
      plans_->color_map_off[2 * cur_palette_ + planePair] =
          (int32_t)plans_->color_map.size();
      plans_->color_map.insert(plans_->color_map.end(), map.begin(),
                               map.end());
    }
  }
}

// ---------------------------------------------------------------------------
// TX size [SPEC §5.11.15-5.11.16]
// ---------------------------------------------------------------------------

void TileDecoder::read_block_tx_size() {
  if (hdr_.lossless[segment_id_]) {
    tx_size_ = TX_4X4;
    return;
  }
  int maxRect = kMaxTxSizeRect[bsize_];
  // allowSelect = !skip || !is_inter [SPEC §5.11.15]: intra blocks code
  // tx_depth even when skip; inter/intrabc skip blocks use the max size
  bool allowSelect = !skip_ || !(is_inter_ || use_intrabc_);
  if (hdr_.tx_mode != TX_MODE_SELECT || bsize_ == BLOCK_4X4 ||
      !allowSelect) {
    tx_size_ = hdr_.tx_mode == ONLY_4X4 ? TX_4X4 : maxRect;
    return;
  }
  int maxDepth = kMaxTxDepth[bsize_];
  int depthSyms = std::min(maxDepth, MAX_TX_DEPTH) + 1;
  int cat;
  {
    int t = maxRect, d = 0;
    while (t != TX_4X4) {
      t = kSplitTxSize[t];
      d++;
    }
    cat = std::clamp(d - 1, 0, 3);
  }
  int maxTxWide = tx_size_wide(maxRect);
  int maxTxHigh = tx_size_high(maxRect);
  int above = avail_u_ ? (above_tx_[mi_col_] >= maxTxWide) : 0;
  int left = avail_l_ ? (left_tx_[mi_row_] >= maxTxHigh) : 0;
  if (avail_u_ && plans_->at(MI_IS_INTER, mi_row_ - 1, mi_col_))
    above = 4 * kBlockWidth4[plans_->at(MI_BSIZE, mi_row_ - 1, mi_col_)] >=
            maxTxWide;
  if (avail_l_ && plans_->at(MI_IS_INTER, mi_row_, mi_col_ - 1))
    left = 4 * kBlockHeight4[plans_->at(MI_BSIZE, mi_row_, mi_col_ - 1)] >=
           maxTxHigh;
  int ctx;
  if (avail_u_ && avail_l_)
    ctx = above + left;
  else if (avail_u_)
    ctx = above;
  else if (avail_l_)
    ctx = left;
  else
    ctx = 0;
  int depth = r_.decode_symbol(cdf_->tx_size[cat][ctx], depthSyms);
  tx_size_ = maxRect;
  for (int i = 0; i < depth; i++) tx_size_ = kSplitTxSize[tx_size_];
}

int TileDecoder::get_uv_tx_size() const {
  if (hdr_.lossless[segment_id_]) return TX_4X4;
  int pb = kSubsampled[bsize_][seq_.subsampling_x][seq_.subsampling_y];
  int uvTx = kMaxTxSizeRect[pb];
  // clamp 64-dim chroma tx to 32 [SPEC get_tx_size]
  if (kTxWidth4[uvTx] == 16 || kTxHeight4[uvTx] == 16) {
    if (kTxWidth4[uvTx] == 4) return TX_16X32;
    if (kTxHeight4[uvTx] == 4) return TX_32X16;
    return TX_32X32;
  }
  return uvTx;
}

// ---------------------------------------------------------------------------
// Residual & coefficients [SPEC §5.11.34-5.11.39]
// ---------------------------------------------------------------------------

void TileDecoder::residual() {
  int widthChunks = std::max(1, bw4_ >> 4);
  int heightChunks = std::max(1, bh4_ >> 4);
  int miSizeChunk =
      (widthChunks > 1 || heightChunks > 1) ? BLOCK_64X64 : bsize_;
  for (int chunkY = 0; chunkY < heightChunks; chunkY++) {
    for (int chunkX = 0; chunkX < widthChunks; chunkX++) {
      int miRowChunk = mi_row_ + (chunkY << 4);
      int miColChunk = mi_col_ + (chunkX << 4);
      int planes = has_chroma_ ? seq_.num_planes() : 1;
      for (int plane = 0; plane < planes; plane++) {
        int txSz;
        if (hdr_.lossless[segment_id_]) {
          txSz = TX_4X4;
        } else {
          txSz = plane ? get_uv_tx_size() : tx_size_;
        }
        int stepX = kTxWidth4[txSz];
        int stepY = kTxHeight4[txSz];
        int planeSz = plane ? kSubsampled[miSizeChunk][seq_.subsampling_x]
                                         [seq_.subsampling_y]
                            : miSizeChunk;
        int num4x4W = kBlockWidth4[planeSz];
        int num4x4H = kBlockHeight4[planeSz];
        int subX = plane ? seq_.subsampling_x : 0;
        int subY = plane ? seq_.subsampling_y : 0;
        int baseX = (miColChunk >> subX) * 4;
        int baseY = (miRowChunk >> subY) * 4;
        if ((is_inter_ || use_intrabc_) && !hdr_.lossless[segment_id_] &&
            !plane) {
          // inter luma: walk the var-tx tree [SPEC §5.11.35]
          transform_tree(baseX, baseY, num4x4W * 4, num4x4H * 4);
        } else {
          for (int y = 0; y < num4x4H; y += stepY)
            for (int x = 0; x < num4x4W; x += stepX)
              transform_block(plane, baseX, baseY, txSz, x, y);
        }
      }
    }
  }
}

void TileDecoder::transform_tree(int startX, int startY, int w, int h) {
  // [SPEC §5.11.36]
  int maxX = mi_cols_ * 4, maxY = mi_rows_ * 4;
  if (startX >= maxX || startY >= maxY) return;
  int row = startY >> 2, col = startX >> 2;
  int lumaTxSz = inter_tx_sizes_[(size_t)row * mi_cols_ + col];
  int lumaW = tx_size_wide(lumaTxSz), lumaH = tx_size_high(lumaTxSz);
  if (lumaW == w && lumaH == h) {
    transform_block(0, startX, startY, lumaTxSz, 0, 0);
  } else if (w > h) {
    transform_tree(startX, startY, w / 2, h);
    transform_tree(startX + w / 2, startY, w / 2, h);
  } else if (w < h) {
    transform_tree(startX, startY, w, h / 2);
    transform_tree(startX, startY + h / 2, w, h / 2);
  } else {
    transform_tree(startX, startY, w / 2, h / 2);
    transform_tree(startX + w / 2, startY, w / 2, h / 2);
    transform_tree(startX, startY + h / 2, w / 2, h / 2);
    transform_tree(startX + w / 2, startY + h / 2, w / 2, h / 2);
  }
}

void TileDecoder::transform_block(int plane, int baseX, int baseY, int txSz,
                                  int x, int y) {
  int subX = plane ? seq_.subsampling_x : 0;
  int subY = plane ? seq_.subsampling_y : 0;
  int startX = baseX + 4 * x;
  int startY = baseY + 4 * y;
  int maxX = (mi_cols_ * 4) >> subX;
  int maxY = (mi_rows_ * 4) >> subY;
  if (startX >= maxX || startY >= maxY) return;

  int txw4 = kTxWidth4[txSz], txh4 = kTxHeight4[txSz];

  // intra neighbor availability [SPEC transform_block -> predict_intra]
  int sbMask = seq_.use_128x128_superblock ? 31 : 15;
  int miRowTx = (startY << subY) >> 2;
  int miColTx = (startX << subX) >> 2;
  int py = (miRowTx & sbMask) >> subY;  // plane 4x4 units within SB
  int px = (miColTx & sbMask) >> subX;
  // x/y are chunk-relative for >64 blocks: availability must be judged
  // against the BLOCK origin, not the chunk origin
  int blockX = (mi_col_ >> subX) * 4;
  int blockY = (mi_row_ >> subY) * 4;
  int haveLeft = (startX > blockX) || (plane ? avail_l_chroma_ : avail_l_);
  int haveAbove = (startY > blockY) || (plane ? avail_u_chroma_ : avail_u_);
  int haveAboveRight = bdec(plane, py - 1, px + txw4);
  int haveBelowLeft = bdec(plane, py + txh4, px - 1);
  int avail = haveLeft | (haveAbove << 1) | (haveAboveRight << 2) |
              (haveBelowLeft << 3);
  for (int i = 0; i < txh4; i++)
    for (int j = 0; j < txw4; j++)
      if (py + i + 1 < 36 && px + j + 1 < 36)
        block_decoded_[plane][py + i + 1][px + j + 1] = 1;

  int eob = 0, txType = DCT_DCT;
  size_t coefOff = (size_t)-1;
  if (!skip_) {
    eob = coeffs(plane, startX, startY, txSz, &txType, &coefOff);
    if (eob < 0) return;  // propagated error (unused currently)
  } else {
    set_coeff_contexts(plane, startX >> 2, startY >> 2, txw4, txh4, 0);
  }
  int32_t rec[N_TXR_FIELDS];
  rec[TXR_PLANE] = plane;
  rec[TXR_X4] = startX >> 2;
  rec[TXR_Y4] = startY >> 2;
  rec[TXR_TX_SIZE] =
      hdr_.lossless[segment_id_] && txSz == TX_4X4 ? TX_WHT_MARKER : txSz;
  rec[TXR_TX_TYPE] = txType;
  rec[TXR_EOB] = eob;
  rec[TXR_COEF_OFF] = coefOff == (size_t)-1 ? -1 : (int32_t)coefOff;
  rec[TXR_MI] = mi_row_ * mi_cols_ + mi_col_;
  rec[TXR_AVAIL] = avail;
  plans_->tx_records.insert(plans_->tx_records.end(), rec,
                            rec + N_TXR_FIELDS);
}

void TileDecoder::set_coeff_contexts(int plane, int x4, int y4, int w4,
                                     int h4, uint8_t v) {
  // For transform blocks overhanging the frame edge, the value is only
  // stored for the within-frame cells; the rest are cleared (libaom
  // av1_set_entropy_contexts edge handling).
  int subx = plane ? seq_.subsampling_x : 0;
  int suby = plane ? seq_.subsampling_y : 0;
  int ncols = mi_cols_ >> subx;  // plane 4x4 cells to the frame edge
  int nrows = mi_rows_ >> suby;
  auto& above = above_ctx_[plane];
  auto& left = left_ctx_[plane];
  for (int i = 0; i < w4 && x4 + i < (int)above.size(); i++)
    above[x4 + i] = (x4 + i < ncols) ? v : 0;
  for (int i = 0; i < h4 && y4 + i < (int)left.size(); i++)
    left[y4 + i] = (y4 + i < nrows) ? v : 0;
}

int TileDecoder::read_tx_type(int plane, int txSz, int x4, int y4,
                              int* out_type) {
  // [SPEC §5.11.47 transform_type + §5.11.40 compute_tx_type]
  bool inter_tx = is_inter_ || use_intrabc_;
  int set_type =
      get_ext_tx_set_type(txSz, inter_tx ? 1 : 0, hdr_.reduced_tx_set);
  if (plane != 0) {
    int t;
    if (hdr_.lossless[segment_id_] || kTxSizeSqrUp[txSz] > TX_32X32) {
      t = DCT_DCT;
    } else if (inter_tx) {
      // inter chroma copies the co-located luma tx type [SPEC §5.11.40]
      int lx = std::max(mi_col_, x4 << seq_.subsampling_x);
      int ly = std::max(mi_row_, y4 << seq_.subsampling_y);
      t = tx_types_[(size_t)std::min(ly, mi_rows_ - 1) * mi_cols_ +
                    std::min(lx, mi_cols_ - 1)];
      if (!kExtTxUsed[set_type][t]) t = DCT_DCT;
    } else {
      t = kIntraModeToTxType[uv_mode_];
      if (!kExtTxUsed[set_type][t]) t = DCT_DCT;
    }
    *out_type = t;
    return 0;
  }
  int set_idx = ext_tx_set_index(set_type, inter_tx ? 1 : 0);
  int qindex = base_qindex_for_segment();
  if (set_idx == 0 || qindex == 0 || hdr_.lossless[segment_id_]) {
    *out_type = DCT_DCT;
    return 0;
  }
  int sqr = kTxSizeSqr[txSz];
  int sym;
  if (inter_tx) {
    sym = r_.decode_symbol(cdf_->inter_ext_tx[set_idx][sqr],
                           kNumExtTxSymbols[set_type]);
  } else {
    int intra_dir = filter_intra_mode_ >= 0
                        ? kFimodeToIntraDir[filter_intra_mode_]
                        : y_mode_;
    sym = r_.decode_symbol(cdf_->intra_ext_tx[set_idx][sqr][intra_dir],
                           kNumExtTxSymbols[set_type]);
  }
  *out_type = kExtTxInv[set_type][sym];
  return 0;
}

int TileDecoder::coeffs(int plane, int startX, int startY, int txSz,
                        int* out_tx_type, size_t* out_coef_off) {
  int x4 = startX >> 2, y4 = startY >> 2;
  int w4 = kTxWidth4[txSz], h4 = kTxHeight4[txSz];
  int txSzCtx = (kTxSizeSqr[txSz] + kTxSizeSqrUp[txSz] + 1) >> 1;
  int ptype = plane > 0;
  int adjTxSz = kAdjustedTxSize[txSz];
  int adjW = tx_size_wide(adjTxSz), adjH = tx_size_high(adjTxSz);
  int bwl = kTxWidthLog2[adjTxSz];

  *out_tx_type = DCT_DCT;
  *out_coef_off = (size_t)-1;

  int txbSkipCtx = get_txb_skip_ctx(plane, txSz, x4, y4, w4, h4);
  SYN("  C p=%d x4=%d y4=%d tx=%d skipctx=%d pos=%ld\n", plane, x4, y4,
      txSz, txbSkipCtx, r_.trace_pos());
  int all_zero = r_.decode_bool(cdf_->txb_skip[txSzCtx][txbSkipCtx]);
  if (all_zero) {
    set_coeff_contexts(plane, x4, y4, w4, h4, 0);
    return 0;
  }

  read_tx_type(plane, txSz, x4, y4, out_tx_type);
  int txType = *out_tx_type;
  if (plane == 0) {
    // TxTypes grid for inter-chroma derivation [SPEC §5.11.47]
    for (int i = 0; i < h4 && y4 + i < mi_rows_; i++)
      for (int j = 0; j < w4 && x4 + j < mi_cols_; j++)
        tx_types_[(size_t)(y4 + i) * mi_cols_ + (x4 + j)] = (uint8_t)txType;
  }

  const ScanOrder& so = get_scan(txSz, txType);
  int txClass = kTxClass[txType];

  // eob_pt
  int eobMultisize = kTxWidthLog2[adjTxSz] + kTxHeightLog2[adjTxSz] - 4;
  int eobPtCtx = txClass == TX_CLASS_2D ? 0 : 1;
  int eob_pt;
  switch (eobMultisize) {
    case 0:
      eob_pt = r_.decode_symbol(cdf_->eob_pt_16[ptype][eobPtCtx], 5) + 1;
      break;
    case 1:
      eob_pt = r_.decode_symbol(cdf_->eob_pt_32[ptype][eobPtCtx], 6) + 1;
      break;
    case 2:
      eob_pt = r_.decode_symbol(cdf_->eob_pt_64[ptype][eobPtCtx], 7) + 1;
      break;
    case 3:
      eob_pt = r_.decode_symbol(cdf_->eob_pt_128[ptype][eobPtCtx], 8) + 1;
      break;
    case 4:
      eob_pt = r_.decode_symbol(cdf_->eob_pt_256[ptype][eobPtCtx], 9) + 1;
      break;
    case 5:
      eob_pt = r_.decode_symbol(cdf_->eob_pt_512[ptype][eobPtCtx], 10) + 1;
      break;
    default:
      eob_pt = r_.decode_symbol(cdf_->eob_pt_1024[ptype][eobPtCtx], 11) + 1;
      break;
  }
  int eob;
  if (eob_pt < 3) {
    eob = eob_pt;
  } else {
    int extraBits = eob_pt - 2;
    int base = (1 << (eob_pt - 2)) + 1;
    int bit = r_.decode_bool(cdf_->eob_extra[txSzCtx][ptype][eob_pt - 3]);
    int rest = 0;
    if (extraBits > 1) rest = (int)r_.decode_literal(extraBits - 1);
    eob = base + (bit << (extraBits - 1)) + rest;
  }

  const int TX_PAD_HOR = 4;
  int stride = adjW + TX_PAD_HOR;
  std::vector<uint8_t> levels((size_t)stride * (adjH + 4), 0);
  std::vector<int32_t> quant((size_t)adjW * adjH, 0);

  auto padded = [&](int pos) {
    int row = pos >> bwl;
    int col = pos - (row << bwl);
    return row * stride + col;
  };

  for (int c = eob - 1; c >= 0; c--) {
    int pos = so.scan[c];
    int level;
    if (c == eob - 1) {
      int ctx;
      if (c == 0)
        ctx = 0;
      else if (c <= (adjH * adjW) / 8)
        ctx = 1;
      else if (c <= (adjH * adjW) / 4)
        ctx = 2;
      else
        ctx = 3;
      level =
          r_.decode_symbol(cdf_->coeff_base_eob[txSzCtx][ptype][ctx], 3) + 1;
    } else {
      int ctx = get_coeff_base_ctx(levels.data(), pos, bwl, stride, txClass,
                                   tx_size_wide(txSz), tx_size_high(txSz));
      level = r_.decode_symbol(cdf_->coeff_base[txSzCtx][ptype][ctx], 4);
    }
    if (level > 2) {
      int brCtx = get_br_ctx(levels.data(), pos, bwl, stride, txClass);
      int brTxCtx = std::min(txSzCtx, (int)TX_32X32);
      for (int idx = 0; idx < 4; idx++) {
        int k = r_.decode_symbol(cdf_->coeff_br[brTxCtx][ptype][brCtx], 4);
        level += k;
        if (k < 3) break;
      }
    }
    levels[padded(pos)] = (uint8_t)std::min(level, 127);
    quant[pos] = level;
  }

  int dc_sign = 0;
  int cul_level = 0;
  for (int c = 0; c < eob; c++) {
    int pos = so.scan[c];
    int level = quant[pos];
    if (level) {
      int sign;
      if (c == 0) {
        int dcCtx = get_dc_sign_ctx(plane, x4, y4, w4, h4);
        sign = r_.decode_bool(cdf_->dc_sign[ptype][dcCtx]);
      } else {
        sign = (int)r_.decode_literal(1);
      }
      if (level >= 15) {
        level += (int)r_.decode_golomb();
      }
      cul_level += level;
      quant[pos] = sign ? -level : level;
      if (c == 0) dc_sign = sign ? 1 : 2;
    }
  }
  cul_level = std::min(cul_level, 63);

  set_coeff_contexts(plane, x4, y4, w4, h4,
                     (uint8_t)(cul_level | (dc_sign << 6)));

  *out_coef_off = plans_->coeffs.size();
  plans_->coeffs.insert(plans_->coeffs.end(), quant.begin(), quant.end());
  return eob;
}

int TileDecoder::get_txb_skip_ctx(int plane, int txSz, int x4, int y4,
                                  int w4, int h4) {
  auto& above = above_ctx_[plane];
  auto& left = left_ctx_[plane];
  if (plane == 0) {
    if (kBlockWidth4[bsize_] == kTxWidth4[txSz] &&
        kBlockHeight4[bsize_] == kTxHeight4[txSz])
      return 0;
    static const uint8_t skip_contexts[5][5] = {{1, 2, 2, 2, 3},
                                                {1, 4, 4, 4, 5},
                                                {1, 4, 4, 4, 5},
                                                {1, 4, 4, 4, 5},
                                                {1, 4, 4, 4, 6}};
    int top = 0, lft = 0;
    for (int i = 0; i < w4; i++) top |= above[x4 + i];
    for (int i = 0; i < h4; i++) lft |= left[y4 + i];
    top &= 63;
    lft &= 63;
    int mx = std::min(top | lft, 4);
    int mn = std::min(std::min(top, lft), 4);
    return skip_contexts[mn][mx];
  } else {
    int aboveNz = 0, leftNz = 0;
    for (int i = 0; i < w4; i++) aboveNz |= above[x4 + i];
    for (int i = 0; i < h4; i++) leftNz |= left[y4 + i];
    int ctxBase = (aboveNz != 0) + (leftNz != 0);
    int pb = kSubsampled[bsize_][seq_.subsampling_x][seq_.subsampling_y];
    int bigger = kBlockWidth4[pb] != kTxWidth4[txSz] ||
                 kBlockHeight4[pb] != kTxHeight4[txSz];
    return ctxBase + (bigger ? 10 : 7);
  }
}

int TileDecoder::get_dc_sign_ctx(int plane, int x4, int y4, int w4, int h4) {
  auto& above = above_ctx_[plane];
  auto& left = left_ctx_[plane];
  int dcSign = 0;
  for (int i = 0; i < w4; i++) {
    int s = above[x4 + i] >> 6;
    if (s == 1)
      dcSign--;
    else if (s == 2)
      dcSign++;
  }
  for (int i = 0; i < h4; i++) {
    int s = left[y4 + i] >> 6;
    if (s == 1)
      dcSign--;
    else if (s == 2)
      dcSign++;
  }
  if (dcSign < 0) return 1;
  if (dcSign > 0) return 2;
  return 0;
}

int TileDecoder::get_coeff_base_ctx(const uint8_t* levels, int pos, int bwl,
                                    int stride, int txClass, int realW,
                                    int realH) {
  int row = pos >> bwl;
  int col = pos - (row << bwl);
  int p = row * stride + col;
  // rect band rule decided by the REAL (unadjusted) tx shape
  int width = realW, height = realH;
  int mag = std::min<int>(levels[p + 1], 3) +
            std::min<int>(levels[p + stride], 3);
  if (txClass == TX_CLASS_2D) {
    mag += std::min<int>(levels[p + stride + 1], 3);
    mag += std::min<int>(levels[p + 2], 3);
    mag += std::min<int>(levels[p + 2 * stride], 3);
  } else if (txClass == TX_CLASS_VERT) {
    mag += std::min<int>(levels[p + 2 * stride], 3);
    mag += std::min<int>(levels[p + 3 * stride], 3);
    mag += std::min<int>(levels[p + 4 * stride], 3);
  } else {
    mag += std::min<int>(levels[p + 2], 3);
    mag += std::min<int>(levels[p + 3], 3);
    mag += std::min<int>(levels[p + 4], 3);
  }
  int ctx = std::min(4, (mag + 1) >> 1);
  if (txClass == TX_CLASS_2D) {
    // position offset [SPEC coeff base ctx]: square uses (row+col) bands;
    // wide rect: rows 0-1 -> 11; tall rect: cols 0-1 -> 16
    // (verified against libgav1's per-size tables)
    if (pos == 0) return 0;
    int off;
    if (width < height && row < 2) {
      off = 11;
    } else if (width > height && col < 2) {
      off = 16;
    } else {
      int rc = std::min(row, 4) + std::min(col, 4);
      off = rc < 2 ? 1 : rc < 4 ? 6 : 21;
    }
    return ctx + off;
  }
  int idx = txClass == TX_CLASS_VERT ? row : col;
  int off = idx == 0 ? 0 : idx == 1 ? 5 : 10;
  return 26 + ctx + off;
}

int TileDecoder::get_br_ctx(const uint8_t* levels, int pos, int bwl,
                            int stride, int txClass) {
  int row = pos >> bwl;
  int col = pos - (row << bwl);
  int p = row * stride + col;
  int mag = levels[p + 1] + levels[p + stride];
  if (txClass == TX_CLASS_2D) {
    mag += levels[p + stride + 1];
    mag = std::min((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (row < 2 && col < 2) return mag + 7;
  } else if (txClass == TX_CLASS_HORIZ) {
    mag += levels[p + 2];
    mag = std::min((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (col == 0) return mag + 7;
  } else {
    mag += levels[p + 2 * stride];
    mag = std::min((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (row == 0) return mag + 7;
  }
  return mag + 14;
}

}  // namespace av1
