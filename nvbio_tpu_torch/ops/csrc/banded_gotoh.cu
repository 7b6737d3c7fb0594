// Banded Gotoh affine-gap DP for Hopper (sm_90a): K1, K3 and K2.
//
//   k1_banded_score          symbol windows, score + sink
//       replaces nvbio_tpu/ops/banded_dp.py  banded_score_pallas
//       (_make_kernel32, reached through banded_score_pallas_staged)
//   k3_banded_score_packed   windows of the 2-bit packed genome, score + sink
//       replaces nvbio_tpu/ops/banded_dp.py  banded_score_pallas_packed
//       (_make_kernel32_packed)
//   k2_banded_directions     symbol windows, score + sink + one flag byte
//       per band cell
//       replaces nvbio_tpu/ops/banded_dp.py  banded_directions_pallas
//       (_make_kernel32 with dirs_ref)
//
// What they compute is nvbio_tpu_torch/alignment/batched.py cell for cell
// (the plain PyTorch versions, which mirror the JAX twin): invalid cells
// (j < 0 or j > tlen) are masked to NEG_INF every row, so no sentinel
// drift needs bounding, and the outputs follow the Pallas kernels'
// contract (floor clamp, SEMI_GLOBAL last-row mask with the lowest k on
// ties, LOCAL earliest-row-then-lowest-k sink, zero-length patterns,
// t_end = max(p_end + k - w, 0)).
//
// K1 and K3: NVBIO's own banded_alignment_score, one thread per
// alignment.  The TPU kernel put the batch across VPU lanes and the band
// across sublanes, and solved the in-row E recurrence with a Kogge-Stone
// scan; here a thread owns one alignment, holds the band's H, F and the
// text symbols under it in registers (CAP is a compile-time band
// capacity, so every band loop unrolls and the arrays never leave the
// register file), and runs E sequentially along the band:
//     E[k] = max(Hhat[k-1] - (eo + ee), E[k-1] - ee).
// The text window slides one symbol per row through the register array.
// What bounds them on the H100: integer ALU issue and the row-to-row
// dependence (about 15 int32 ops per cell in this compare-and-select
// form, against a least count of 10, chip_smoke.py GOTOH_OPS; no
// tensor-core work).  Loads
// are per thread and not coalesced (a warp reads 32 different pattern
// rows), which the L1 absorbs only in part.
//
// K2: the sub-warp band-parallel kernel of group_gotoh.cuh (shared with
// K4's tiers up to 128 cells), for bands up to 64 cells.  What bounded
// K2 in the one-thread design: each thread stored its 2w+1 flag bytes a
// row one byte at a time into its own alignment's rows, so a warp store
// touched 32 sectors for 32 useful bytes; pattern and quality loads sat
// uncoalesced on the row chain; and the traceback call's 4 096 winners
// made 32 blocks, so 100 of the 132 SMs stood idle.  Now G = 4 / 8 / 16
// lanes an alignment (bands of 16 / 32 / 64 cells) put 2-8 alignments in
// a warp and 8-32 in a block, over every SM; a row's flag bytes come from
// neighbouring lanes and leave in 16-byte stores of whole row runs; what
// bounds it is the integer issue of the flag cell (a least count of 18
// instructions, chip_smoke.py GOTOH_FLAG_OPS) plus the group's per-row
// shuffles and scan (see group_gotoh.cuh).

#include "gotoh_common.cuh"
#include "group_gotoh.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ int text_symbol(const Args& a, int b, int m,
                                           int tlen, bool packed) {
  // window-relative text symbol m; PAD outside the window (those cells
  // are masked, except m = -1 under j = 0, which scores as N like the
  // twin's PAD padding)
  if (packed) {
    if (m < 0 || m >= tlen) return PAD_SYMBOL;
    int64_t idx = a.win_start[b] + m;
    int64_t w = idx >> 4;
    if (w >= a.n_words) return PAD_SYMBOL;
    uint32_t word = static_cast<uint32_t>(a.gwords[w]);
    return static_cast<int>((word >> (2 * (idx & 15))) & 3u);
  }
  if (m < 0 || m >= a.lt) return PAD_SYMBOL;
  return a.texts[static_cast<int64_t>(b) * a.lt + m];
}

template <int CAP, int ATYPE, bool PACKED>
__global__ void __launch_bounds__(THREADS)
banded_gotoh_kernel(const Args a) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= a.nb) return;
  const Scheme sc = a.sc;
  const int w = a.band_w;
  const int band = 2 * w + 1;
  const int plen = a.plens[b];
  const int tlen = a.tlens[b];
  const int8_t* pat = a.pats + static_cast<int64_t>(b) * a.lp;
  const uint8_t* qual = a.quals + static_cast<int64_t>(b) * a.lp;

  int H[CAP], F[CAP], T[CAP];
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    const int j0 = k - w;
    int h0;
    if (ATYPE == GLOBAL)
      h0 = j0 == 0 ? 0 : (j0 > 0 ? -(sc.eo + sc.ee * j0) : NEG_INF);
    else
      h0 = j0 >= 0 ? 0 : NEG_INF;
    H[k] = (k < band && j0 <= tlen) ? h0 : NEG_INF;
    F[k] = NEG_INF;
    // T[k] holds the text symbol under cell k of the NEXT row: row i0
    // reads window symbol i0 + k - w
    T[k] = text_symbol(a, b, k - w, tlen, PACKED);
  }

  int best = ATYPE == LOCAL ? 0 : NEG_INF;
  int best_i = 0, best_k = w;
  const int k_goal = tlen - plen + w;
  // rows past the pattern's end change no score
  const int n_rows = min(plen, a.lp);
  for (int i0 = 0; i0 < n_rows; ++i0) {
    const int p = pat[i0];
    const int q = min(static_cast<int>(qual[i0]), 40);
    const int mm = sc.mm_min + floor_div40((sc.mm_max - sc.mm_min) * q);
    const int j_base = i0 + 1 - w;
    const int row = i0 + 1;
    int hhat_m_prev = NEG_INF;  // Hhat (masked) of cell k - 1
    int e_prev = NEG_INF;       // E (unmasked) of cell k - 1
    int row_best = NEG_INF - 1, row_k = 0, h_goal = NEG_INF;
#pragma unroll
    for (int k = 0; k < CAP; ++k) {
      const int j = j_base + k;
      const bool valid = k < band && j >= 0 && j <= tlen;
      const int t = T[k];
      const int s = (p >= 4 || t >= 4) ? -sc.n_penalty
                                       : (p == t ? sc.match : -mm);
      // H[k + 1] and F[k + 1] still hold the previous row here
      const int up_h = k + 1 < CAP ? H[k + 1] : NEG_INF;
      const int up_f = k + 1 < CAP ? F[k + 1] : NEG_INF;
      const int f_open = up_h - (sc.fo + sc.fe);
      const int f_new = max(f_open, up_f - sc.fe);
      const int h_diag = H[k] + s;
      int hhat = max(h_diag, f_new);
      if (ATYPE == LOCAL) hhat = max(hhat, 0);
      const int a_open = hhat_m_prev - (sc.eo + sc.ee);
      const int e = k == 0 ? a_open : max(a_open, e_prev - sc.ee);
      e_prev = e;
      hhat_m_prev = valid ? hhat : NEG_INF;
      int h_new = max(hhat, e);
      if (ATYPE == LOCAL) h_new = max(h_new, 0);
      h_new = valid ? h_new : NEG_INF;
      H[k] = h_new;
      F[k] = valid ? f_new : NEG_INF;
      if (k < band) {
        if (h_new > row_best) {  // strict: the lowest k wins ties
          row_best = h_new;
          row_k = k;
        }
        if (ATYPE == GLOBAL && k == k_goal) h_goal = h_new;
      }
    }
    if (ATYPE == GLOBAL) {
      if (row == plen) {
        best = h_goal;  // NEG_INF when k_goal is outside the band
        best_i = row;
        best_k = k_goal;
      }
    } else if (ATYPE == SEMI_GLOBAL) {
      if (row == plen) {
        best = row_best;
        best_i = row;
        best_k = row_k;
      }
    } else if (row <= plen && row_best > best) {
      best = row_best;
      best_i = row;
      best_k = row_k;
    }
    // slide the text window one symbol
#pragma unroll
    for (int k = 0; k + 1 < CAP; ++k) T[k] = T[k + 1];
    T[CAP - 1] = text_symbol(a, b, i0 + CAP - w, tlen, PACKED);
  }

  if (best < SCORE_FLOOR) best = NEG_INF;
  if (plen <= 0) {
    best = ATYPE == LOCAL ? 0 : NEG_INF;
    best_i = 0;
    best_k = w;
  }
  a.out[b] = best;
  a.out[a.nb + b] = best_i;
  a.out[2 * a.nb + b] = max(best_i + best_k - w, 0);
}

template <int CAP, bool PACKED>
cudaError_t launch_atype(const Args& a, int atype, cudaStream_t stream) {
  const dim3 grid((a.nb + THREADS - 1) / THREADS), block(THREADS);
  switch (atype) {
    case GLOBAL:
      banded_gotoh_kernel<CAP, GLOBAL, PACKED>
          <<<grid, block, 0, stream>>>(a);
      break;
    case SEMI_GLOBAL:
      banded_gotoh_kernel<CAP, SEMI_GLOBAL, PACKED>
          <<<grid, block, 0, stream>>>(a);
      break;
    case LOCAL:
      banded_gotoh_kernel<CAP, LOCAL, PACKED>
          <<<grid, block, 0, stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch(const Args& a, int atype, cudaStream_t stream) {
  if (a.nb == 0) return cudaSuccess;
  const int band = 2 * a.band_w + 1;
  // the wrapper rejects bands wider than the widest instantiation
  if (band <= 16) return launch_atype<16, PACKED>(a, atype, stream);
  if (band <= 32) return launch_atype<32, PACKED>(a, atype, stream);
  if (band <= 64) return launch_atype<64, PACKED>(a, atype, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// All pointers are device pointers; out is (3, nb) int32.  Returns the
// cudaError_t of the launch (0 on success).
int k1_banded_score(const void* pats, const void* quals, const void* plens,
                    const void* texts, const void* tlens, int nb, int lp,
                    int lt, int band_w, int atype, int match, int mm_min,
                    int mm_max, int n_penalty, int eo, int ee, int fo, int fe,
                    void* out, void* stream) {
  Args a = make_args(pats, quals, plens, tlens, nb, lp, band_w, match, mm_min,
                     mm_max, n_penalty, eo, ee, fo, fe, out);
  a.texts = static_cast<const int8_t*>(texts);
  a.lt = lt;
  return static_cast<int>(launch<false>(
      a, atype, static_cast<cudaStream_t>(stream)));
}

int k3_banded_score_packed(const void* pats, const void* quals,
                           const void* plens, const void* gwords,
                           long long n_words, const void* win_start,
                           const void* tlens, int nb, int lp, int band_w,
                           int atype, int match, int mm_min, int mm_max,
                           int n_penalty, int eo, int ee, int fo, int fe,
                           void* out, void* stream) {
  Args a = make_args(pats, quals, plens, tlens, nb, lp, band_w, match, mm_min,
                     mm_max, n_penalty, eo, ee, fo, fe, out);
  a.gwords = static_cast<const int32_t*>(gwords);
  a.n_words = n_words;
  a.win_start = static_cast<const int64_t*>(win_start);
  return static_cast<int>(launch<true>(
      a, atype, static_cast<cudaStream_t>(stream)));
}

int k2_banded_directions(const void* pats, const void* quals,
                         const void* plens, const void* texts,
                         const void* tlens, int nb, int lp, int lt,
                         int band_w, int atype, int match, int mm_min,
                         int mm_max, int n_penalty, int eo, int ee, int fo,
                         int fe, void* out, void* dirs, void* stream) {
  Args a = make_args(pats, quals, plens, tlens, nb, lp, band_w, match, mm_min,
                     mm_max, n_penalty, eo, ee, fo, fe, out);
  a.texts = static_cast<const int8_t*>(texts);
  a.lt = lt;
  a.dirs = static_cast<uint8_t*>(dirs);
  // the wrapper rejects bands wider than 64 cells
  if (2 * band_w + 1 > 64) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(grp::launch<false, true>(
      a, atype, static_cast<cudaStream_t>(stream)));
}

// cudaGetErrorString for the wrapper's messages
const char* banded_gotoh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
