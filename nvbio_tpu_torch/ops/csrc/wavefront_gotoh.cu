// Anti-diagonal wide-band banded Gotoh DP for Hopper (sm_90a): K5.
//
//   k5_wavefront_score       score + sink, raw twin values
//   k5_band_score            the same on the banded column-sweep tier,
//                            for lp <= 32 * 256 (the wrapper takes it
//                            there, at any band; below)
//   k5_band_warps_per_sm     its resident warps
//   k5_wavefront_score_matrix  the same with substitution scores from a
//                            K x K table (protein SW: BLOSUM62)
//   k5_full_score_matrix     the matrix mode's full-band tier, for
//                            band_w >= max(Lp, Lt) (below)
//   k5_full_scratch_words, k5_full_warps_per_sm  its scratch and grid
//   k5_wavefront_directions  score + sink + one 4-bit flag per band cell,
//                            in the diagonal layout of ops/wavefront_dp.py
//   k5_state_words           the per-block scratch a band needs when its
//                            DP state does not fit in shared memory
//   replace nvbio_tpu/ops/wavefront_dp.py  _make_wavefront_kernel /
//   _wavefront_call (wavefront_score_pallas, wavefront_dirs_pallas).
//
// What it computes is the JAX twin cell for cell
// (nvbio_tpu/alignment/batched.py banded_score_batch, the plain version
// nvbio_tpu_torch/alignment/batched.py with twin=True): no score floor,
// GLOBAL reads the goal cell at the clipped band column, invalid cells
// (j < 0 or j > tlen) hold NEG_INF for H, F and Hhat while the E chain
// flows through the band's cells and is pinned to EMASK = NEG_INF - eo -
// ee at the band's low edge and left of column 0 (the value the twin's
// shift fill gives it there).  Sinks: SEMI_GLOBAL the max of row plen,
// lowest band column on ties; LOCAL the max over rows 1..plen, earliest
// row then lowest column (the twin's row-major scan); GLOBAL the cell at
// the clipped goal column of row plen.  Flags: the twin's encoding, bits
// 0-1 H source (diag, E, F; ties in that order; LOCAL H <= 0 origin),
// bit 2 E open, bit 3 F open; 3 on row 0 and on every cell not computed.
//
// Design.  The TPU kernel ran one alignment per grid program with the
// anti-diagonal across an (NR, 128) vector window that slid up the
// pattern, fed text symbols systolically and carried sinks across window
// rebases in SMEM scalars.  None of that is needed on the H100.  One
// block owns one alignment and loops over its diagonals d = r + j; the
// cells of a diagonal (rows r with |d - 2r| <= w, at most w + 1) lie
// across the block's threads, two neighbouring rows per thread-step so
// that a thread writes whole flag bytes.  Parametrised by the row, every
// dependence is a fixed row offset on an earlier diagonal:
//   H(r-1, j)   vertical, diagonal d-1, row r-1  (F: H and F)
//   H(r-1, j-1) diagonal, diagonal d-2, row r-1
//   E(r, j-1), Hhat(r, j-1)  horizontal, diagonal d-1, row r
// so the in-row E scan of the row-wise kernels disappears.  The state of
// the last diagonals lives in rings indexed by row (H for three
// diagonals, F, E and Hhat for two), in shared memory while 9 rings fit
// (band_w <= 4094), beyond that in per-block device scratch; one
// __syncthreads per diagonal.  Pattern symbol, quality and text symbol
// are read per cell through the read-only cache: neighbouring threads
// read neighbouring bytes.  Sinks are per-thread running bests, reduced
// over the block once at the end in the twin's tie order.  The score
// entry point visits only rows <= plen and columns <= tlen; the flag
// entry point visits rows <= Lp and writes every byte of its output.
//
// Matrix mode (MAT): the substitution is the twin's matrix gather
// (nvbio_tpu/alignment/batched.py:41-46), table[clip(p) * K + clip(t)]
// with p and t clipped to [0, K - 1], quality ignored.  The block stages
// the table (K <= MAX_MAT_K) in shared memory before its diagonal loop.
// MAT is a template parameter: the formula instantiations are unchanged.
//
// The matrix mode has two tiers; the wrapper (ops/wavefront_dp.py) picks
// one by shape.  Narrower bands take k5_kernel<..., MAT>.  Calls with
// band_w >= max(Lp, Lt) (every full_score_batch call: protein_sw) take
// k5_full_kernel: there every cell of rows 1..plen and columns 0..tlen
// lies in the band (x == w cannot happen for r >= 1, and x == -w only at
// j = 0, which left_out covers), so the DP is the full-matrix Gotoh and
// k5_kernel's rings, barriers and mostly idle threads (a 50 x 50 pair
// kept one warp of a 512-thread block busy) are not needed.  One warp
// owns one alignment: lane l holds FB_RPL consecutive pattern rows in
// registers (H, Hhat of the previous column and E, and each row's best
// H with its first column) and works column j at step j + l, taking H
// and F of the row above from lane l - 1 by a shuffle; no cell touches
// memory except its substitution, the table entry of its row's and its
// column's symbols from the block's shared copy (a lane-private query
// profile measured slower: its shared memory cost resident warps).
// Patterns past 32 * FB_RPL rows take passes:
// lane 31 leaves its last row's (H, F) a column in a per-warp boundary
// row in device scratch, read back 32 columns a load by the next pass.
// Warps take alignments from an atomic counter over a persistent grid
// of the blocks the card keeps resident, so the scratch follows the
// warps in flight.  The cell is k5_kernel's int32 expressions in DPX
// form (__viaddmax_s32, __viaddmax_s32_relu); the sinks keep the twin's
// tie order (a row's first column, then rows in order, then better()
// across lanes).  If tlens exceed Lt the band's upper edge can bind
// (tlen > band_w): such an alignment runs the sweep with k5_kernel's
// x == w mask.  What bounds it: ~10 int32 operations and a table load a
// cell, plus a step's shuffles, text load and guards shared by FB_RPL
// cells; the warps an SM its registers leave resident; lanes idle where
// plen is not a multiple of 32 * FB_RPL, and the 31-step skew of each
// pass.
//
// The formula score entry point has two tiers as well; the wrapper picks
// one by shape.  Calls with Lp <= 8192, at any band (every K5 call of
// sw_benchmark --long: 128 x 4000, band_w 2000), take k5_band_kernel;
// wider patterns, and the flag entry point, k5_kernel.  The band tier
// is fb_sweep's column sweep with the band's edges (bs_strip): one block
// an alignment, warp p on the strip of pattern rows 256 p + 1 ..
// 256 (p + 1), lane l on 8 of them in registers, one step behind lane
// l - 1.  Each lane sweeps only its rows' band columns (from row r0's
// entry column r0 - w to its last row + w), so out-of-band values, which
// the 8 rows of a lane produce on the 7 columns where some of them are
// outside the band, feed no in-band cell and no sink; rows enter the band
// on successive columns, where E and Hhat restart from k5_kernel's
// left_out values, and take NEG_INF from above at x == w.  The steps
// where no lane meets an edge run a body without those masks (at band_w
// 2000 ~85 % of a strip's ~4 290 steps).  E is kept as G = E + j * ee, so
// that E and H take one DPX operation each.  Strip p + 1 reads strip p's
// last row from a 512-column ring in shared memory while strip p writes
// it: each boundary has a published and a consumed column count, checked
// every 32 steps (the reader waits for 33 columns ahead, the writer for
// the slot it overwrites), so the strips run as a pipeline with no block
// barrier in the loop.  Sinks keep the twin's tie
// order: SEMI_GLOBAL and GLOBAL track only row plen (in the last strip),
// LOCAL every row's first maximum.  What bounds it: 7 int32 operations a
// cell in the body, plus ~45 a step (shuffles, text load, ring access,
// loop) shared by its 8 cells; the pipeline fill (strips start ~100 to
// ~320 steps apart, so an SM holds fewer than its 16 warps for a while)
// and the masked steps at each strip's ends, ~1.8 times a body step.
//
// What bounds the diagonal kernel on the H100: per cell about 30 int32
// operations and 9 shared-memory accesses behind one barrier per
// diagonal, with one block of up to 1024 threads per alignment; the
// parallelism is the cells of a diagonal times the alignments in flight.
// With flags, the (w + 1) / 2 bytes written per diagonal.

#include <limits.h>

#include <type_traits>

#include "gotoh_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
// dynamic shared memory a block takes for its rings at most
constexpr int SMEM_BYTES = 200 * 1024;
constexpr int N_RINGS = 9;
// largest substitution table of the matrix mode (K x K int32)
constexpr int MAX_MAT_K = 32;

__host__ __device__ inline int floor_div2(int x) {
  return x >= 0 ? x / 2 : -((1 - x) / 2);
}

// ring length: a power of two that holds the w + 1 rows of a diagonal
// (and the one row above them)
int ring_size(int band_w) {
  int m = 32;
  while (m < band_w + 2) m <<= 1;
  return m;
}

bool rings_in_smem(int band_w) {
  return static_cast<long long>(N_RINGS) * ring_size(band_w) * 4 <=
         SMEM_BYTES;
}

struct Best {
  int h, r, k;
};

// the twin's tie order: higher score, then earlier row, then lower column
__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  return a.h > b.h || (a.h == b.h && (a.r < b.r || (a.r == b.r && a.k < b.k)));
}

__device__ __forceinline__ Best shfl_best(const Best& v, int delta) {
  return Best{__shfl_down_sync(FULL, v.h, delta),
              __shfl_down_sync(FULL, v.r, delta),
              __shfl_down_sync(FULL, v.k, delta)};
}

template <int ATYPE, bool DIRS, bool MAT>
__global__ void __launch_bounds__(MAX_THREADS)
    k5_kernel(Args a, int32_t* scratch, int ring, int smem_rings,
              const int32_t* mat, int mat_k) {
  extern __shared__ int32_t rings_smem[];
  __shared__ Best warp_best[MAX_THREADS / 32];
  __shared__ int32_t mat_s[MAT ? MAX_MAT_K * MAX_MAT_K : 1];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if constexpr (MAT) {
    for (int i = tid; i < mat_k * mat_k; i += nt) mat_s[i] = __ldg(mat + i);
    __syncthreads();
  }
  int32_t* st = smem_rings
                    ? rings_smem
                    : scratch + static_cast<int64_t>(b) * N_RINGS * ring;
  // rings: H of diagonals d % 3 at [0, 3), then F, E, Hhat of
  // diagonals d % 2 at [3, 5), [5, 7), [7, 9) (in units of ring words)
  const int mask = ring - 1;

  const Scheme sc = a.sc;
  const int w = a.band_w, lp = a.lp, lt = a.lt;
  const int plen = a.plens[b], tlen = a.tlens[b];
  const int EMASK = NEG_INF - (sc.eo + sc.ee);
  const int8_t* pat = a.pats + static_cast<int64_t>(b) * lp;
  const uint8_t* qual = a.quals + static_cast<int64_t>(b) * lp;
  const int8_t* text = a.texts + static_cast<int64_t>(b) * lt;
  const int rmax = DIRS ? lp : max(min(plen, lp), 0);
  const int ndiag = DIRS ? lp + lt + 1 : max(rmax + tlen + 1, 0);
  const int npairs = (w + 2) / 2;
  uint8_t* dirs = DIRS ? a.dirs + static_cast<int64_t>(b) * ndiag * npairs
                       : nullptr;
  const int x_goal =
      min(max(tlen - plen + w, 0), 2 * w) - w;  // GLOBAL's clipped goal

  Best best = ATYPE == LOCAL ? Best{0, 0, w} : Best{NEG_INF, plen, 0};

  for (int d = 0; d < ndiag; ++d) {
    const int rlo = -floor_div2(w - d);  // ceil((d - w) / 2): slot 0
    const int r_min = max(max(rlo, d - tlen), 0);  // j <= tlen
    const int r_max = min(min(floor_div2(d + w), rmax), d);  // band, j >= 0
    int32_t* const Hd = st + (d % 3) * ring;
    const int32_t* const Hd1 = st + ((d + 2) % 3) * ring;
    const int32_t* const Hd2 = st + ((d + 1) % 3) * ring;
    const int cur = d & 1, prv = cur ^ 1;
    int32_t* const Fc = st + (3 + cur) * ring;
    int32_t* const Ec = st + (5 + cur) * ring;
    int32_t* const Hhc = st + (7 + cur) * ring;
    const int32_t* const Fp = st + (3 + prv) * ring;
    const int32_t* const Ep = st + (5 + prv) * ring;
    const int32_t* const Hhp = st + (7 + prv) * ring;
    int p_begin = 0, p_end = npairs;
    if (!DIRS) {
      p_begin = max(r_min - rlo, 0) >> 1;
      p_end = r_max >= r_min ? ((r_max - rlo) >> 1) + 1 : 0;
    }
    for (int p = p_begin + tid; p < p_end; p += nt) {
      int byte = 0x33;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = rlo + 2 * p + c;
        if (r < r_min || r > r_max) continue;
        const int j = d - r;
        const int x = j - r;
        const int ri = r & mask;
        if (r == 0) {  // the twin's initial row, inside the band
          Hd[ri] = ATYPE == GLOBAL ? (d == 0 ? 0 : -sc.eo - sc.ee * d) : 0;
          Fc[ri] = NEG_INF;
          Ec[ri] = EMASK;
          Hhc[ri] = NEG_INF;
          continue;
        }
        const int rm = (r - 1) & mask;
        const int H1 = x == w ? NEG_INF : Hd1[rm];
        const int F1 = x == w ? NEG_INF : Fp[rm];
        const int H2 = j == 0 ? NEG_INF : Hd2[rm];
        const bool left_out = x == -w || j == 0;
        const int E1 = left_out ? EMASK : Ep[ri];
        const int Hh1 = left_out ? NEG_INF : Hhp[ri];
        const int ps = __ldg(pat + r - 1);
        const int ts = (j >= 1 && j - 1 < lt) ? __ldg(text + j - 1)
                                              : PAD_SYMBOL;
        int s;
        if constexpr (MAT) {
          s = mat_s[min(max(ps, 0), mat_k - 1) * mat_k +
                    min(max(ts, 0), mat_k - 1)];
        } else {
          const int q = min(static_cast<int>(__ldg(qual + r - 1)), 40);
          const int mm =
              sc.mm_min + floor_div40((sc.mm_max - sc.mm_min) * q);
          s = (ps >= 4 || ts >= 4) ? -sc.n_penalty
                                   : (ps == ts ? sc.match : -mm);
        }
        const int f_open = H1 - (sc.fo + sc.fe);
        const int F = max(f_open, F1 - sc.fe);
        const int Hdiag = H2 + s;
        int Hhat = max(Hdiag, F);
        if (ATYPE == LOCAL) Hhat = max(Hhat, 0);
        const int e_open = Hh1 - (sc.eo + sc.ee);
        const int E = max(E1 - sc.ee, e_open);
        int H = max(Hhat, E);
        if (ATYPE == LOCAL) H = max(H, 0);
        Hd[ri] = H;
        Fc[ri] = F;
        Ec[ri] = E;
        Hhc[ri] = Hhat;
        if (DIRS) {
          int f = H == Hdiag ? 0 : (H == E ? 1 : 2);
          if (ATYPE == LOCAL && H <= 0) f = 3;
          f |= (E == e_open ? 4 : 0) | (F == f_open ? 8 : 0);
          byte = (byte & ~(0xf << (4 * c))) | (f << (4 * c));
        }
        if (ATYPE == GLOBAL) {
          if (r == plen && x == x_goal) best.h = H;
        } else if ((ATYPE == LOCAL ? r <= plen : r == plen) &&
                   better(Best{H, r, x + w}, best)) {
          best = Best{H, r, x + w};
        }
      }
      if (DIRS) dirs[static_cast<int64_t>(d) * npairs + p] =
          static_cast<uint8_t>(byte);
    }
    __syncthreads();
  }

  // block reduction of the sinks, in the twin's tie order
#pragma unroll
  for (int delta = 16; delta > 0; delta >>= 1) {
    const Best o = shfl_best(best, delta);
    if (better(o, best)) best = o;
  }
  if ((tid & 31) == 0) warp_best[tid >> 5] = best;
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < (nt + 31) / 32; ++i)
      if (better(warp_best[i], best)) best = warp_best[i];
    int p_end, t_end;
    if (ATYPE == GLOBAL) {
      p_end = plen;
      t_end = plen == 0 ? 0 : tlen;
    } else {
      p_end = best.r;
      t_end = max(best.r + best.k - w, 0);
    }
    a.out[b] = best.h;
    a.out[a.nb + b] = p_end;
    a.out[2 * a.nb + b] = t_end;
  }
}

template <int ATYPE, bool DIRS, bool MAT>
cudaError_t launch_one(const Args& a, int32_t* scratch, const int32_t* mat,
                       int mat_k, cudaStream_t stream) {
  const int ring = ring_size(a.band_w);
  const int smem = rings_in_smem(a.band_w) ? N_RINGS * ring * 4 : 0;
  const int npairs = (a.band_w + 2) / 2;
  const int nt = min(MAX_THREADS, (npairs + 31) / 32 * 32);
  cudaError_t err = cudaFuncSetAttribute(
      k5_kernel<ATYPE, DIRS, MAT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  k5_kernel<ATYPE, DIRS, MAT><<<a.nb, nt, smem, stream>>>(
      a, scratch, ring, smem > 0, mat, mat_k);
  return cudaGetLastError();
}

template <bool DIRS, bool MAT>
cudaError_t launch(const Args& a, int atype, int32_t* scratch,
                   const int32_t* mat, int mat_k, cudaStream_t stream) {
  if (a.nb == 0) return cudaSuccess;
  switch (atype) {
    case GLOBAL:
      return launch_one<GLOBAL, DIRS, MAT>(a, scratch, mat, mat_k, stream);
    case SEMI_GLOBAL:
      return launch_one<SEMI_GLOBAL, DIRS, MAT>(a, scratch, mat, mat_k,
                                                stream);
    case LOCAL:
      return launch_one<LOCAL, DIRS, MAT>(a, scratch, mat, mat_k, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

Args k5_args(const void* pats, const void* quals, const void* plens,
             const void* texts, const void* tlens, int nb, int lp, int lt,
             int band_w, int match, int mm_min, int mm_max, int n_penalty,
             int eo, int ee, int fo, int fe, void* out) {
  Args a = make_args(pats, quals, plens, tlens, nb, lp, band_w, match, mm_min,
                     mm_max, n_penalty, eo, ee, fo, fe, out);
  a.texts = static_cast<const int8_t*>(texts);
  a.lt = lt;
  return a;
}

// ---------------------------------------------------------------------------
// The matrix mode's full-band tier (k5_full_score_matrix): one warp an
// alignment sweeping text columns, for calls with band_w >= max(Lp, Lt).

// pattern rows a lane holds in registers, and rows a warp sweeps a pass
// (on an H100, protein_sw's 131 072-pair batch took 40.3 ms at 4 rows,
// 38.0 at 6, 37.4 at 8 and 37.0 at 12: PERF.md)
constexpr int FB_RPL = 8;
constexpr int FB_ROWS = 32 * FB_RPL;
// warps (alignments in flight) a block
constexpr int FB_WARPS = 4;
// scratch words ahead of the boundary rows: the alignment counter
constexpr int FB_COUNTER_WORDS = 4;

// columns of a warp's boundary row: a pass ends at column
// min(tlen, its last row + w) (tlen alone when tlen <= w), so lp + w + 1
// hold every column any call reaches
long long fb_cols(int lp, int band_w) {
  return static_cast<long long>(lp) + band_w + 1;
}

__device__ __forceinline__ int fb_text_symbol(const int8_t* text, int lt,
                                              int j) {
  return (j >= 1 && j - 1 < lt) ? __ldg(text + j - 1) : PAD_SYMBOL;
}

// One alignment on one warp; returns its sink (reduced to lane 0) in the
// twin's tie order.  Lane l holds rows r0 .. r0 + FB_RPL - 1 (r0 = base +
// l * FB_RPL + 1) of the pass at rows base + 1 ..: their H, Hhat and E of
// the previous column and, for the sinks, each row's best H and its first
// column.  At step s the lane works column j = s - l: H and F of the row
// above its first row come from lane l - 1 (its last row, the step
// before), for lane 0 from row 0 (the first pass) or from the boundary
// row the pass above left in ``bound`` (32 columns a load, shuffled out).
// EDGE (tlen > band_w: the band's upper edge binds, as it can only when
// tlens exceed Lt) masks the vertical input at j - r == w, as k5_kernel's
// x == w does, and keeps cells past it out of the sinks.
template <int ATYPE, bool EDGE>
__device__ __forceinline__ Best fb_sweep(const Args& a, int b,
                                         const int32_t* mat_s, int mat_k,
                                         int2* bound, int lane) {
  const Scheme sc = a.sc;
  const int w = a.band_w, lp = a.lp, lt = a.lt;
  const int plen = a.plens[b], tlen = a.tlens[b];
  const int R = max(min(plen, lp), 0);
  const int EMASK = NEG_INF - (sc.eo + sc.ee);
  const int foe = sc.fo + sc.fe, eoe = sc.eo + sc.ee;
  const int8_t* pat = a.pats + static_cast<int64_t>(b) * lp;
  const int8_t* text = a.texts + static_cast<int64_t>(b) * lt;
  Best best = ATYPE == LOCAL ? Best{0, 0, w} : Best{NEG_INF, plen, 0};

  for (int base = 0; tlen >= 0 && base < R; base += FB_ROWS) {
    const int rows = min(R - base, FB_ROWS);
    const int nl = (rows + FB_RPL - 1) / FB_RPL;  // lanes with a row
    const bool more = base + FB_ROWS < R;         // a pass follows
    const int jmax = EDGE ? min(tlen, base + rows + w) : tlen;
    const int r0 = base + lane * FB_RPL + 1;
    int pb[FB_RPL];  // clipped row symbol * K: the row's table entries
#pragma unroll
    for (int i = 0; i < FB_RPL; ++i) {
      const int r = r0 + i;
      const int p = r <= R ? __ldg(pat + r - 1) : 0;
      pb[i] = min(max(p, 0), mat_k - 1) * mat_k;
    }
    int Hp[FB_RPL], Hh[FB_RPL], Ev[FB_RPL], bh[FB_RPL], bj[FB_RPL];
#pragma unroll
    for (int i = 0; i < FB_RPL; ++i) {  // column -1 (k5_kernel's left_out)
      Hp[i] = NEG_INF;
      Hh[i] = NEG_INF;
      Ev[i] = EMASK;
      bh[i] = ATYPE == LOCAL ? 0 : NEG_INF;
      bj[i] = 0;
    }
    int out_h = NEG_INF, out_f = NEG_INF;  // the last row's H, F
    int up_prev = NEG_INF;  // H(r0 - 1, j - 1): the first row's diagonal
    // the boundary row above, 32 columns a load: cur serves steps s & ~31
    int cur_h = NEG_INF, cur_f = NEG_INF, nxt_h = NEG_INF, nxt_f = NEG_INF;
    if (base > 0 && lane <= jmax) {
      const int2 v = bound[lane];
      nxt_h = v.x;
      nxt_f = v.y;
    }
    int tsym = PAD_SYMBOL;  // the text symbol of the lane's next column
    const int nsteps = jmax + nl;
    for (int s = 0; s < nsteps; ++s) {
      const int j = s - lane;
      int up_h = __shfl_up_sync(FULL, out_h, 1);
      int up_f = __shfl_up_sync(FULL, out_f, 1);
      if (base > 0) {
        if ((s & 31) == 0) {
          cur_h = nxt_h;
          cur_f = nxt_f;
          const int c = s + 32 + lane;
          if (c <= jmax) {
            const int2 v = bound[c];
            nxt_h = v.x;
            nxt_f = v.y;
          }
        }
        const int bh0 = __shfl_sync(FULL, cur_h, s & 31);
        const int bf0 = __shfl_sync(FULL, cur_f, s & 31);
        if (lane == 0) {
          up_h = bh0;
          up_f = bf0;
        }
      } else if (lane == 0) {  // the twin's initial row
        up_h = ATYPE == GLOBAL ? (s == 0 ? 0 : -sc.eo - sc.ee * s) : 0;
        up_f = NEG_INF;
      }
      const int ts = tsym;
      tsym = fb_text_symbol(text, lt, j + 1);
      if (lane < nl && j >= 0 && j <= jmax) {
        const int tc = min(max(ts, 0), mat_k - 1);
        int sub[FB_RPL];
#pragma unroll
        for (int i = 0; i < FB_RPL; ++i) sub[i] = mat_s[pb[i] + tc];
        int diag = up_prev;
        up_prev = up_h;
#pragma unroll
        for (int i = 0; i < FB_RPL; ++i) {
          if (EDGE && j == r0 + i + w) {
            up_h = NEG_INF;
            up_f = NEG_INF;
          }
          // k5_kernel's expressions: F, Hhat (LOCAL floor), E, H
          const int F = __viaddmax_s32(up_h, -foe, up_f - sc.fe);
          const int hhat = ATYPE == LOCAL
                               ? __viaddmax_s32_relu(diag, sub[i], F)
                               : __viaddmax_s32(diag, sub[i], F);
          const int E = __viaddmax_s32(Ev[i], -sc.ee, Hh[i] - eoe);
          const int H = max(hhat, E);  // LOCAL: hhat >= 0 already
          diag = Hp[i];
          Hp[i] = H;
          Hh[i] = hhat;
          Ev[i] = E;
          if (ATYPE != GLOBAL && H > bh[i] && (!EDGE || j <= r0 + i + w)) {
            bh[i] = H;
            bj[i] = j;
          }
          up_h = H;
          up_f = F;
        }
        out_h = up_h;
        out_f = up_f;
        if (more && lane == 31) bound[j] = make_int2(up_h, up_f);
      }
    }
    if (ATYPE == GLOBAL) {  // H(plen, tlen): the last column's H of row R
      if (!more && plen == R) {
#pragma unroll
        for (int i = 0; i < FB_RPL; ++i)
          if (r0 + i == R) best.h = Hp[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < FB_RPL; ++i) {
        const int r = r0 + i;
        if (r <= R && (ATYPE == LOCAL || r == plen)) {
          const Best c{bh[i], r, bj[i] - r + w};
          if (better(c, best)) best = c;
        }
      }
    }
    __syncwarp();  // the boundary row is complete before the next pass
  }
#pragma unroll
  for (int delta = 16; delta > 0; delta >>= 1) {
    const Best o = shfl_best(best, delta);
    if (better(o, best)) best = o;
  }
  return best;
}

// A persistent grid: each warp takes alignments from the counter at
// scratch[0] until the batch is done, with its boundary row (cols int2)
// after the counter words.
template <int ATYPE>
__global__ void __launch_bounds__(FB_WARPS * 32)
    k5_full_kernel(Args a, const int32_t* mat, int mat_k, int32_t* scratch,
                   long long cols) {
  __shared__ int32_t mat_s[MAX_MAT_K * MAX_MAT_K];
  for (int i = threadIdx.x; i < mat_k * mat_k; i += blockDim.x)
    mat_s[i] = __ldg(mat + i);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2* const bound = reinterpret_cast<int2*>(scratch + FB_COUNTER_WORDS) +
                      (static_cast<long long>(blockIdx.x) * FB_WARPS + warp) *
                          cols;
  const int w = a.band_w;
  for (;;) {
    int b = 0;
    if (lane == 0) b = atomicAdd(scratch, 1);
    b = __shfl_sync(FULL, b, 0);
    if (b >= a.nb) return;
    const int plen = a.plens[b], tlen = a.tlens[b];
    const Best best =
        tlen > w ? fb_sweep<ATYPE, true>(a, b, mat_s, mat_k, bound, lane)
                 : fb_sweep<ATYPE, false>(a, b, mat_s, mat_k, bound, lane);
    if (lane == 0) {  // k5_kernel's output rules
      int p_end, t_end;
      if (ATYPE == GLOBAL) {
        p_end = plen;
        t_end = plen == 0 ? 0 : tlen;
      } else {
        p_end = best.r;
        t_end = max(best.r + best.k - w, 0);
      }
      a.out[b] = best.h;
      a.out[a.nb + b] = p_end;
      a.out[2 * a.nb + b] = t_end;
    }
  }
}

// blocks of the tier's kernel an SM keeps resident
cudaError_t fb_blocks_per_sm(int atype, int* per_sm) {
  switch (atype) {
    case GLOBAL:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, k5_full_kernel<GLOBAL>, FB_WARPS * 32, 0);
    case SEMI_GLOBAL:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, k5_full_kernel<SEMI_GLOBAL>, FB_WARPS * 32, 0);
    case LOCAL:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, k5_full_kernel<LOCAL>, FB_WARPS * 32, 0);
    default:
      return cudaErrorInvalidValue;
  }
}

// the persistent grid: the blocks the card keeps resident, never more
// than the batch fills
cudaError_t fb_grid(int nb, int atype, int* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = fb_blocks_per_sm(atype, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = min(max(per_sm, 1) * sms, (nb + FB_WARPS - 1) / FB_WARPS);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The formula score entry point's banded column-sweep tier (k5_band_score):
// one block an alignment, warp p sweeping the text's columns over the
// pattern rows of strip p (BS_ROWS rows, BS_RPL a lane), the strips
// pipelined through boundary rings in shared memory.

constexpr int BS_RPL = 8;
constexpr int BS_ROWS = 32 * BS_RPL;
// strips (warps) an alignment at most: Lp <= BS_MAX_WARPS * BS_ROWS
constexpr int BS_MAX_WARPS = 32;
// columns of the ring between two strips (a power of two); the reader
// waits for 33 columns ahead and the writer for the slot it overwrites,
// so any size above 64 is free of deadlock
constexpr int BS_RING = 512;

// one alignment's inputs and the constants of its cells
struct BsCtx {
  const int8_t* pat;
  const uint8_t* qual;
  const int8_t* text;
  int lt, w, plen, tlen, R;
  Scheme sc;
};

// (a wait of ~seconds means a fault in the protocol: trap, so that the
// launch fails instead of hanging the card)
__device__ __forceinline__ void bs_wait(const volatile int* c, int need) {
  for (int n = 0; *c < need; ++n) {
    if (n == (1 << 26)) __trap();
    __nanosleep(32);
  }
  __threadfence_block();
}

__device__ __forceinline__ void bs_publish(volatile int* c, int v, bool me) {
  __syncwarp();
  __threadfence_block();
  if (me) *c = v;
}

// One strip: rows base + 1 .. base + rows (base = strip * BS_ROWS) on one
// warp.  Lane l holds rows r0 .. r0 + 7 (r0 = base + 8 l + 1) and works
// column j = jbase + s - l at step s; it computes only the columns of its
// rows' band, lo .. hi, so an out-of-band value (a row left of its entry
// column or right of its last) feeds no in-band cell and no sink, and no
// chain runs for more than 2 w + 8 columns.  Per row it keeps H and Hhat
// of the previous column and G = E + j * ee, so that E and H cost one
// DPX operation each: G(j) = max(Hhat(j-1) + j ee - (eo + ee), G(j-1)),
// H = max(G - j ee, Hhat).  k5_kernel's band masks, x = j - r: at x == -w
// (and j == 0) E restarts from left_out's EMASK and Hhat NEG_INF; at x == w
// the vertical input is NEG_INF.  The steps where no lane meets a mask,
// a window edge or column 0 (all but ~2 * 290 of ~2 w + 290 a strip) run
// a body without them.  Lane 0 takes the row above the strip from row 0
// (strip 0) or from ring ``in``, which strip - 1's lane 31 fills; this
// strip's lane 31 fills ``out``.  The strips run concurrently, each on
// its own warp, with cnt = {prod, cons} of each boundary: a writer
// publishes the columns it has written every 32 steps and waits for the
// slot it overwrites, a reader waits for the columns it will read and
// publishes those it has read.
// Sinks (SINK): LOCAL every row's first maximum (rows folded by better()),
// SEMI_GLOBAL row plen's first maximum, GLOBAL row plen at the clipped
// goal column (into *goal).
template <int ATYPE, bool SINK>
__device__ __forceinline__ void bs_strip(const BsCtx& c, int strip, int lane,
                                         const int2* in, int2* out,
                                         volatile int* cnt, Best& best,
                                         int* goal) {
  constexpr int rmask = BS_RING - 1;
  const Scheme sc = c.sc;
  const int w = c.w, R = c.R, tlen = c.tlen, lt = c.lt;
  const int base = strip * BS_ROWS;
  const int rows = min(R - base, BS_ROWS);
  const bool more = base + BS_ROWS < R;
  const int nl = (rows + BS_RPL - 1) / BS_RPL;  // lanes with a row
  const int r0 = base + lane * BS_RPL + 1;
  const bool has_rows = lane < nl;
  const int lo = max(0, r0 - w);
  const int hi = min(tlen, min(r0 + BS_RPL - 1, R) + w);
  const int j0 = max(0, base + 1 - w);          // lane 0's first column
  const int jmax = min(tlen, base + rows + w);  // the last lane's last
  const int jbase = j0 - 1;  // lane 0's column at step 0, which only fetches
  const int nsteps = jmax < j0 ? 0 : jmax - jbase + nl;
  // the body: steps at which every lane with a row has all its rows in the
  // band, past their entry column and column 0, short of the x == w edge
  const int sb = max(base + (nl - 1) * BS_RPL + 1 + BS_RPL - w, 1) - jbase +
                 nl - 1;
  const int se = max(min(tlen, base + w) - jbase + 1, sb);
  const int EMASK = NEG_INF - (sc.eo + sc.ee);
  const int eoe = sc.eo + sc.ee, foe = sc.fo + sc.fe;
  const int EENTRY = max(EMASK - sc.ee, NEG_INF - eoe);
  const int FEDGE = max(NEG_INF - foe, NEG_INF - sc.fe);
  volatile int* const in_prod = cnt + 2 * max(strip - 1, 0);  // strip > 0
  volatile int* const in_cons = in_prod + 1;
  volatile int* const out_prod = cnt + 2 * strip;  // more only
  volatile int* const out_cons = out_prod + 1;
  const int fin_in = min(tlen, base + w) + 1;  // strip - 1 writes below it

  int P[BS_RPL], mis[BS_RPL], Hp[BS_RPL], Hh[BS_RPL], G[BS_RPL];
#pragma unroll
  for (int i = 0; i < BS_RPL; ++i) {
    const int r = r0 + i;
    int p = 0, mm = 0;
    if (r <= R) {
      p = __ldg(c.pat + r - 1);
      const int q = min(static_cast<int>(__ldg(c.qual + r - 1)), 40);
      mm = sc.mm_min + floor_div40((sc.mm_max - sc.mm_min) * q);
    }
    P[i] = p;
    mis[i] = p >= 4 ? -sc.n_penalty : -mm;
    Hp[i] = NEG_INF;
    Hh[i] = NEG_INF;
    G[i] = EMASK;
  }
  int bh[ATYPE == LOCAL ? BS_RPL : 1], bj[ATYPE == LOCAL ? BS_RPL : 1];
#pragma unroll
  for (int i = 0; i < (ATYPE == LOCAL ? BS_RPL : 1); ++i) {
    bh[i] = 0;
    bj[i] = 0;
  }
  int sbh = NEG_INF, sbj = 0;  // SEMI_GLOBAL: row plen's first maximum
  const int ip = (c.plen - 1) & (BS_RPL - 1);     // row plen's slot
  const int lsink = (c.plen - 1 - base) / BS_RPL;  // and lane
  const int jgoal =
      c.plen + min(max(tlen - c.plen + w, 0), 2 * w) - w;  // GLOBAL
  int oh = NEG_INF, of = NEG_INF;  // the lane's last row's H and F
  int up_prev = NEG_INF;  // the vertical input of the step before
  int tcur;               // the text symbol of the step's column
  {
    const int j = jbase - lane;
    tcur = (j >= 1 && j - 1 < lt) ? __ldg(c.text + j - 1) : PAD_SYMBOL;
  }
  // lane 0's row above at column jj
  auto boundary = [&](int jj) -> int2 {
    if (strip == 0)
      return make_int2(jj < 0 ? NEG_INF
                              : (ATYPE == GLOBAL && jj > 0 ? -sc.eo - sc.ee * jj
                                                           : 0),
                       NEG_INF);
    return jj < 0 ? make_int2(NEG_INF, NEG_INF) : in[jj & rmask];
  };
  int2 bcur = make_int2(NEG_INF, NEG_INF);
  // j * ee - (eo + ee) and -j * ee of the step's column, carried from step
  // to step (opaque to the compiler, which would otherwise fold -j * ee
  // into an IMAD and split H's DPX operation in two)
  int cj = (jbase - 1 - lane) * sc.ee - eoe;
  int mj = -(jbase - 1 - lane) * sc.ee;

  auto step = [&](int s, auto masked_tag) {
    constexpr bool MASKED = decltype(masked_tag)::value;
    const int j = jbase + s - lane;
    cj += sc.ee;
    mj -= sc.ee;
    asm volatile("" : "+r"(cj), "+r"(mj));
    int uh = __shfl_up_sync(FULL, oh, 1);
    int uf = __shfl_up_sync(FULL, of, 1);
    if (lane == 0) {
      uh = bcur.x;
      uf = bcur.y;
    }
    int diag = up_prev;
    up_prev = uh;
    const int ts = tcur;
    // 0 <= j < lt (lanes without a row can be left of column 0)
    tcur = static_cast<unsigned>(j) < static_cast<unsigned>(lt)
               ? __ldg(c.text + j)
               : PAD_SYMBOL;
    if (MASKED) {
      if (strip == 0 || lane == 0) bcur = boundary(jbase + s + 1);
    } else {  // column jbase + s + 1 >= 2; strip 0 has no ring (a block
              // of one warp has no shared memory for it)
      const int jj = jbase + s + 1;
      if (strip > 0)
        bcur = in[jj & rmask];  // every lane: one broadcast, no branch
      else
        bcur = make_int2(ATYPE == GLOBAL ? -sc.eo - sc.ee * jj : 0, NEG_INF);
    }
    if (MASKED && !(has_rows && j >= lo && j <= hi)) return;
    const bool tn = ts >= 4;
    const int mv = tn ? -sc.n_penalty : sc.match;
    int xa = 0, xc = 0, gent = 0;
    if (MASKED) {
      xa = j - r0 + w;  // row i is at x == -w when xa == i
      xc = j - r0 - w;  // and at x == w when xc == i
      gent = EENTRY - mj;
      if (j == 0) diag = NEG_INF;
    }
    int hs = NEG_INF;
    bool hs_in = !MASKED;
#pragma unroll
    for (int i = 0; i < BS_RPL; ++i) {
      int F = __viaddmax_s32(uh, -foe, uf - sc.fe);
      if (MASKED && xc == i) F = FEDGE;
      const int sub = (P[i] == ts || tn) ? mv : mis[i];
      const int hh = ATYPE == LOCAL ? __viaddmax_s32_relu(diag, sub, F)
                                    : __viaddmax_s32(diag, sub, F);
      int g = __viaddmax_s32(Hh[i], cj, G[i]);
      if (MASKED && (xa == i || j == 0)) g = gent;
      const int H = __viaddmax_s32(g, mj, hh);  // LOCAL: hh >= 0 already
      diag = Hp[i];
      Hp[i] = H;
      Hh[i] = hh;
      G[i] = g;
      if constexpr (SINK) {
        const bool inb = !MASKED || (xa >= i && xc <= i);
        if constexpr (ATYPE == LOCAL) {
          if (inb && H > bh[i]) {
            bh[i] = H;
            bj[i] = j;
          }
        } else if (i == ip) {
          hs = H;
          hs_in = inb;
        }
      }
      uh = H;
      uf = F;
    }
    oh = uh;
    of = uf;
    if constexpr (SINK && ATYPE != LOCAL) {
      if (lane == lsink) {
        if (ATYPE == GLOBAL) {
          if (j == jgoal) *goal = hs;
        } else if (hs_in && hs > sbh) {
          sbh = hs;
          sbj = j;
        }
      }
    }
    if (more && lane == 31) out[j & rmask] = make_int2(oh, of);
  };

  for (int s = 0; s < nsteps;) {  // chunks of 32 steps
    if (strip > 0) {
      bs_publish(in_cons, jbase + s, lane == 0);
      bs_wait(in_prod, min(jbase + s + 33, fin_in));
    }
    if (more) {
      bs_publish(out_prod, jbase + s - 31, lane == 31);
      bs_wait(out_cons, jbase + s - rmask);
    }
    if (s == 0 && lane == 0) bcur = boundary(jbase);
    const int e = min(s + 32, nsteps);
    if (s >= sb && e <= se) {
      for (; s < e; ++s) step(s, std::false_type{});
    } else {
      for (; s < e; ++s) step(s, std::true_type{});
    }
  }
  if (strip > 0) bs_publish(in_cons, INT_MAX, lane == 0);
  if (more) bs_publish(out_prod, INT_MAX, lane == 31);
  if constexpr (SINK) {
    if constexpr (ATYPE == LOCAL) {
#pragma unroll
      for (int i = 0; i < BS_RPL; ++i) {
        const int r = r0 + i;
        const Best cand{bh[i], r, bj[i] - r + w};
        if (has_rows && r <= R && better(cand, best)) best = cand;
      }
    } else if (ATYPE == SEMI_GLOBAL) {
      const Best cand{sbh, c.plen, sbj - c.plen + w};
      if (lane == lsink && sbh > NEG_INF && better(cand, best)) best = cand;
    }
  }
}

// One block an alignment, warp p on strip p, blockDim = 32 * ceil(Lp /
// BS_ROWS) (MAXW warps at most), (warps - 1) rings of BS_RING int2 in
// dynamic shared memory.  Warps past the alignment's strips idle to the
// final reduction.
template <int ATYPE, int MAXW>
__global__ void __launch_bounds__(MAXW * 32) k5_band_kernel(Args a) {
  extern __shared__ int2 bs_rings[];
  __shared__ int cnt[2 * BS_MAX_WARPS];
  __shared__ Best wbest[BS_MAX_WARPS];
  __shared__ int goal;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int plen = a.plens[b];
  const BsCtx c{a.pats + static_cast<int64_t>(b) * a.lp,
                a.quals + static_cast<int64_t>(b) * a.lp,
                a.texts + static_cast<int64_t>(b) * a.lt,
                a.lt, a.band_w, plen, a.tlens[b], max(min(plen, a.lp), 0),
                a.sc};
  if (lane == 0) {  // boundary warp: nothing published, nothing read
    cnt[2 * warp] = INT_MIN;
    cnt[2 * warp + 1] = max(0, (warp + 1) * BS_ROWS + 1 - c.w) - 1;
  }
  if (threadIdx.x == 0) goal = NEG_INF;
  __syncthreads();
  Best best = ATYPE == LOCAL ? Best{0, 0, c.w} : Best{NEG_INF, plen, 0};
  const int nstrips = (c.R + BS_ROWS - 1) / BS_ROWS;
  if (warp < nstrips) {
    const int2* in = bs_rings + max(warp - 1, 0) * BS_RING;  // not warp 0's
    int2* out = bs_rings + warp * BS_RING;  // unused for the last strip
    if (ATYPE == LOCAL || (warp == nstrips - 1 && c.plen == c.R))
      bs_strip<ATYPE, true>(c, warp, lane, in, out, cnt, best, &goal);
    else
      bs_strip<ATYPE, false>(c, warp, lane, in, out, cnt, best, &goal);
  }
#pragma unroll
  for (int delta = 16; delta > 0; delta >>= 1) {
    const Best o = shfl_best(best, delta);
    if (better(o, best)) best = o;
  }
  if (lane == 0) wbest[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < nw; ++i)
      if (better(wbest[i], best)) best = wbest[i];
    if (ATYPE == GLOBAL) {  // k5_kernel's output rules
      a.out[b] = goal;
      a.out[a.nb + b] = plen;
      a.out[2 * a.nb + b] = plen == 0 ? 0 : c.tlen;
    } else {
      a.out[b] = best.h;
      a.out[a.nb + b] = best.r;
      a.out[2 * a.nb + b] = max(best.r + best.k - c.w, 0);
    }
  }
}

int bs_warps(int lp) { return (lp + BS_ROWS - 1) / BS_ROWS; }

int bs_smem(int nw) { return (nw - 1) * BS_RING * sizeof(int2); }

// the kernel for nw warps a block (<= 16: up to 128 registers a thread)
// with its dynamic shared memory allowed; with per_sm, the blocks an SM
// keeps resident instead of a launch
template <int ATYPE, int MAXW>
cudaError_t bs_launch_one(const Args& a, int nw, cudaStream_t st,
                          int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      k5_band_kernel<ATYPE, MAXW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bs_smem(nw));
  if (err != cudaSuccess) return err;
  if (per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, k5_band_kernel<ATYPE, MAXW>, nw * 32, bs_smem(nw));
  k5_band_kernel<ATYPE, MAXW><<<a.nb, nw * 32, bs_smem(nw), st>>>(a);
  return cudaGetLastError();
}

template <int ATYPE>
cudaError_t bs_launch(const Args& a, int nw, cudaStream_t st,
                      int* per_sm = nullptr) {
  return nw <= 16
             ? bs_launch_one<ATYPE, 16>(a, nw, st, per_sm)
             : bs_launch_one<ATYPE, BS_MAX_WARPS>(a, nw, st, per_sm);
}

cudaError_t bs_dispatch(const Args& a, int atype, int nw, cudaStream_t st,
                        int* per_sm = nullptr) {
  switch (atype) {
    case GLOBAL:
      return bs_launch<GLOBAL>(a, nw, st, per_sm);
    case SEMI_GLOBAL:
      return bs_launch<SEMI_GLOBAL>(a, nw, st, per_sm);
    case LOCAL:
      return bs_launch<LOCAL>(a, nw, st, per_sm);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// int32 words of device scratch one block needs at this band: 0 when its
// rings fit in shared memory.
int k5_state_words(int band_w) {
  return rings_in_smem(band_w) ? 0 : N_RINGS * ring_size(band_w);
}

// All pointers are device pointers; out is (3, nb) int32; scratch holds
// nb * k5_state_words(band_w) int32 words (unused when that is 0).
// Returns the cudaError_t of the launch (0 on success).
int k5_wavefront_score(const void* pats, const void* quals, const void* plens,
                       const void* texts, const void* tlens, int nb, int lp,
                       int lt, int band_w, int atype, int match, int mm_min,
                       int mm_max, int n_penalty, int eo, int ee, int fo,
                       int fe, void* scratch, void* out, void* stream) {
  const Args a = k5_args(pats, quals, plens, texts, tlens, nb, lp, lt, band_w,
                         match, mm_min, mm_max, n_penalty, eo, ee, fo, fe,
                         out);
  return static_cast<int>(launch<false, false>(
      a, atype, static_cast<int32_t*>(scratch), nullptr, 0,
      static_cast<cudaStream_t>(stream)));
}

// As k5_wavefront_score with the substitution from mat, a (mat_k, mat_k)
// int32 device table (1 <= mat_k <= 32), instead of match/mismatch/N and
// quality (no quals pointer).
int k5_wavefront_score_matrix(const void* pats, const void* plens,
                              const void* texts, const void* tlens, int nb,
                              int lp, int lt, int band_w, int atype, int eo,
                              int ee, int fo, int fe, const void* mat,
                              int mat_k, void* scratch, void* out,
                              void* stream) {
  if (mat_k < 1 || mat_k > MAX_MAT_K) return cudaErrorInvalidValue;
  const Args a = k5_args(pats, nullptr, plens, texts, tlens, nb, lp, lt,
                         band_w, 0, 0, 0, 0, eo, ee, fo, fe, out);
  return static_cast<int>(launch<false, true>(
      a, atype, static_cast<int32_t*>(scratch),
      static_cast<const int32_t*>(mat), mat_k,
      static_cast<cudaStream_t>(stream)));
}

// int32 words of device scratch k5_full_score_matrix needs for this
// call: the alignment counter and one boundary row (lp + band_w + 1
// (H, F) pairs) for each warp of its persistent grid, so the size follows
// the warps the card keeps in flight, not the batch.  Call it on the
// launch's device; -1 on a CUDA error.
long long k5_full_scratch_words(int nb, int lp, int band_w, int atype) {
  int blocks = 0;
  if (fb_grid(nb, atype, &blocks) != cudaSuccess) return -1;
  return FB_COUNTER_WORDS +
         2LL * blocks * FB_WARPS * fb_cols(lp, band_w);
}

// Warps of the full-band kernel an SM keeps resident; -1 on a CUDA
// error.
int k5_full_warps_per_sm(int atype) {
  int per_sm = 0;
  if (fb_blocks_per_sm(atype, &per_sm) != cudaSuccess) return -1;
  return per_sm * FB_WARPS;
}

// k5_wavefront_score_matrix's function for band_w >= max(lp, lt), where
// no band edge binds within the text: one warp an alignment sweeping the
// text's columns.  The same arguments; scratch holds
// k5_full_scratch_words(nb, lp, band_w, atype) int32 words.
int k5_full_score_matrix(const void* pats, const void* plens,
                         const void* texts, const void* tlens, int nb, int lp,
                         int lt, int band_w, int atype, int eo, int ee,
                         int fo, int fe, const void* mat, int mat_k,
                         void* scratch, void* out, void* stream) {
  if (mat_k < 1 || mat_k > MAX_MAT_K || band_w < max(lp, lt))
    return cudaErrorInvalidValue;
  if (nb == 0) return cudaSuccess;
  const Args a = k5_args(pats, nullptr, plens, texts, tlens, nb, lp, lt,
                         band_w, 0, 0, 0, 0, eo, ee, fo, fe, out);
  int blocks = 0;
  cudaError_t err = fb_grid(nb, atype, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  int32_t* const sc = static_cast<int32_t*>(scratch);
  err = cudaMemsetAsync(sc, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int32_t* m = static_cast<const int32_t*>(mat);
  const long long cols = fb_cols(lp, band_w);
  switch (atype) {
    case GLOBAL:
      k5_full_kernel<GLOBAL><<<blocks, FB_WARPS * 32, 0, st>>>(
          a, m, mat_k, sc, cols);
      break;
    case SEMI_GLOBAL:
      k5_full_kernel<SEMI_GLOBAL><<<blocks, FB_WARPS * 32, 0, st>>>(
          a, m, mat_k, sc, cols);
      break;
    case LOCAL:
      k5_full_kernel<LOCAL><<<blocks, FB_WARPS * 32, 0, st>>>(
          a, m, mat_k, sc, cols);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// k5_wavefront_score's function on the banded column-sweep tier (one
// block an alignment, a warp a 256-row strip): the same arguments less the
// scratch, lp <= 32 * 256.
int k5_band_score(const void* pats, const void* quals, const void* plens,
                  const void* texts, const void* tlens, int nb, int lp,
                  int lt, int band_w, int atype, int match, int mm_min,
                  int mm_max, int n_penalty, int eo, int ee, int fo, int fe,
                  void* out, void* stream) {
  if (lp < 1 || lp > BS_MAX_WARPS * BS_ROWS) return cudaErrorInvalidValue;
  if (nb == 0) return cudaSuccess;
  const Args a = k5_args(pats, quals, plens, texts, tlens, nb, lp, lt, band_w,
                         match, mm_min, mm_max, n_penalty, eo, ee, fo, fe,
                         out);
  return static_cast<int>(bs_dispatch(a, atype, bs_warps(lp),
                                      static_cast<cudaStream_t>(stream)));
}

// Warps of the banded tier's kernel an SM keeps resident at this Lp (its
// block has ceil(lp / 256) warps); -1 on a CUDA error.
int k5_band_warps_per_sm(int atype, int lp) {
  if (lp < 1 || lp > BS_MAX_WARPS * BS_ROWS) return -1;
  int per_sm = 0;
  const Args a = {};
  const int nw = bs_warps(lp);
  return bs_dispatch(a, atype, nw, nullptr, &per_sm) == cudaSuccess
             ? per_sm * nw
             : -1;
}

// As k5_wavefront_score, plus dirs: (nb, lp + lt + 1, (band_w + 2) / 2)
// uint8, every byte written.
int k5_wavefront_directions(const void* pats, const void* quals,
                            const void* plens, const void* texts,
                            const void* tlens, int nb, int lp, int lt,
                            int band_w, int atype, int match, int mm_min,
                            int mm_max, int n_penalty, int eo, int ee, int fo,
                            int fe, void* scratch, void* out, void* dirs,
                            void* stream) {
  Args a = k5_args(pats, quals, plens, texts, tlens, nb, lp, lt, band_w,
                   match, mm_min, mm_max, n_penalty, eo, ee, fo, fe, out);
  a.dirs = static_cast<uint8_t*>(dirs);
  return static_cast<int>(launch<true, false>(
      a, atype, static_cast<int32_t*>(scratch), nullptr, 0,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
