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
//   k5_band_directions       score + sink + one 4-bit flag per band cell
//                            on the banded column-sweep tier, in its
//                            layout (ops/wavefront_dp.py), at any lp
//   k5_band_dirs_plan, k5_band_dirs_scratch_words, k5_band_dirs_warps_per_sm
//                            its grid (blocks a cluster, warps a block),
//                            scratch (patterns past 32 strips) and warps
//                            an SM
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
// bit 2 E open, bit 3 F open; 3 on every cell not computed.
//
// Design.  The TPU kernel ran one alignment per grid program with the
// anti-diagonal across an (NR, 128) vector window that slid up the
// pattern, fed text symbols systolically and carried sinks across window
// rebases in SMEM scalars.  None of that is needed on the H100.  The
// diagonal kernel (k5_kernel: the formula score past 8192 rows, the matrix
// mode's narrower bands): one block owns one alignment and loops over its
// diagonals d = r + j; the cells of a diagonal (rows r with |d - 2r| <=
// w, at most w + 1) lie across the block's threads, two neighbouring rows
// per thread-step.  Parametrised by the row, every
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
// over the block once at the end in the twin's tie order.  It visits only
// rows <= plen and columns <= tlen.
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
// wider patterns k5_kernel.  The band tier
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
// The flag entry point (wide CIGAR's pass 3, 8 lanes a call) takes the
// same sweep with flags at any Lp (k5_band_dirs_kernel): every row up to
// Lp (the twin's flag rows; sinks keep row plen's rules in whichever
// strip holds it), and at every step each lane stores one 32-bit word,
// its 8 rows' flags a nibble each, so that a warp's store is 128
// contiguous bytes: flags (nb, S, T, 32) for S = ceil(Lp / 256) strips
// and T = 256 + 2 w + 32 steps, word [b, p, s, l] at column jbase(p) + s -
// l, 3 in every nibble not computed (the kernel writes every word).  The
// G form hides Hdiag (inside H's DPX operation) and E, so the flag is
// rebuilt beside the chain: Hdiag = diag + sub, E = G - j ee, E open as
// G == Hhat(j - 1) + j ee - (eo + ee), F open as F == H_up - (fo + fe),
// with the entry and edge values of k5_kernel's left_out and x == w.
// A call that would leave SMs idle (pass 3: 8 alignments, 16 strips each)
// spreads an alignment's strips over a thread-block cluster of C blocks
// (C = 4 there: four strips a block, a warp for each scheduler), the ring
// between two blocks in the reader's shared memory, written through
// distributed shared memory and fenced at cluster scope.  Where no cluster
// fits (the batch fills the SMs, or a block would need more than 32
// strips) C = 1: a block holds every strip, and patterns of more than 32
// strips take passes of 32: the last strip of a pass leaves its last row
// in a boundary row in device scratch, which warp 0 of the next pass reads
// in place of a ring.
// What bounds it: with C = 1 the score tier's issue on one SM an alignment
// plus ~8 flag instructions a cell and a store a step; spread over a
// cluster, each warp's step latency (8 rows of three dependent DPX
// operations, beside its flag and store instructions) times the critical
// path: strip p starts ~300 steps after strip p - 1 and sweeps ~2 w + 290
// steps (~9 000 steps at pass 3's shape).
//
// What bounds the diagonal kernel on the H100: per cell about 30 int32
// operations and 9 shared-memory accesses behind one barrier per
// diagonal, with one block of up to 1024 threads per alignment; the
// parallelism is the cells of a diagonal times the alignments in flight.

#include <limits.h>

#include <cooperative_groups.h>

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

template <int ATYPE, bool MAT>
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
  const int rmax = max(min(plen, lp), 0);
  const int ndiag = max(rmax + tlen + 1, 0);
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
    const int p_begin = max(r_min - rlo, 0) >> 1;
    const int p_end = r_max >= r_min ? ((r_max - rlo) >> 1) + 1 : 0;
    for (int p = p_begin + tid; p < p_end; p += nt) {
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
        if (ATYPE == GLOBAL) {
          if (r == plen && x == x_goal) best.h = H;
        } else if ((ATYPE == LOCAL ? r <= plen : r == plen) &&
                   better(Best{H, r, x + w}, best)) {
          best = Best{H, r, x + w};
        }
      }
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

template <int ATYPE, bool MAT>
cudaError_t launch_one(const Args& a, int32_t* scratch, const int32_t* mat,
                       int mat_k, cudaStream_t stream) {
  const int ring = ring_size(a.band_w);
  const int smem = rings_in_smem(a.band_w) ? N_RINGS * ring * 4 : 0;
  const int npairs = (a.band_w + 2) / 2;  // two rows a thread-step
  const int nt = min(MAX_THREADS, (npairs + 31) / 32 * 32);
  cudaError_t err = cudaFuncSetAttribute(
      k5_kernel<ATYPE, MAT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  k5_kernel<ATYPE, MAT><<<a.nb, nt, smem, stream>>>(
      a, scratch, ring, smem > 0, mat, mat_k);
  return cudaGetLastError();
}

template <bool MAT>
cudaError_t launch(const Args& a, int atype, int32_t* scratch,
                   const int32_t* mat, int mat_k, cudaStream_t stream) {
  if (a.nb == 0) return cudaSuccess;
  switch (atype) {
    case GLOBAL:
      return launch_one<GLOBAL, MAT>(a, scratch, mat, mat_k, stream);
    case SEMI_GLOBAL:
      return launch_one<SEMI_GLOBAL, MAT>(a, scratch, mat, mat_k, stream);
    case LOCAL:
      return launch_one<LOCAL, MAT>(a, scratch, mat, mat_k, stream);
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
// blocks of the flag tier's cluster at most (the portable cluster size),
// and the strips a block of its own choosing keeps at least
constexpr int BS_MAX_CLUSTER = 8;
constexpr int BS_MIN_WARPS = 4;
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

// a fence over the block, or (wide: a boundary between two blocks of a
// cluster) over the cluster
__device__ __forceinline__ void bs_fence(bool wide) {
  if (wide)
    asm volatile("fence.acq_rel.cluster;" ::: "memory");
  else
    __threadfence_block();
}

// (a wait of ~seconds means a fault in the protocol: trap, so that the
// launch fails instead of hanging the card)
__device__ __forceinline__ void bs_wait(const volatile int* c, int need,
                                        bool wide = false) {
  for (int n = 0; *c < need; ++n) {
    if (n == (1 << 26)) __trap();
    __nanosleep(32);
  }
  bs_fence(wide);
}

__device__ __forceinline__ void bs_publish(volatile int* c, int v, bool me,
                                           bool wide = false) {
  __syncwarp();
  bs_fence(wide);
  if (me) *c = v;
}

// A strip's two boundaries: ``in`` (the row above, read by lane 0 or by
// every lane) and ``out`` (its last row, written by lane 31), each either a
// ring of BS_RING columns with its published and consumed counts (ring_in,
// ring_out; wide: the ring lies in another block of the cluster, reached
// through distributed shared memory, and its counts are fenced at cluster
// scope) or a whole row in device scratch (mask -1, no counts).  The
// writer's counts lie where the writer polls (its consumed count) and the
// reader's where the reader polls (the published count).
struct BsLinks {
  const int2* in;
  int2* out;
  volatile int *in_prod, *in_cons, *out_prod, *out_cons;
  int imask, omask;
  bool ring_in, ring_out, wide_in, wide_out;
};

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

// The flag tier's strip (k5_band_dirs_kernel): bs_strip's sweep, kept apart
// from it so that the score tier's code stays as it was (one function with
// the flag work behind a template switch rescheduled the score tier's
// steps: 2.025 -> 2.095 ms at sw_benchmark's shape on an H100; sharing
// only the set-up, sinks and chunk loop through inlined helpers still cost
// both tiers ~1 %: PERF.md).  A fix to the strips' edge rules (sb / se,
// EENTRY / FEDGE, fin_in) goes into both.
// Every step the lane also stores one 32-bit word into fl (its column of
// the strip's (T, 32) words), row r0 + i's flag in nibble i, k5_kernel's
// encoding rebuilt from the G form beside the chain: Hdiag = diag + sub,
// E = G - j ee, E open as G == Hhat(j-1) + j ee - (eo + ee) (left_out:
// E == NEG_INF - (eo + ee)), F open as F == H_up - (fo + fe) (x == w:
// F == NEG_INF - (fo + fe)); 3 in the nibbles of rows outside the band or
// past R, in the words of steps the lane does not compute, and in the
// steps from the last to T.  Its boundaries are links (BsLinks) that
// k5_band_dirs_kernel sets: rings in its block, in a neighbouring block of
// its cluster, or boundary rows in device scratch between passes.  Sinks
// as bs_strip's, LOCAL's over rows <= plen (R is Lp here).
template <int ATYPE, bool SINK>
__device__ __forceinline__ void bsd_strip(const BsCtx& c, int strip, int lane,
                                          const BsLinks& L, Best& best,
                                          int* goal, uint32_t* fl, int T) {
  constexpr int rmask = BS_RING - 1;
  constexpr uint32_t F3 = 0x33333333u;  // 3 in every nibble
  const Scheme sc = c.sc;
  const int w = c.w, R = c.R, tlen = c.tlen, lt = c.lt;
  const int base = strip * BS_ROWS;
  const int rows = min(R - base, BS_ROWS);
  const bool more = base + BS_ROWS < R;
  const int2* const in = L.in;
  int2* const out = L.out;
  const int imask = L.imask, omask = L.omask;
  const bool ring_in = L.ring_in, ring_out = L.ring_out;
  const bool wide_in = L.wide_in, wide_out = L.wide_out;
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
  const int fin_in = min(tlen, base + w) + 1;  // strip - 1 writes below it
  // the nibbles of the lane's rows up to R
  const uint32_t rowm =
      r0 > R ? 0u
             : (r0 + BS_RPL - 1 <= R
                    ? 0xffffffffu
                    : 0xffffffffu >> (4 * (r0 + BS_RPL - 1 - R)));

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
    return jj < 0 ? make_int2(NEG_INF, NEG_INF) : in[jj & imask];
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
        bcur = in[jj & imask];  // every lane: one broadcast, no branch
      else
        bcur = make_int2(ATYPE == GLOBAL ? -sc.eo - sc.ee * jj : 0, NEG_INF);
    }
    if (MASKED && !(has_rows && j >= lo && j <= hi)) {
      fl[static_cast<int64_t>(s) * 32] = F3;
      return;
    }
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
    uint32_t word = 0;
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
      {  // k5_kernel's flag: H source, E and F open
        // f_open, and e_open + j ee (left_out: NEG_INF - (eo + ee))
        const int fop = MASKED && xc == i ? NEG_INF - foe : uh - foe;
        const int gop = MASKED && (xa == i || j == 0) ? NEG_INF - eoe - mj
                                                      : Hh[i] + cj;
        int f = H == diag + sub ? 0 : (H == g + mj ? 1 : 2);
        if (ATYPE == LOCAL && H <= 0) f = 3;
        f |= (g == gop ? 4 : 0) | (F == fop ? 8 : 0);
        word |= static_cast<uint32_t>(f) << (4 * i);
      }
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
    {  // rows past R, and rows out of the band, read 3
      uint32_t m = rowm;
      if (MASKED) {
        const int ia = min(xa, BS_RPL - 1), ic = max(xc, 0);
        m &= (0xffffffffu >> (4 * (BS_RPL - 1 - ia + ic))) << (4 * ic);
      }
      fl[static_cast<int64_t>(s) * 32] = (word & m) | (F3 & ~m);
    }
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
    if (more && lane == 31) out[j & omask] = make_int2(oh, of);
  };

  for (int s = 0; s < nsteps;) {  // chunks of 32 steps
    if (ring_in) {
      bs_publish(L.in_cons, jbase + s, lane == 0, wide_in);
      bs_wait(L.in_prod, min(jbase + s + 33, fin_in), wide_in);
    }
    if (ring_out) {
      bs_publish(L.out_prod, jbase + s - 31, lane == 31, wide_out);
      bs_wait(L.out_cons, jbase + s - rmask, wide_out);
    }
    if (s == 0 && lane == 0) bcur = boundary(jbase);
    const int e = min(s + 32, nsteps);
    if (s >= sb && e <= se) {
      for (; s < e; ++s) step(s, std::false_type{});
    } else {
      for (; s < e; ++s) step(s, std::true_type{});
    }
  }
  if (ring_in) bs_publish(L.in_cons, INT_MAX, lane == 0, wide_in);
  if (ring_out) bs_publish(L.out_prod, INT_MAX, lane == 31, wide_out);
  for (int s = nsteps; s < T; ++s) fl[static_cast<int64_t>(s) * 32] = F3;
  if constexpr (SINK) {
    if constexpr (ATYPE == LOCAL) {
#pragma unroll
      for (int i = 0; i < BS_RPL; ++i) {
        const int r = r0 + i;
        const Best cand{bh[i], r, bj[i] - r + w};
        if (has_rows && r <= R && r <= c.plen && better(cand, best))
          best = cand;
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

__host__ __device__ inline int bs_warps(int lp) {
  return (lp + BS_ROWS - 1) / BS_ROWS;
}

// the flag tier's steps a strip (T): the widest strip's 256 + 2 w + 31
// steps, and one
__host__ __device__ inline int bs_steps(int band_w) {
  return BS_ROWS + 2 * band_w + 32;
}

// columns of a boundary row between two passes of the flag tier: a strip's
// lane 0 fetches up to column lp + w + 32
__host__ __device__ inline long long bs_cols(int lp, int band_w) {
  return static_cast<long long>(lp) + band_w + 33;
}

// The flag entry point's tier (k5_band_directions): k5_band_kernel's
// sweep over every row up to Lp (the flag entry point's rows), each strip
// storing its flag words into flags, (nb, S, T, 32) 32-bit words for S =
// ceil(lp / BS_ROWS) strips; every word written.  A cluster of C blocks
// takes an alignment (C = 1: a plain launch).  Block k of it holds
// warps for strips k nw .. k nw + nw - 1 (C > 1: one pass, S <= C nw);
// ring 0 of block k + 1 takes block k's last strip's row, written through
// distributed shared memory, its published count in block k + 1 and its
// consumed count in block k (cnt[2 BS_MAX_WARPS + 1]), fenced at cluster
// scope; the cluster syncs after set-up, after the sweep and after block
// k's best reaches block 0, which writes the result.  With C = 1 the
// block's nw warps take the S strips in passes (warp p on strip p0 + p)
// with a barrier between passes; the last warp of a pass hands its last
// row to the next pass's warp 0 through ``bound``: two rows of bs_cols int2
// an alignment, pass q writing row q & 1, so that no pass writes the row
// its warp 0 reads.  Ring w of a block holds the row above its warp w's
// strip (ring 0 unused with C = 1).  Sinks keep k5_band_kernel's rules on
// row plen, in whichever strip holds it; a lane with plen > Lp has no row
// plen and ends, as the plain version's, at (0, 0) outside LOCAL.
template <int ATYPE, int MAXW>
__global__ void __launch_bounds__(MAXW * 32)
    k5_band_dirs_kernel(Args a, uint32_t* flags, int2* bound) {
  namespace cg = cooperative_groups;
  extern __shared__ int2 bs_rings[];
  __shared__ int cnt[2 * BS_MAX_WARPS + 2];
  __shared__ Best wbest[BS_MAX_WARPS];
  __shared__ Best cbest[BS_MAX_CLUSTER];
  __shared__ int goal;
  cg::cluster_group cl = cg::this_cluster();
  const int C = cl.num_blocks(), rank = cl.block_rank();
  const int b = blockIdx.x / C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int plen = a.plens[b], lp = a.lp;
  const BsCtx c{a.pats + static_cast<int64_t>(b) * lp,
                a.quals + static_cast<int64_t>(b) * lp,
                a.texts + static_cast<int64_t>(b) * a.lt,
                a.lt, a.band_w, plen, a.tlens[b], lp, a.sc};
  const int S = bs_warps(lp), T = bs_steps(c.w);
  const long long cols = bs_cols(lp, c.w);
  int2* const brow = bound + static_cast<int64_t>(b) * 2 * cols;
  // GLOBAL's sink cell: block 0's
  int* const gp = C > 1 ? cl.map_shared_rank(&goal, 0) : &goal;
  volatile int* const box = cnt + 2 * BS_MAX_WARPS + 1;  // outbox consumed
  if (threadIdx.x == 0) goal = NEG_INF;
  Best best = ATYPE == LOCAL ? Best{0, 0, c.w} : Best{NEG_INF, plen, 0};
  // the strip that holds row plen (none when plen is 0 or past Lp)
  const int sink = plen >= 1 && plen <= lp ? (plen - 1) / BS_ROWS : -1;
  auto jb = [&](int strip) { return max(0, strip * BS_ROWS + 1 - c.w) - 1; };
  auto sync = [&] {
    if (C > 1)
      cl.sync();
    else
      __syncthreads();
  };
  auto run = [&](int p0, int pass) {  // strips p0 .. p0 + nw - 1
    const int strip = p0 + warp;
    if (lane == 0) {  // nothing published, nothing read
      cnt[2 * warp] = INT_MIN;
      cnt[2 * warp + 1] = jb(strip);
    }
    if (threadIdx.x == 0) *box = jb(p0 + nw);
    sync();  // (C > 1: before a neighbour publishes into this block)
    if (strip < S) {
      const bool more = strip + 1 < S, last = warp == nw - 1;
      const bool wide_in = C > 1 && warp == 0 && strip > 0;
      const bool wide_out = C > 1 && last && more;
      BsLinks L{bs_rings + warp * BS_RING, bs_rings + (warp + 1) * BS_RING,
                cnt + 2 * warp, cnt + 2 * warp + 1, cnt + 2 * warp + 2,
                cnt + 2 * warp + 3, BS_RING - 1, BS_RING - 1,
                strip > 0 && (warp > 0 || C > 1), more && (!last || C > 1),
                wide_in, wide_out};
      if (wide_in)
        L.in_cons =
            cl.map_shared_rank(cnt + 2 * BS_MAX_WARPS + 1, rank - 1);
      if (wide_out) {
        L.out = cl.map_shared_rank(bs_rings, rank + 1);
        L.out_prod = cl.map_shared_rank(cnt, rank + 1);
        L.out_cons = box;
      }
      if (C == 1 && warp == 0) {  // the boundary row of the pass before
        L.in = brow + ((pass + 1) & 1) * cols;
        L.imask = -1;
      }
      if (C == 1 && last) {
        L.out = brow + (pass & 1) * cols;
        L.omask = -1;
      }
      uint32_t* fl =
          flags + (static_cast<int64_t>(b) * S + strip) * T * 32 + lane;
      if (ATYPE == LOCAL ? strip * BS_ROWS < plen : strip == sink)
        bsd_strip<ATYPE, true>(c, strip, lane, L, best, gp, fl, T);
      else
        bsd_strip<ATYPE, false>(c, strip, lane, L, best, gp, fl, T);
    }
    sync();  // the pass's boundary row is whole, its rings free (C > 1: no
             // neighbour writes into this block any more)
  };
  if (C > 1) {
    run(rank * nw, 0);
  } else {
    for (int p0 = 0, pass = 0; p0 < S; p0 += nw, ++pass) run(p0, pass);
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
    if (C > 1) *cl.map_shared_rank(&cbest[rank], 0) = best;
  }
  if (C > 1) cl.sync();  // every block's best is in block 0
  if (rank == 0 && threadIdx.x == 0) {
    for (int i = 1; i < C; ++i)
      if (better(cbest[i], best)) best = cbest[i];
    const bool past = plen > lp;
    if (ATYPE == GLOBAL) {  // k5_kernel's output rules
      a.out[b] = goal;
      a.out[a.nb + b] = past ? 0 : plen;
      a.out[2 * a.nb + b] = plen == 0 || past ? 0 : c.tlen;
    } else {
      const bool none = ATYPE == SEMI_GLOBAL && past;
      a.out[b] = best.h;
      a.out[a.nb + b] = none ? 0 : best.r;
      a.out[2 * a.nb + b] = none ? 0 : max(best.r + best.k - c.w, 0);
    }
  }
}

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

// The flag tier's grid: C blocks an alignment (a cluster), the largest
// power of two <= BS_MAX_CLUSTER that leaves a block BS_MIN_WARPS strips
// at least (a warp for each of an SM's four schedulers) and BS_MAX_WARPS
// at most, with nb * C blocks <= the card's SMs (one alignment an SM
// leaves the rest idle at pass 3's 8 lanes), and ceil(S / C) warps a
// block; C = 1 where no cluster size fits (the block then takes its
// strips in passes of 32).  (At pass 3's 8 x 4 000, band_w 2 000 on an
// H100, C = 1, 2, 4 and 8 took 4.04, 3.08, 2.59 and 2.65 ms: PERF.md.)
cudaError_t bsd_plan(int nb, int lp, int* C, int* nw) {
  const int S = bs_warps(lp);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int c = 1;
  for (int k = 2; k <= BS_MAX_CLUSTER && k * BS_MIN_WARPS <= S &&
                  static_cast<long long>(nb) * k <= sms;
       k *= 2)
    if ((S + k - 1) / k <= BS_MAX_WARPS) c = k;
  *C = c;
  *nw = c > 1 ? (S + c - 1) / c : min(S, BS_MAX_WARPS);
  return cudaSuccess;
}

// the flag tier's dynamic shared memory: a ring a warp (ring 0 takes the
// row of the cluster's block before)
int bsd_smem(int nw) { return nw * BS_RING * sizeof(int2); }

template <int ATYPE, int MAXW>
cudaError_t bsd_launch_one(const Args& a, int C, int nw, cudaStream_t st,
                           int* per_sm, uint32_t* flags, int2* bound) {
  const auto kernel = k5_band_dirs_kernel<ATYPE, MAXW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bsd_smem(nw));
  if (err != cudaSuccess) return err;
  if (per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, nw * 32, bsd_smem(nw));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nb * C);
  cfg.blockDim = dim3(nw * 32);
  cfg.dynamicSmemBytes = bsd_smem(nw);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, flags, bound);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the kernel bounded to the block's warps: 4 (a cluster's blocks at pass
// 3: up to 255 registers a thread, where 16 warps' 128 spilled), 16 (up
// to 128) or 32 (up to 64)
template <int ATYPE>
cudaError_t bsd_launch(const Args& a, int C, int nw, cudaStream_t st,
                       int* per_sm, uint32_t* flags, int2* bound) {
  if (nw <= BS_MIN_WARPS)
    return bsd_launch_one<ATYPE, BS_MIN_WARPS>(a, C, nw, st, per_sm, flags,
                                               bound);
  if (nw <= 16)
    return bsd_launch_one<ATYPE, 16>(a, C, nw, st, per_sm, flags, bound);
  return bsd_launch_one<ATYPE, BS_MAX_WARPS>(a, C, nw, st, per_sm, flags,
                                             bound);
}

cudaError_t bsd_dispatch(const Args& a, int atype, int C, int nw,
                         cudaStream_t st, int* per_sm = nullptr,
                         uint32_t* flags = nullptr, int2* bound = nullptr) {
  switch (atype) {
    case GLOBAL:
      return bsd_launch<GLOBAL>(a, C, nw, st, per_sm, flags, bound);
    case SEMI_GLOBAL:
      return bsd_launch<SEMI_GLOBAL>(a, C, nw, st, per_sm, flags, bound);
    case LOCAL:
      return bsd_launch<LOCAL>(a, C, nw, st, per_sm, flags, bound);
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
  return static_cast<int>(launch<false>(
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
  return static_cast<int>(launch<true>(
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

// int32 words of device scratch k5_band_directions needs: the boundary
// rows between its passes (two rows of lp + band_w + 33 (H, F) pairs an
// alignment) when the pattern has more strips than a block has warps,
// else 0; -1 for lp < 1.
long long k5_band_dirs_scratch_words(int nb, int lp, int band_w) {
  if (lp < 1 || band_w < 0) return -1;
  return bs_warps(lp) > BS_MAX_WARPS ? 4LL * nb * bs_cols(lp, band_w) : 0;
}

// The flag tier's grid for this call into plan[0..1]: blocks an alignment
// (a cluster; 1 for a plain launch) and warps a block.  Returns a
// cudaError_t.
int k5_band_dirs_plan(int nb, int lp, void* plan) {
  if (lp < 1) return cudaErrorInvalidValue;
  int* const p = static_cast<int*>(plan);
  return static_cast<int>(bsd_plan(nb, lp, p, p + 1));
}

// As k5_band_score, plus dirs: (nb, ceil(lp / 256), 256 + 2 band_w + 32,
// 32) 32-bit words of 8 flags (module header), every word written, on
// k5_band_dirs_plan's grid; scratch holds
// k5_band_dirs_scratch_words(nb, lp, band_w) int32 words (unused when that
// is 0).  Any lp >= 1.
int k5_band_directions(const void* pats, const void* quals, const void* plens,
                       const void* texts, const void* tlens, int nb, int lp,
                       int lt, int band_w, int atype, int match, int mm_min,
                       int mm_max, int n_penalty, int eo, int ee, int fo,
                       int fe, void* scratch, void* out, void* dirs,
                       void* stream) {
  if (lp < 1 || band_w < 0) return cudaErrorInvalidValue;
  if (nb == 0) return cudaSuccess;
  const Args a = k5_args(pats, quals, plens, texts, tlens, nb, lp, lt, band_w,
                         match, mm_min, mm_max, n_penalty, eo, ee, fo, fe,
                         out);
  int C = 0, nw = 0;
  cudaError_t err = bsd_plan(nb, lp, &C, &nw);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(bsd_dispatch(
      a, atype, C, nw, static_cast<cudaStream_t>(stream), nullptr,
      static_cast<uint32_t*>(dirs), static_cast<int2*>(scratch)));
}

// Warps of the flag tier's kernel an SM keeps resident for a call of nb
// alignments at this Lp (its blocks have k5_band_dirs_plan's warps); -1 on
// a CUDA error.
int k5_band_dirs_warps_per_sm(int atype, int nb, int lp) {
  if (lp < 1) return -1;
  int per_sm = 0, C = 0, nw = 0;
  const Args a = {};
  return bsd_plan(nb, lp, &C, &nw) == cudaSuccess &&
                 bsd_dispatch(a, atype, C, nw, nullptr, &per_sm) ==
                     cudaSuccess
             ? per_sm * nw
             : -1;
}

}  // extern "C"
