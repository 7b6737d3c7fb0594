// Band-parallel banded Gotoh affine-gap DP for Hopper (sm_90a): K4, the
// long-pattern kernel, and the wide-band kernel for K1/K2/K3-shaped calls.
// Two designs serve it, by band (2w+1 cells):
//   - up to 128 cells (--band 63 long reads, the paired-end rescue's
//     band-63 chunks, every K4 call of map_reads): the sub-warp group
//     kernel of group_gotoh.cuh, a group of G lanes an alignment and
//     several alignments a 128-thread block (its with_tier gives G and
//     the cells a lane: 32 x 4 for band-63 flags, 16 x 8 for band-63
//     scores);
//   - 129 to 2048 cells (score-only bands to 971, flags to 815): the
//     block-per-alignment kernel below, 64-512 threads x 4 cells.
//
//   k4_long_score           symbol windows, score + sink
//   k4_long_score_packed    windows of the 2-bit packed genome, score + sink
//   k4_long_directions      symbol windows, score + sink + one flag byte
//                           per band cell, in the (nb, lp, 2w+1) layout
//   replace nvbio_tpu/ops/long_dp.py  _make_long_kernel / _long_call
//   (banded_score_long_pallas, banded_directions_long_pallas).  The
//   wrappers in ops/banded_dp.py also route K1/K2/K3 calls whose band is
//   wider than banded_gotoh.cu's 64 cells here.
//
// What it computes is nvbio_tpu_torch/alignment/batched.py cell for cell
// (the plain versions, bit-identical to the TPU kernel's outputs by its
// contract): invalid cells (j < 0 or j > tlen) are masked to NEG_INF every
// row, so no sentinel drifts and no DEAD clamp is needed; the outputs
// follow the Pallas contract (floor clamp, SEMI_GLOBAL last-row max with
// the lowest k on ties, GLOBAL goal cell or NEG_INF outside the band,
// LOCAL earliest row then lowest k, zero-length patterns,
// t_end = max(p_end + k - w, 0); flag ties diag > E > F).
//
// Design of the wide tiers.  The TPU kernel put 128-256 alignments
// across lanes and the band across sublanes, ran 512-row pattern blocks
// on a sequential grid axis with (H, F, sink) carried in VMEM scratch,
// and solved the in-row E recurrence with a Kogge-Stone max-scan over
// the band.  Blocks on the
// H100 run in no order, so here one block owns one alignment and runs
// every row in a loop, with the band across its threads: thread t holds
// cells [t*CPT, t*CPT + CPT) of H and F in registers (NT x CPT is a
// compile-time band capacity, 256 to 2048 cells).  Per row:
//   - F (vertical) reads the previous row's H, F at k+1: the next
//     thread's first cell by __shfl_down_sync, through shared memory at
//     warp edges.  The Hhat of cell t*CPT - 1, which the first cell's E
//     needs, is recomputed from the previous thread's last H (one
//     __shfl_up_sync), so one exchange serves both directions;
//   - E (horizontal), E[k] = max_{j<=k} (A[j] - (k-j)*ee) with
//     A[j] = Hhat_m[j-1] - (eo+ee), is a prefix max of A[j] + j*ee: a
//     sequential scan inside the thread, a __shfl_up_sync max-scan over
//     the warp, one pass over the warp totals in shared memory.  Integer
//     max is associative, so the values equal the sequential recurrence;
//   - text column i + k - w: neighbouring threads read neighbouring
//     bytes; flags: the row's 2w+1 bytes are contiguous and neighbouring
//     threads store neighbouring bytes;
//   - the sink: SEMI_GLOBAL and GLOBAL read row plen once; LOCAL keeps a
//     per-cell running max and its row, reduced over the block at the end.
//
// What bounds it on the H100.  Up to 128 cells, the band-parallel
// one-warp blocks of the first design were held back by three things:
// Hopper keeps at most 32 blocks an SM, so at most 32 of its 64 warps
// ran (the 1 024-lane flag call had ~8 an SM); the row-to-row chain held
// global loads (the row's pattern symbol and quality, five text bytes a
// thread with bounds checks) besides three shuffles and a 5-step
// max-scan; and each thread stored its flags as 4 byte stores a row.
// group_gotoh.cuh answers each (several alignments a block, rows staged
// in shared memory a chunk ahead, text slid through registers, DPX
// forms, flag rows written as 16-byte runs); what is left is integer
// issue, a score cell's least count of 10 instructions (18 with flags;
// the table lookup and each DPX form one, chip_smoke.py GOTOH_OPS) plus
// the group's per-row shuffles and scan, and on small calls the chain's
// latency.  The wide
// tiers keep the first design: each row costs about 15 int32 ops per
// cell, one neighbour exchange and one block-wide scan (two
// __syncthreads), so a block runs rows back to back at the latency of
// that chain, with one alignment a block.

#include <limits.h>

#include "gotoh_common.cuh"
#include "group_gotoh.cuh"

namespace {

using grp::Best;
using grp::FULL;
using grp::better;
using grp::text_symbol;

__device__ __forceinline__ int subst(int p, int t, int mm, const Scheme& sc) {
  return (p >= 4 || t >= 4) ? -sc.n_penalty : (p == t ? sc.match : -mm);
}

__device__ __forceinline__ Best warp_best(Best x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const Best o = {__shfl_xor_sync(FULL, x.v, d), __shfl_xor_sync(FULL, x.r, d),
                    __shfl_xor_sync(FULL, x.k, d)};
    if (better(o, x)) x = o;
  }
  return x;
}

// the best candidate of the block, valid in thread 0
template <int NW>
__device__ __forceinline__ Best block_best(Best x, Best* sh) {
  x = warp_best(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < NW ? sh[lane] : Best{INT_MIN, INT_MAX, INT_MAX};
    x = warp_best(x);
  }
  return x;
}

template <int NT, int CPT, int ATYPE, bool PACKED, bool DIRS>
__global__ void __launch_bounds__(NT) long_gotoh_kernel(const Args a) {
  constexpr int NW = NT / 32;
  static_assert(NW > 1, "bands up to 128 cells run group_gotoh.cuh");
  __shared__ int sh_first_h[NW], sh_first_f[NW], sh_last_h[NW], sh_tot[NW];
  __shared__ Best sh_best[NW];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Scheme sc = a.sc;
  const int w = a.band_w;
  const int band = 2 * w + 1;
  const int plen = a.plens[b];
  const int tlen = a.tlens[b];
  const int8_t* pat = a.pats + static_cast<int64_t>(b) * a.lp;
  const uint8_t* qual = a.quals + static_cast<int64_t>(b) * a.lp;
  const int64_t ws = PACKED ? a.win_start[b] : 0;
  const int k0 = tid * CPT;  // this thread's first band cell
  const int eoe = sc.eo + sc.ee, foe = sc.fo + sc.fe;

  int H[CPT], F[CPT];
  int snapH[CPT], snapR[CPT];  // LOCAL: per-cell running max and its row
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int k = k0 + c;
    const int j0 = k - w;
    int h0;
    if (ATYPE == GLOBAL)
      h0 = j0 == 0 ? 0 : (j0 > 0 ? -(sc.eo + sc.ee * j0) : NEG_INF);
    else
      h0 = j0 >= 0 ? 0 : NEG_INF;
    H[c] = (k < band && j0 <= tlen) ? h0 : NEG_INF;
    F[c] = NEG_INF;
    snapH[c] = 0;
    snapR[c] = 0;
  }
  // SEMI_GLOBAL / GLOBAL: this thread's candidate from row plen
  Best mine = {ATYPE == GLOBAL ? NEG_INF : NEG_INF - 1, 0, INT_MAX};
  const int k_goal = tlen - plen + w;

  // score-only kernels stop at the pattern's end; the flag kernel fills
  // every row, like the plain version
  const int n_rows = DIRS ? a.lp : min(plen, a.lp);
  for (int i0 = 0; i0 < n_rows; ++i0) {
    const int p = pat[i0];
    const int q = min(static_cast<int>(qual[i0]), 40);
    const int mm = sc.mm_min + floor_div40((sc.mm_max - sc.mm_min) * q);
    const int row = i0 + 1;
    const int j_base = row - w;  // cell k lies at text column j_base + k

    // the previous row's neighbours: H, F of cell k0 + CPT (next thread)
    // and H of cell k0 - 1 (previous thread)
    int nxt_h = __shfl_down_sync(FULL, H[0], 1);
    int nxt_f = __shfl_down_sync(FULL, F[0], 1);
    int prv_h = __shfl_up_sync(FULL, H[CPT - 1], 1);
    if (lane == 0) {
      sh_first_h[warp] = H[0];
      sh_first_f[warp] = F[0];
    }
    if (lane == 31) sh_last_h[warp] = H[CPT - 1];
    __syncthreads();
    if (lane == 31) {
      nxt_h = warp + 1 < NW ? sh_first_h[warp + 1] : NEG_INF;
      nxt_f = warp + 1 < NW ? sh_first_f[warp + 1] : NEG_INF;
    }
    if (lane == 0) prv_h = warp > 0 ? sh_last_h[warp - 1] : NEG_INF;

    // masked Hhat of cell k0 - 1, recomputed from the previous row
    int hm_prev = NEG_INF;
    if (k0 > 0) {
      const int km = k0 - 1;
      const int jm = j_base + km;
      const int t = text_symbol<PACKED>(a, b, ws, i0 + km - w, tlen);
      const int f_new = max(H[0] - foe, F[0] - sc.fe);
      int hh = max(prv_h + subst(p, t, mm, sc), f_new);
      if (ATYPE == LOCAL) hh = max(hh, 0);
      if (km < band && jm >= 0 && jm <= tlen) hm_prev = hh;
    }

    int hhat[CPT], hdiag[CPT], fnew[CPT], fopen[CPT], aopen[CPT], pre[CPT];
    bool valid[CPT];
    int run = INT_MIN;  // inclusive prefix max of A[k] + k * ee
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int k = k0 + c;
      const int j = j_base + k;
      valid[c] = k < band && j >= 0 && j <= tlen;
      const int t = text_symbol<PACKED>(a, b, ws, i0 + k - w, tlen);
      // H[c + 1] and F[c + 1] still hold the previous row here
      const int up_h = c + 1 < CPT ? H[c + 1] : nxt_h;
      const int up_f = c + 1 < CPT ? F[c + 1] : nxt_f;
      fopen[c] = up_h - foe;
      fnew[c] = max(fopen[c], up_f - sc.fe);
      hdiag[c] = H[c] + subst(p, t, mm, sc);
      int hh = max(hdiag[c], fnew[c]);
      if (ATYPE == LOCAL) hh = max(hh, 0);
      hhat[c] = hh;
      aopen[c] = hm_prev - eoe;
      run = max(run, aopen[c] + k * sc.ee);
      pre[c] = run;
      hm_prev = valid[c] ? hh : NEG_INF;
    }

    // exclusive prefix of the threads before this one
    int incl = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl = max(incl, o);
    }
    int excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = INT_MIN;
    if (lane == 31) sh_tot[warp] = incl;
    __syncthreads();
    for (int v = 0; v < warp; ++v) excl = max(excl, sh_tot[v]);

    uint8_t* drow = DIRS ? a.dirs + (static_cast<int64_t>(b) * a.lp + i0) * band
                         : nullptr;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int k = k0 + c;
      const int e = max(excl, pre[c]) - k * sc.ee;
      int h_new = max(hhat[c], e);
      if (ATYPE == LOCAL) h_new = max(h_new, 0);
      h_new = valid[c] ? h_new : NEG_INF;
      const int f_m = valid[c] ? fnew[c] : NEG_INF;
      const int e_m = valid[c] ? e : NEG_INF;
      H[c] = h_new;
      F[c] = f_m;
      if (DIRS && k < band) {
        int flag = h_new == hdiag[c] ? 0 : (h_new == e_m ? 1 : 2);
        if (ATYPE == LOCAL && h_new <= 0) flag = 3;
        if (!valid[c]) flag = 3;
        flag |= (e_m == aopen[c]) << 2;
        flag |= (f_m == fopen[c]) << 3;
        drow[k] = static_cast<uint8_t>(flag);
      }
      if (ATYPE == LOCAL) {
        if (row <= plen && h_new > snapH[c]) {  // strict: earliest row
          snapH[c] = h_new;
          snapR[c] = row;
        }
      } else if (row == plen && k < band) {
        if (ATYPE == GLOBAL) {
          if (k == k_goal) mine.v = h_new;
        } else if (h_new > mine.v) {  // strict: the lowest k wins ties
          mine.v = h_new;
          mine.k = k;
        }
      }
    }
  }

  if (ATYPE == LOCAL) {
    mine = Best{0, INT_MAX, INT_MAX};
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const Best x = {snapH[c], snapR[c], k0 + c};
      if (k0 + c < band && better(x, mine)) mine = x;
    }
  }
  const Best top = block_best<NW>(mine, sh_best);
  if (tid != 0) return;

  int best, best_i, best_k;
  if (ATYPE == LOCAL) {
    best = top.v;
    best_i = top.r;
    best_k = top.k;
  } else if (plen >= 1 && plen <= a.lp) {
    best = top.v;  // GLOBAL: NEG_INF when k_goal is outside the band
    best_i = plen;
    best_k = ATYPE == GLOBAL ? k_goal : top.k;
  } else {
    best = NEG_INF;
    best_i = 0;
    best_k = w;
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

template <int NT, int CPT, bool PACKED, bool DIRS>
cudaError_t launch_atype(const Args& a, int atype, cudaStream_t stream) {
  const dim3 grid(a.nb), block(NT);
  switch (atype) {
    case GLOBAL:
      long_gotoh_kernel<NT, CPT, GLOBAL, PACKED, DIRS>
          <<<grid, block, 0, stream>>>(a);
      break;
    case SEMI_GLOBAL:
      long_gotoh_kernel<NT, CPT, SEMI_GLOBAL, PACKED, DIRS>
          <<<grid, block, 0, stream>>>(a);
      break;
    case LOCAL:
      long_gotoh_kernel<NT, CPT, LOCAL, PACKED, DIRS>
          <<<grid, block, 0, stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool PACKED, bool DIRS>
cudaError_t launch(const Args& a, int atype, cudaStream_t stream) {
  if (a.nb == 0) return cudaSuccess;
  const int band = 2 * a.band_w + 1;
  // up to 128 cells the sub-warp groups; above, the smallest (threads x
  // cells) shape that holds the band; the wrapper rejects bands wider
  // than the widest
  if (band <= grp::MAX_CELLS)
    return grp::launch<PACKED, DIRS>(a, atype, stream);
  if (band <= 256) return launch_atype<64, 4, PACKED, DIRS>(a, atype, stream);
  if (band <= 512) return launch_atype<128, 4, PACKED, DIRS>(a, atype, stream);
  if (band <= 1024) return launch_atype<256, 4, PACKED, DIRS>(a, atype, stream);
  if (band <= 2048) return launch_atype<512, 4, PACKED, DIRS>(a, atype, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// All pointers are device pointers; out is (3, nb) int32.  The argument
// lists are those of banded_gotoh.cu's k1/k3/k2 entry points.  Returns the
// cudaError_t of the launch (0 on success).
int k4_long_score(const void* pats, const void* quals, const void* plens,
                  const void* texts, const void* tlens, int nb, int lp, int lt,
                  int band_w, int atype, int match, int mm_min, int mm_max,
                  int n_penalty, int eo, int ee, int fo, int fe, void* out,
                  void* stream) {
  Args a = make_args(pats, quals, plens, tlens, nb, lp, band_w, match, mm_min,
                     mm_max, n_penalty, eo, ee, fo, fe, out);
  a.texts = static_cast<const int8_t*>(texts);
  a.lt = lt;
  return static_cast<int>(
      launch<false, false>(a, atype, static_cast<cudaStream_t>(stream)));
}

int k4_long_score_packed(const void* pats, const void* quals,
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
  return static_cast<int>(
      launch<true, false>(a, atype, static_cast<cudaStream_t>(stream)));
}

int k4_long_directions(const void* pats, const void* quals, const void* plens,
                       const void* texts, const void* tlens, int nb, int lp,
                       int lt, int band_w, int atype, int match, int mm_min,
                       int mm_max, int n_penalty, int eo, int ee, int fo,
                       int fe, void* out, void* dirs, void* stream) {
  Args a = make_args(pats, quals, plens, tlens, nb, lp, band_w, match, mm_min,
                     mm_max, n_penalty, eo, ee, fo, fe, out);
  a.texts = static_cast<const int8_t*>(texts);
  a.lt = lt;
  a.dirs = static_cast<uint8_t*>(dirs);
  return static_cast<int>(
      launch<false, true>(a, atype, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
