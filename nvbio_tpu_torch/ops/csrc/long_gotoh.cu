// Band-parallel banded Gotoh affine-gap DP for Hopper (sm_90a): K4, the
// long-pattern kernel, and the wide-band kernel for K1/K2/K3-shaped calls.
// Three designs serve it, by band (2w+1 cells), flags and pattern length
// (wide_plan; ops/long_dp.py mirrors it):
//   - up to 128 cells (--band 63 long reads, the paired-end rescue's
//     band-63 chunks, every K4 call of map_reads): the sub-warp group
//     kernel of group_gotoh.cuh, a group of G lanes an alignment and
//     several alignments a 128-thread block (its with_tier gives G and
//     the cells a lane: 32 x 4 for band-63 flags, 16 x 8 for band-63
//     scores);
//   - 129 to 2048 cells, score-only, Lp <= 256: the column sweep
//     (k4_sweep_kernel), one warp an alignment at 4 pattern rows a lane
//     to Lp 128 (the PE --local rescue's window-wide band, 1 024 x 128 at
//     band_w 530) and 8 to Lp 256 (its 150 bp mates, bucketed to 160);
//   - 129 to 2048 cells otherwise (score-only bands to 971 at longer
//     patterns, flags to 815): the block-per-alignment kernel, 64-512
//     threads x 4 cells.
//
//   k4_long_score           symbol windows, score + sink (and the tier
//                           taken, into a host int)
//   k4_long_score_packed    windows of the 2-bit packed genome, the same
//   k4_long_directions      symbol windows, score + sink + one flag byte
//                           per band cell, in the (nb, lp, 2w+1) layout
//   k4_wide_plan, k4_sweep_warps_per_sm  the tier of a score call, and
//                           the sweep's resident warps
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
// the band.  Blocks on the H100 run in no order, so the first design
// here (the block tier) gives one block one alignment and runs every row
// in a loop, with the band across its threads: thread t holds cells
// [t*CPT, t*CPT + CPT) of H and F in registers (NT x CPT is a
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
// Each row costs about 15 int32 ops per cell, one neighbour exchange and
// one block-wide scan (two __syncthreads), and the threads past the band
// and the cells left of column 0 hold nothing: at the PE --local rescue's
// 1 061 cells a 512-thread block ran at 4.4 % of its bound.
//
// The sweep tier (k4_sweep_kernel) turns the loop around for short
// patterns, as K5's column sweeps do (wavefront_gotoh.cu fb_sweep,
// bs_strip), with K4's contract: one warp owns one alignment, lane l
// holds R consecutive pattern rows in registers and works column j = s -
// l at step s, taking H and F of the row above from lane l - 1 by one
// shuffle.  E runs along the lane's own rows from column to column, so
// there is no in-row scan and no block barrier; each lane visits only its
// rows' band columns within 0..tlen, and the masks the plain version
// applies (E's start at a row's first valid column, NEG_INF above the
// band's right edge and left of column 0) are set on the steps where a
// lane meets them, a body without them running the rest.  The text
// symbol of a column is one byte load a lane a step (neighbouring lanes,
// neighbouring bytes) shared by its R rows; the substitution is one prmt
// into the row's byte table.  Eight alignments run a block, one a warp.
// Longer patterns keep the block kernel: strips of 128 rows on a warp
// each, joined by rings in shared memory as bs_strip's are, were timed
// against it and left out for want of a path that sends such calls
// (PERF.md).
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
// latency.  The sweep, at the rescue's 1 024 alignments (~8 warps an
// SM), is bound by the latency of its step: R rows of a dependent F ->
// Hhat -> H chain and a shuffle (PERF.md).

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

// the block tier: the smallest (threads x cells) shape that holds the band
template <bool PACKED, bool DIRS>
cudaError_t launch_block(const Args& a, int atype, cudaStream_t stream) {
  const int band = 2 * a.band_w + 1;
  if (band <= 256) return launch_atype<64, 4, PACKED, DIRS>(a, atype, stream);
  if (band <= 512) return launch_atype<128, 4, PACKED, DIRS>(a, atype, stream);
  if (band <= 1024) return launch_atype<256, 4, PACKED, DIRS>(a, atype, stream);
  if (band <= 2048) return launch_atype<512, 4, PACKED, DIRS>(a, atype, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The sweep tier: score-only bands past 128 cells at short patterns (where
// wide_plan takes them), one warp an alignment sweeping the text's columns.

// K4's tiers, as wide_plan reports them
enum Tier { TIER_GROUP = 0, TIER_SWEEP = 1, TIER_BLOCK = 2 };
// warps (alignments) a block of the sweep
constexpr int SW_WARPS = 8;
// pattern rows a lane of the sweep: 4 to Lp 128, 8 to Lp 256 (the most)
constexpr int SW_RPL = 4;
constexpr int SW_MAX_RPL = 8;

// The tier of a score-only call (flags keep the group and block tiers),
// its rows a lane (the sweep) and its warps a block, chosen by timing the
// sweep against the block kernel on an H100 (PERF.md): bands up to 128
// cells the group kernel; wider bands the sweep where one warp holds the
// pattern, at 4 rows a lane to Lp 128 and 8 to 256; longer patterns the
// block kernel.  Symbol and packed windows take the same tiers.
// ops/long_dp.py wide_plan mirrors it; the score entries launch by it and
// report the tier they took.  Returns false past the widest band.
bool wide_plan(int lp, int band_w, int* tier, int* rpl, int* warps) {
  const int band = 2 * band_w + 1;
  *rpl = 0;
  *warps = 0;
  if (band_w < 0 || band > 2048) return false;
  if (band <= grp::MAX_CELLS) {
    *tier = TIER_GROUP;
  } else if (lp <= 32 * SW_MAX_RPL) {
    *tier = TIER_SWEEP;
    *rpl = lp <= 32 * SW_RPL ? SW_RPL : SW_MAX_RPL;
    *warps = SW_WARPS;
  } else {
    *tier = TIER_BLOCK;
  }
  return true;
}

// One alignment on one warp, its pattern within the warp's 32 R rows
// (wide_plan).  Lane l holds pattern rows r0 .. r0 + R - 1 (r0 = R l + 1)
// in registers and works column j = jbase + s - l at step s, one step
// behind lane l - 1, whose last row's H and F at column j it takes by one
// shuffle; lane 0 takes row 0.  Each lane computes only its rows' band
// columns lo .. hi (from row r0's entry column r0 - w to its last row + w,
// within 0 .. tlen), so no chain runs past its band; an out-of-band
// value, which the R rows of a lane produce on the R - 1 columns where
// some of them lie outside the band, feeds no in-band cell and no sink.
// Per row it keeps H and Hhat of the previous column and G = E + j ee, so
// that E and H cost one DPX operation each: G(j) = max(Hhat(j-1) + j ee - (eo + ee), G(j-1)),
// H = max(G - j ee, Hhat).  The plain version's masks, x = j - r: at x ==
// -w and at j == 0 (the row's first valid column) E is NEG_INF - (eo +
// ee) (its cumulative max over masked cells) and the diagonal of j == 0
// is NEG_INF; at x == w the cell above lies outside the band (NEG_INF
// for H and F).  Every valid cell is reachable from row 0 and so finite:
// NEG_INF-derived values meet only invalid cells, which the plain version
// masks.  The steps where no lane meets a mask run a body without them,
// and those past every lane's entry a body with the exit masks alone.
// Sinks into ``best``: LOCAL every row's first maximum (rows folded by
// better()); SEMI_GLOBAL row plen's first maximum (in the lane that holds
// it); GLOBAL row plen at column tlen (into ``goal``).
template <int R, int ATYPE, bool PACKED, bool LUT>
__device__ __forceinline__ void sweep_warp(const Args& a, int b, int lane,
                                           Best& best, int& goal) {
  const Scheme sc = a.sc;
  const int w = a.band_w, lp = a.lp;
  const int plen = a.plens[b], tlen = a.tlens[b];
  // score-only: to the pattern's end, within 32 R rows (wide_plan)
  const int R_all = max(min(plen, lp), 0);
  if (R_all <= 0) return;
  const int8_t* pat = a.pats + static_cast<int64_t>(b) * lp;
  const uint8_t* qual = a.quals + static_cast<int64_t>(b) * lp;
  const int64_t ws = PACKED ? a.win_start[b] : 0;
  const int nl = (R_all + R - 1) / R;  // lanes with a row
  const int r0 = lane * R + 1;
  const bool has_rows = lane < nl;
  const int lo = max(0, r0 - w);
  const int hi = min(tlen, min(r0 + R - 1, R_all) + w);
  const int j0 = max(0, 1 - w);          // lane 0's first column
  const int jmax = min(tlen, R_all + w);  // the last lane's last
  const int jbase = j0 - 1;  // lane 0's column at step 0, which only fetches
  const int nsteps = jmax < j0 ? 0 : jmax - jbase + nl;
  // the body: steps at which every lane with a row has all its rows in the
  // band, past their entry column and column 0, short of the x == w edge
  // and of tlen
  const int sb = max(nl * R + 1 - w, 1) - jbase + nl - 1;
  const int se = max(min(tlen, w) - jbase + 1, sb);
  const int eoe = sc.eo + sc.ee, foe = sc.fo + sc.fe;
  const int EENTRY = NEG_INF - eoe;
  const int FEDGE = max(NEG_INF - foe, NEG_INF - sc.fe);
  const int nn = -sc.n_penalty;

  // the row's substitution: with LUT, its byte table (lut_row); else its
  // symbol (99 for N: it equals no text symbol) and minus its mismatch
  // penalty (minus n_penalty for N)
  int P[R], Q[R], Hp[R], Hh[R], G[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + i;
    int p = PAD_SYMBOL, mm = 0;
    if (r <= R_all) {
      p = __ldg(pat + r - 1);
      const int q = min(static_cast<int>(__ldg(qual + r - 1)), 40);
      mm = sc.mm_min + floor_div40((sc.mm_max - sc.mm_min) * q);
    }
    if (LUT) {
      const uint2 t = grp::lut_row(p, mm, sc);
      P[i] = static_cast<int>(t.x);
      Q[i] = static_cast<int>(t.y);
    } else {
      P[i] = p >= 4 ? 99 : p;
      Q[i] = p >= 4 ? nn : -mm;
    }
    Hp[i] = NEG_INF;
    Hh[i] = NEG_INF;
    G[i] = EENTRY;
  }
  constexpr int NSINK = ATYPE == LOCAL ? R : 1;
  int bh[NSINK], bj[NSINK];
#pragma unroll
  for (int i = 0; i < NSINK; ++i) {
    bh[i] = 0;
    bj[i] = 0;
  }
  int sbh = INT_MIN, sbj = 0;  // SEMI_GLOBAL: row plen's first maximum
  // row plen's lane and slot, where the pattern reaches it
  const int lsink = plen >= 1 && plen <= R_all ? (plen - 1) / R : -1;
  const int ip = (plen - 1) & (R - 1);
  const int k_goal = tlen - plen + w;
  const int jgoal = k_goal >= 0 && k_goal <= 2 * w ? tlen : INT_MIN;
  int oh = NEG_INF, of = NEG_INF;  // the lane's last row's H and F
  int up_prev = NEG_INF;  // the vertical input of the step before
  int tcur;               // the text symbol of the step's column
  {
    const int j = jbase - lane;
    tcur = text_symbol<PACKED>(a, b, ws, j - 1, tlen);
  }
  // j * ee - (eo + ee) and -j * ee of the step's column, carried from step
  // to step (opaque to the compiler, which would otherwise fold -j * ee
  // into an IMAD and split H's DPX operation in two)
  int cj = (jbase - 1 - lane) * sc.ee - eoe;
  int mj = -(jbase - 1 - lane) * sc.ee;

  // a step in one of three forms: BODY (no mask: every lane with a row
  // has all its rows in the band, short of tlen), EXIT (every lane past
  // its rows' entry columns and column 0: lanes leave at hi, rows at the
  // x == w edge) and MASKED (every mask)
  enum { BODY, EXIT, MASKED };
  auto step = [&](int s, auto mode_tag) {
    constexpr int MODE = decltype(mode_tag)::value;
    const int j = jbase + s - lane;
    cj += sc.ee;
    mj -= sc.ee;
    asm volatile("" : "+r"(cj), "+r"(mj));
    int uh = __shfl_up_sync(FULL, oh, 1);
    int uf = __shfl_up_sync(FULL, of, 1);
    if (lane == 0) {  // row 0
      uh = (MODE == MASKED && j < 0)
               ? NEG_INF
               : (ATYPE == GLOBAL && j > 0 ? -sc.eo - sc.ee * j : 0);
      uf = NEG_INF;
    }
    int diag = up_prev;
    up_prev = uh;
    const int ts = tcur;
    tcur = text_symbol<PACKED>(a, b, ws, j, tlen);
    if (MODE == MASKED && !(has_rows && j >= lo && j <= hi)) return;
    if (MODE == EXIT && !(has_rows && j <= hi)) return;
    unsigned sel = 0;
    int mv = 0;
    bool tn = false;
    if (LUT) {
      sel = grp::lut_selector(ts);
    } else {
      tn = ts >= 4;
      mv = tn ? nn : sc.match;
    }
    int xa = 0, xc = 0, gent = 0;
    if (MODE != BODY) xc = j - r0 - w;  // row i is at x == w when xc == i
    if (MODE == MASKED) {
      xa = j - r0 + w;  // and at x == -w when xa == i
      gent = EENTRY - mj;
      if (j == 0) diag = NEG_INF;
    }
    int hs = NEG_INF;
    bool hs_in = MODE == BODY;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      int F = __viaddmax_s32(uh, -foe, uf - sc.fe);
      if (MODE != BODY && xc == i) F = FEDGE;
      const int sub =
          LUT ? grp::lut_score(static_cast<unsigned>(P[i]),
                               static_cast<unsigned>(Q[i]), sel)
              : ((P[i] == ts || tn) ? mv : Q[i]);
      const int hh = ATYPE == LOCAL ? __viaddmax_s32_relu(diag, sub, F)
                                    : __viaddmax_s32(diag, sub, F);
      int g = __viaddmax_s32(Hh[i], cj, G[i]);
      if (MODE == MASKED && (xa == i || j == 0)) g = gent;
      const int H = __viaddmax_s32(g, mj, hh);  // LOCAL: hh >= 0 already
      diag = Hp[i];
      Hp[i] = H;
      Hh[i] = hh;
      G[i] = g;
      const bool inb = MODE == BODY || (xc <= i && (MODE == EXIT || xa >= i));
      if constexpr (ATYPE == LOCAL) {
        if (inb && H > bh[i]) {
          bh[i] = H;
          bj[i] = j;
        }
      } else if (i == ip) {
        hs = H;
        hs_in = inb;
      }
      uh = H;
      uf = F;
    }
    oh = uh;
    of = uf;
    if constexpr (ATYPE != LOCAL) {
      if (lane == lsink) {
        if (ATYPE == GLOBAL) {
          if (j == jgoal) goal = hs;
        } else if (hs_in && hs > sbh) {
          sbh = hs;
          sbj = j;
        }
      }
    }
  };

  for (int s = 0; s < nsteps;) {  // chunks of 32 steps
    const int e = min(s + 32, nsteps);
    if (s >= sb && e <= se) {
      for (; s < e; ++s) step(s, std::integral_constant<int, BODY>{});
    } else if (s >= sb) {
      for (; s < e; ++s) step(s, std::integral_constant<int, EXIT>{});
    } else {
      for (; s < e; ++s) step(s, std::integral_constant<int, MASKED>{});
    }
  }

  if constexpr (ATYPE == LOCAL) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = r0 + i;
      const Best c{bh[i], r, bj[i] - r + w};
      if (has_rows && r <= R_all && bh[i] > 0 && better(c, best)) best = c;
    }
  } else if constexpr (ATYPE == SEMI_GLOBAL) {
    const Best c{sbh, plen, sbj - plen + w};
    if (lane == lsink && sbh != INT_MIN && better(c, best)) best = c;
  }
}

// The outputs of one alignment from its sink (reduced over its lanes):
// the Pallas contract, as long_gotoh_kernel writes them.  SEMI_GLOBAL's
// max runs over the whole band in the plain version: row plen's first
// invalid cell (j < 0 or j > tlen) holds NEG_INF and competes too.
template <int ATYPE>
__device__ __forceinline__ void sweep_out(const Args& a, int b, Best best,
                                          int goal) {
  const int w = a.band_w, lp = a.lp;
  const int plen = a.plens[b], tlen = a.tlens[b];
  int score, best_i, best_k;
  if (ATYPE == LOCAL) {
    score = best.v;
    best_i = best.r;
    best_k = best.k;
  } else if (plen >= 1 && plen <= lp) {
    if (ATYPE == SEMI_GLOBAL) {
      const int jl = plen - w;  // the row's column at k = 0
      const int k_inv = (jl < 0 || jl > tlen) ? 0 : tlen + 1 - jl;
      if (k_inv <= 2 * w && better(Best{NEG_INF, plen, k_inv}, best))
        best = Best{NEG_INF, plen, k_inv};
      score = best.v;
      best_k = best.k;
    } else {  // NEG_INF when the goal cell is outside the band
      score = goal;
      best_k = tlen - plen + w;
    }
    best_i = plen;
  } else {
    score = NEG_INF;
    best_i = 0;
    best_k = w;
  }
  if (score < SCORE_FLOOR) score = NEG_INF;
  if (plen <= 0) {
    score = ATYPE == LOCAL ? 0 : NEG_INF;
    best_i = 0;
    best_k = w;
  }
  a.out[b] = score;
  a.out[a.nb + b] = best_i;
  a.out[2 * a.nb + b] = max(best_i + best_k - w, 0);
}

// One warp an alignment, blockDim / 32 alignments a block.
template <int R, int ATYPE, bool PACKED, bool LUT>
__global__ void __launch_bounds__(SW_WARPS * 32) k4_sweep_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= a.nb) return;  // the whole warp
  Best best = ATYPE == LOCAL ? Best{0, 0, a.band_w}  // no positive cell
                             : Best{INT_MIN, INT_MAX, INT_MAX};
  int goal = NEG_INF;
  sweep_warp<R, ATYPE, PACKED, LUT>(a, b, lane, best, goal);
  if (ATYPE == GLOBAL) {
    goal = __reduce_max_sync(FULL, goal);
  } else {
    best = warp_best(best);
  }
  if (lane != 0) return;
  sweep_out<ATYPE>(a, b, best, goal);
}

template <int R, int ATYPE, bool PACKED>
cudaError_t launch_sweep_atype(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.nb + SW_WARPS - 1) / SW_WARPS), block(32 * SW_WARPS);
  if (grp::lut_ok(a.sc))
    k4_sweep_kernel<R, ATYPE, PACKED, true><<<grid, block, 0, stream>>>(a);
  else
    k4_sweep_kernel<R, ATYPE, PACKED, false><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int R, bool PACKED>
cudaError_t launch_sweep(const Args& a, int atype, cudaStream_t stream) {
  switch (atype) {
    case GLOBAL:
      return launch_sweep_atype<R, GLOBAL, PACKED>(a, stream);
    case SEMI_GLOBAL:
      return launch_sweep_atype<R, SEMI_GLOBAL, PACKED>(a, stream);
    case LOCAL:
      return launch_sweep_atype<R, LOCAL, PACKED>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// score-only on wide_plan's tier, written to *tier (a host int) before
// the launch
template <bool PACKED>
cudaError_t launch_score(const Args& a, int atype, int* tier,
                         cudaStream_t stream) {
  int rpl = 0, warps = 0;
  if (!wide_plan(a.lp, a.band_w, tier, &rpl, &warps))
    return cudaErrorInvalidValue;
  if (a.nb == 0) return cudaSuccess;
  switch (*tier) {
    case TIER_GROUP:
      return grp::launch<PACKED, false>(a, atype, stream);
    case TIER_SWEEP:
      return rpl == SW_RPL ? launch_sweep<SW_RPL, PACKED>(a, atype, stream)
                           : launch_sweep<SW_MAX_RPL, PACKED>(a, atype, stream);
    default:
      return launch_block<PACKED, false>(a, atype, stream);
  }
}

// with flags: up to 128 cells the sub-warp groups, above the block tier;
// the wrapper rejects bands wider than the widest
cudaError_t launch_dirs(const Args& a, int atype, cudaStream_t stream) {
  if (a.nb == 0) return cudaSuccess;
  if (2 * a.band_w + 1 <= grp::MAX_CELLS)
    return grp::launch<false, true>(a, atype, stream);
  return launch_block<false, true>(a, atype, stream);
}

}  // namespace

extern "C" {

// All pointers are device pointers but ``tier``, a host int that receives
// the tier the call takes (wide_plan's Tier); out is (3, nb) int32.  The
// argument lists are those of banded_gotoh.cu's k1/k3 entry points with
// ``tier`` after out.  Returns the cudaError_t of the launch (0 on
// success).
int k4_long_score(const void* pats, const void* quals, const void* plens,
                  const void* texts, const void* tlens, int nb, int lp, int lt,
                  int band_w, int atype, int match, int mm_min, int mm_max,
                  int n_penalty, int eo, int ee, int fo, int fe, void* out,
                  void* tier, void* stream) {
  Args a = make_args(pats, quals, plens, tlens, nb, lp, band_w, match, mm_min,
                     mm_max, n_penalty, eo, ee, fo, fe, out);
  a.texts = static_cast<const int8_t*>(texts);
  a.lt = lt;
  return static_cast<int>(launch_score<false>(
      a, atype, static_cast<int*>(tier), static_cast<cudaStream_t>(stream)));
}

int k4_long_score_packed(const void* pats, const void* quals,
                         const void* plens, const void* gwords,
                         long long n_words, const void* win_start,
                         const void* tlens, int nb, int lp, int band_w,
                         int atype, int match, int mm_min, int mm_max,
                         int n_penalty, int eo, int ee, int fo, int fe,
                         void* out, void* tier, void* stream) {
  Args a = make_args(pats, quals, plens, tlens, nb, lp, band_w, match, mm_min,
                     mm_max, n_penalty, eo, ee, fo, fe, out);
  a.gwords = static_cast<const int32_t*>(gwords);
  a.n_words = n_words;
  a.win_start = static_cast<const int64_t*>(win_start);
  return static_cast<int>(launch_score<true>(
      a, atype, static_cast<int*>(tier), static_cast<cudaStream_t>(stream)));
}

// The tier a score-only call of this shape takes, into plan[0..2]: tier
// (0 group, 1 sweep, 2 block), rows a lane and warps a block (the sweep;
// 0 otherwise).  Returns a cudaError_t (invalid past the widest band).
int k4_wide_plan(int lp, int band_w, void* plan) {
  int* const p = static_cast<int*>(plan);
  return wide_plan(lp, band_w, p, p + 1, p + 2)
             ? static_cast<int>(cudaSuccess)
             : static_cast<int>(cudaErrorInvalidValue);
}

// Warps an SM keeps resident of the sweep's kernel that a score-only call
// of this shape and alignment type takes (wide_plan's; symbol windows,
// the byte table); 0 off the sweep, -1 on a CUDA error.
int k4_sweep_warps_per_sm(int lp, int band_w, int atype) {
  int tier = 0, rpl = 0, warps = 0, per_sm = 0;
  if (!wide_plan(lp, band_w, &tier, &rpl, &warps) || tier != TIER_SWEEP)
    return 0;
  auto blocks = [&](auto kernel) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         32 * warps, 0);
  };
  const bool r4 = rpl == SW_RPL;
  cudaError_t err;
  switch (atype) {
    case GLOBAL:
      err = r4 ? blocks(k4_sweep_kernel<SW_RPL, GLOBAL, false, true>)
               : blocks(k4_sweep_kernel<SW_MAX_RPL, GLOBAL, false, true>);
      break;
    case SEMI_GLOBAL:
      err = r4 ? blocks(k4_sweep_kernel<SW_RPL, SEMI_GLOBAL, false, true>)
               : blocks(k4_sweep_kernel<SW_MAX_RPL, SEMI_GLOBAL, false, true>);
      break;
    case LOCAL:
      err = r4 ? blocks(k4_sweep_kernel<SW_RPL, LOCAL, false, true>)
               : blocks(k4_sweep_kernel<SW_MAX_RPL, LOCAL, false, true>);
      break;
    default:
      return -1;
  }
  return err == cudaSuccess ? per_sm * warps : -1;
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
      launch_dirs(a, atype, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
