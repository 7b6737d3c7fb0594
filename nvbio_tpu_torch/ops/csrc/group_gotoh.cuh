// Band-parallel banded Gotoh in sub-warp groups, for bands up to 128
// cells: K1, K2 and K3 (banded_gotoh.cu, bands up to 64 cells) and K4's
// tiers up to 128 cells (long_gotoh.cu), score-only, over packed
// windows, and with flags.  One template, parameters G (lanes an alignment), CPT (cells a
// lane), the alignment type, PACKED and DIRS.
//
// What it computes is nvbio_tpu_torch/alignment/batched.py cell for cell,
// as banded_gotoh.cu and long_gotoh.cu do (their headers give the
// contract).  Design, for the H100:
//   - a group of G lanes owns one alignment, lane l cells [l*CPT,
//     l*CPT + CPT) of the band, with H, F and the text symbols under them
//     in registers; a 128-thread block holds 128 / G alignments, so the
//     32-blocks-an-SM cap no longer limits the warps in flight, and a
//     small call (4 096 K2 winners) spreads over every SM (with_tier
//     gives G and CPT by band and by flags);
//   - nothing global sits on the row-to-row chain: every R rows the group
//     stages the next rows' pattern symbol, mismatch penalty (computed
//     once a row, not once a cell) and new text symbol in shared memory
//     from registers loaded a chunk ahead;
//   - text: cell k's symbol at row r + 1 is cell k + 1's at row r, so the
//     symbols slide one cell a row, one __shfl_down a lane, and the
//     group's last lane takes the staged new symbol;
//   - E: with A[k] = Hhat_m[k-1] - (eo+ee), E[k] = max_{j<=k}(A[j] +
//     j*ee) - k*ee, a prefix max; each lane folds its own cells' A[k+1]
//     terms (so no lane needs its left neighbour's Hhat), then one
//     exclusive max-scan over the group (log2 G + 1 shuffles).  Integer
//     max is associative: the values equal the sequential recurrence;
//   - Hopper's DPX forms fold two operations into one instruction:
//     __viaddmax_s32 for F and for the E terms, __vimax3_s32 /
//     __vimax_s32_relu for LOCAL's clamps; the substitution score is one
//     prmt into a per-row byte table (lut_row) when the scheme's scores
//     fit a signed byte, the compare-and-select form otherwise;
//   - validity is one unsigned compare a cell against the row's column
//     range; every lane of a warp runs the same rows (a group past the
//     batch idles through them), so shuffles take the whole warp, which
//     costs fewer instructions than a group mask;
//   - flags: each row's 2w+1 bytes go to a shared buffer laid out as the
//     (nb, lp, 2w+1) rows are in device memory, and every R rows the
//     group writes the run (R rows of one alignment are contiguous) with
//     16-byte stores, the shared copy offset to the destination's
//     alignment; only the unaligned head and tail go byte by byte.

#pragma once

#include <limits.h>

#include <type_traits>

#include "gotoh_common.cuh"

namespace {
namespace grp {

constexpr int NT = 128;  // threads a block
constexpr int R = 16;    // rows a staging chunk

// window-relative text symbol m of alignment b; PAD outside the window
// (those cells are masked, except m = -1 under j = 0, which scores as N
// like the plain version's PAD padding)
template <bool PACKED>
__device__ __forceinline__ int text_symbol(const Args& a, int b, int64_t ws,
                                           int m, int tlen) {
  if (PACKED) {
    if (m < 0 || m >= tlen) return PAD_SYMBOL;
    const int64_t idx = ws + m;
    const int64_t w = idx >> 4;
    if (w >= a.n_words) return PAD_SYMBOL;
    const uint32_t word = static_cast<uint32_t>(__ldg(a.gwords + w));
    return static_cast<int>((word >> (2 * (idx & 15))) & 3u);
  }
  if (m < 0 || m >= a.lt) return PAD_SYMBOL;
  return __ldg(a.texts + static_cast<int64_t>(b) * a.lt + m);
}

// The substitution score as a byte table: LUT[i] for text index i, 0-3
// the bases, 4 an N (any symbol >= 4), 5 a symbol below 0 (outside the
// contract: it never equals a base); prmt picks byte i of {hi:lo} and,
// with the selector's high bit set, sign-extends it, so a cell's score is
// one instruction.  Needs every score in a signed byte (lut_fits).
__device__ __forceinline__ unsigned lut_selector(int t) {
  const unsigned i = t < 0 ? 5u : (t >= 4 ? 4u : static_cast<unsigned>(t));
  return i * 0x1111u | 0x8880u;
}

__device__ __forceinline__ int lut_score(unsigned lo, unsigned hi,
                                         unsigned sel) {
  int r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
  return r;
}

// the table of a pattern symbol p at mismatch penalty mm: {lo, hi}
__device__ __forceinline__ uint2 lut_row(int p, int mm, const Scheme& sc) {
  const unsigned nmm = static_cast<unsigned>(-mm) & 0xffu;
  const unsigned nn = static_cast<unsigned>(-sc.n_penalty) & 0xffu;
  if (p >= 4) return make_uint2(nn * 0x01010101u, nn * 0x01010101u);
  unsigned lo = nmm * 0x01010101u;
  if (p >= 0)
    lo = (lo & ~(0xffu << (8 * p))) |
         ((static_cast<unsigned>(sc.match) & 0xffu) << (8 * p));
  return make_uint2(lo, nn | nmm << 8);
}

inline bool lut_fits(int v) { return v >= -128 && v <= 127; }

// whether every substitution score of the scheme fits lut_row's bytes
// (mm runs from mm_min to mm_max over the qualities)
inline bool lut_ok(const Scheme& sc) {
  return lut_fits(sc.match) && lut_fits(-sc.mm_min) &&
         lut_fits(-sc.mm_max) && lut_fits(-sc.n_penalty);
}

// a sink candidate: higher score first, then lower row, then lower k
struct Best {
  int v, r, k;
};

__device__ __forceinline__ bool better(const Best& x, const Best& y) {
  return x.v > y.v || (x.v == y.v && (x.r < y.r || (x.r == y.r && x.k < y.k)));
}

constexpr unsigned FULL = 0xffffffffu;

template <int G>
__device__ __forceinline__ Best group_best(Best x) {
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1) {
    const Best o = {__shfl_xor_sync(FULL, x.v, d, G),
                    __shfl_xor_sync(FULL, x.r, d, G),
                    __shfl_xor_sync(FULL, x.k, d, G)};
    if (better(o, x)) x = o;
  }
  return x;
}

template <int G, int CPT, int ATYPE, bool PACKED, bool DIRS, bool LUT>
__global__ void __launch_bounds__(NT) group_gotoh_kernel(const Args a) {
  constexpr int NGRP = NT / G;
  constexpr int Q = (R + G - 1) / G;  // staged rows a lane loads
  // per row: with LUT, x, y = the substitution table (lut_row), else
  // x = the pattern symbol (99 for N: it matches no text symbol), y =
  // minus the mismatch penalty (minus n_penalty for N); z = the text
  // symbol the last lane takes at the row's end (as a LUT selector)
  __shared__ __align__(16) int4 sh_row[NGRP][R];
  __shared__ __align__(16) uint8_t
      sh_flag[DIRS ? NGRP : 1][DIRS ? R * G * CPT + 16 : 16];

  const int slot = threadIdx.x / G, lane = threadIdx.x % G;
  // every lane of a warp runs the same rows, so shuffles and syncs take
  // the whole warp (a partial mask costs extra instructions a row): a
  // group past the batch runs the last alignment and writes nothing
  const int b_live = blockIdx.x * NGRP + slot;
  if (__all_sync(FULL, b_live >= a.nb)) return;
  const bool live = b_live < a.nb;
  const int b = live ? b_live : a.nb - 1;
  const Scheme sc = a.sc;
  const int w = a.band_w;
  const int band = 2 * w + 1;
  const int lp = a.lp;
  const int plen = a.plens[b];
  const int tlen = a.tlens[b];
  const int8_t* pat = a.pats + static_cast<int64_t>(b) * lp;
  const uint8_t* qual = a.quals + static_cast<int64_t>(b) * lp;
  const int64_t ws = PACKED ? a.win_start[b] : 0;
  const int k0 = lane * CPT;  // this lane's first band cell
  const int eoe = sc.eo + sc.ee, foe = sc.fo + sc.fe;
  const int nfe = -sc.fe, nn = -sc.n_penalty;

  int H[CPT], F[CPT], T[CPT], kee[CPT], cA[CPT];
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
    T[c] = grp::text_symbol<PACKED>(a, b, ws, k - w, tlen);  // row 0
    if (LUT) T[c] = static_cast<int>(lut_selector(T[c]));
    kee[c] = k * sc.ee;
    cA[c] = (k + 1) * sc.ee - eoe;  // A[k + 1] = Hhat_m[k] - (eo + ee)
  }
  // SEMI_GLOBAL / GLOBAL: this lane's candidate from row plen; LOCAL:
  // its best cell so far (strict >: the earliest row, then the lowest k)
  Best mine = ATYPE == LOCAL ? Best{0, 0, w}
                             : Best{ATYPE == GLOBAL ? NEG_INF : NEG_INF - 1,
                                    0, INT_MAX};
  const int k_goal = tlen - plen + w;

  // score-only kernels stop at the longest pattern's end in the warp
  // (the rows past a pattern's end change none of its outputs); the flag
  // kernel fills every row, like the plain version
  const int n_rows =
      DIRS ? lp : __reduce_max_sync(FULL, max(min(plen, lp), 0));
  int pf_p[Q], pf_q[Q], pf_t[Q];
  auto prefetch = [&](int r0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = r0 + lane + q * G;
      const bool in = lane + q * G < R && i < n_rows;
      pf_p[q] = in ? pat[i] : PAD_SYMBOL;
      pf_q[q] = in ? qual[i] : 0;
      pf_t[q] = in ? grp::text_symbol<PACKED>(a, b, ws, i + G * CPT - w,
                                              tlen)
                   : PAD_SYMBOL;
    }
  };
  prefetch(0);

  for (int r0 = 0; r0 < n_rows; r0 += R) {
    __syncwarp();  // the previous chunk's reads and flush are done
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int rr = lane + q * G;
      if (rr < R) {
        const int mm = sc.mm_min + floor_div40((sc.mm_max - sc.mm_min) *
                                               min(pf_q[q], 40));
        const bool n = pf_p[q] >= 4;
        const uint2 lut = lut_row(pf_p[q], mm, sc);
        sh_row[slot][rr] =
            LUT ? make_int4(static_cast<int>(lut.x), static_cast<int>(lut.y),
                            static_cast<int>(lut_selector(pf_t[q])), 0)
                : make_int4(n ? 99 : pf_p[q], n ? nn : -mm, pf_t[q], 0);
      }
    }
    __syncwarp();
    prefetch(r0 + R);  // lands while this chunk's rows run
    const int nr = min(R, n_rows - r0);
    uint8_t* fbuf = nullptr;
    int foff = 0;
    if (DIRS) {
      const uintptr_t dst = reinterpret_cast<uintptr_t>(
          a.dirs + (static_cast<int64_t>(b) * lp + r0) * band);
      foff = static_cast<int>(dst & 15);
      fbuf = sh_flag[slot] + foff;
    }

    for (int rr = 0; rr < nr; ++rr) {
      const int4 in = sh_row[slot][rr];
      const int pe = in.x, nmm = in.y;
      const int row = r0 + rr + 1;
      // the previous row's H, F of cell k0 + CPT (the next lane's first)
      int nxt_h = __shfl_down_sync(FULL, H[0], 1, G);
      int nxt_f = __shfl_down_sync(FULL, F[0], 1, G);
      if (lane == G - 1) nxt_h = nxt_f = NEG_INF;
      // cell k is valid iff 0 <= j <= min(tlen, row + w), j = row - w + k
      // (none is when that limit is negative)
      const int jl = min(tlen, row + w);
      const int jb = jl < 0 ? -CPT - 1 : row - w + k0;
      const unsigned jlim = static_cast<unsigned>(max(jl, 0));

      int hh[CPT], hd[CPT], fo[CPT], fn[CPT], pre[CPT];
      bool v[CPT];
      int run = INT_MIN;  // max of this lane's A[k + 1] + (k + 1) * ee
      int hm_last = NEG_INF;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int t = T[c];
        const int s = LUT ? lut_score(static_cast<unsigned>(pe),
                                      static_cast<unsigned>(nmm),
                                      static_cast<unsigned>(t))
                          : (t == pe ? sc.match : (t >= 4 ? nn : nmm));
        const int up_h = c + 1 < CPT ? H[c + 1] : nxt_h;
        const int up_f = c + 1 < CPT ? F[c + 1] : nxt_f;
        fo[c] = up_h - foe;
        fn[c] = __viaddmax_s32(up_f, nfe, fo[c]);
        hd[c] = H[c] + s;
        hh[c] = ATYPE == LOCAL ? __vimax3_s32(hd[c], fn[c], 0)
                               : max(hd[c], fn[c]);
        v[c] = static_cast<unsigned>(jb + c) <= jlim;
        pre[c] = run;
        const int hm = v[c] ? hh[c] : NEG_INF;
        run = __viaddmax_s32(hm, cA[c], run);
        hm_last = hm;
      }
      // the exclusive scan over the group: A[0] .. A[k0] (A[0], under
      // j = -1, is NEG_INF - (eo + ee)); a lane below d reads its own
      // value back, so each step is one shuffle and one max
      int excl = __shfl_up_sync(FULL, run, 1, G);
      if (lane == 0) excl = NEG_INF - eoe;
#pragma unroll
      for (int d = 1; d < G; d <<= 1)
        excl = max(excl, __shfl_up_sync(FULL, excl, d, G));
      // DIRS: Hhat_m of cell k0 - 1, for cell k0's E-open bit
      int hm_prev = NEG_INF;
      if (DIRS) {
        hm_prev = __shfl_up_sync(FULL, hm_last, 1, G);
        if (lane == 0) hm_prev = NEG_INF;
      }

#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int k = k0 + c;
        const int e = max(excl, pre[c]) - kee[c];
        int h_new = ATYPE == LOCAL ? __vimax_s32_relu(hh[c], e)
                                   : max(hh[c], e);
        h_new = v[c] ? h_new : NEG_INF;
        // F of an invalid cell reaches only invalid cells (the same column
        // a row down), so the score kernels keep it unmasked; the flags
        // compare the masked value, as the plain version does
        const int f_m = DIRS && !v[c] ? NEG_INF : fn[c];
        if (DIRS) {  // computed for every cell, stored for k < band
          const int e_m = v[c] ? e : NEG_INF;
          const int a_open = hm_prev - eoe;
          int flag = h_new == hd[c] ? 0 : (h_new == e_m ? 1 : 2);
          if (ATYPE == LOCAL && h_new <= 0) flag = 3;
          if (!v[c]) flag = 3;
          flag |= (e_m == a_open) << 2;
          flag |= (f_m == fo[c]) << 3;
          if (k < band) fbuf[rr * band + k] = static_cast<uint8_t>(flag);
        }
        if (DIRS) hm_prev = v[c] ? hh[c] : NEG_INF;
        H[c] = h_new;
        F[c] = f_m;
        if (ATYPE == LOCAL && row <= plen && k < band && h_new > mine.v)
          mine = {h_new, row, k};
      }
      if (ATYPE != LOCAL && row == plen) {  // the sink row, once
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int k = k0 + c;
          if (k >= band) continue;
          if (ATYPE == GLOBAL) {
            if (k == k_goal) mine.v = H[c];
          } else if (H[c] > mine.v) {  // strict: the lowest k wins ties
            mine.v = H[c];
            mine.k = k;
          }
        }
      }
      // slide the text one cell: cell k takes cell k + 1's symbol
      const int t_in = __shfl_down_sync(FULL, T[0], 1, G);
#pragma unroll
      for (int c = 0; c + 1 < CPT; ++c) T[c] = T[c + 1];
      T[CPT - 1] = lane == G - 1 ? in.z : t_in;
    }

    if (DIRS) {  // rows r0 .. r0 + nr - 1 of alignment b are contiguous
      __syncwarp();
      uint8_t* dst = a.dirs + (static_cast<int64_t>(b) * lp + r0) * band;
      const int n = nr * band;
      const int head = min(n, (16 - foff) & 15);
      const int nvec = live ? (n - head) >> 4 : 0;
      for (int i = lane; i < head && live; i += G) dst[i] = fbuf[i];
      const uint4* src4 = reinterpret_cast<const uint4*>(fbuf + head);
      uint4* dst4 = reinterpret_cast<uint4*>(dst + head);
      for (int i = lane; i < nvec; i += G) dst4[i] = src4[i];
      for (int i = head + (nvec << 4) + lane; i < n && live; i += G)
        dst[i] = fbuf[i];
    }
  }

  const Best top = group_best<G>(mine);
  if (lane != 0 || !live) return;
  int best, best_i, best_k;
  if (ATYPE == LOCAL) {
    best = top.v;
    best_i = top.r;
    best_k = top.k;
  } else if (plen >= 1 && plen <= lp) {
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

template <int V>
using Int = std::integral_constant<int, V>;

// The tiers, chosen by measurement (PERF.md §6).  With flags, a band
// of up to 16 / 32 / 64 / 128 cells runs G = 4 / 8 / 16 / 32 lanes x
// CPT = 4 cells: the flag calls are small (4 096 K2 winners, 1 024
// long-read lanes), so more lanes an alignment keep more warps in
// flight.  Score-only, CPT = 8 cells (G = 4 / 4 / 8 / 16) halves the
// per-row shuffles and staging for each cell, and the calls are large
// enough (8 192 long-read lanes, 14 336 rescue chunks; K1/K3's 32 767
// extension lanes) to fill the SMs at half the warps.  For K1/K3, 4 x 8
// beat 2 x 16 and 8 x 4 at 31 cells (8 x 4 tied on the extension call's
// ~5 000 live lanes), and 8 x 8 beat 4 x 16 at 63 (PERF.md §6).
// MAX_CELLS is the widest band of the design; a caller's MAXC (64 for
// K1-K3) leaves the wider tiers uninstantiated.
// Calls f(Int<G>, Int<CPT>) for the band's tier.
constexpr int MAX_CELLS = 128;

template <bool DIRS, int MAXC, class F>
cudaError_t with_tier(int band_w, F&& f) {
  const int band = 2 * band_w + 1;
  if (band > MAXC) return cudaErrorInvalidValue;
  if (band <= 16) return f(Int<4>(), Int<4>());
  if constexpr (DIRS) {
    if (band <= 32) return f(Int<8>(), Int<4>());
    if constexpr (MAXC > 64)
      if (band > 64) return f(Int<32>(), Int<4>());
    return f(Int<16>(), Int<4>());
  } else {
    if (band <= 32) return f(Int<4>(), Int<8>());
    if constexpr (MAXC > 64)
      if (band > 64) return f(Int<16>(), Int<8>());
    return f(Int<8>(), Int<8>());
  }
}

template <int G, int CPT, int ATYPE, bool PACKED, bool DIRS>
cudaError_t launch_tier_atype(const Args& a, cudaStream_t stream) {
  constexpr int NGRP = NT / G;
  const dim3 grid((a.nb + NGRP - 1) / NGRP), block(NT);
  if (lut_ok(a.sc))
    group_gotoh_kernel<G, CPT, ATYPE, PACKED, DIRS, true>
        <<<grid, block, 0, stream>>>(a);
  else
    group_gotoh_kernel<G, CPT, ATYPE, PACKED, DIRS, false>
        <<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool PACKED, bool DIRS, int MAXC = MAX_CELLS>
cudaError_t launch(const Args& a, int atype, cudaStream_t stream) {
  if (a.nb == 0) return cudaSuccess;
  return with_tier<DIRS, MAXC>(a.band_w, [&](auto g, auto c) {
    constexpr int G = decltype(g)::value, CPT = decltype(c)::value;
    switch (atype) {
      case GLOBAL:
        return launch_tier_atype<G, CPT, GLOBAL, PACKED, DIRS>(a, stream);
      case SEMI_GLOBAL:
        return launch_tier_atype<G, CPT, SEMI_GLOBAL, PACKED, DIRS>(a,
                                                                    stream);
      case LOCAL:
        return launch_tier_atype<G, CPT, LOCAL, PACKED, DIRS>(a, stream);
      default:
        return cudaErrorInvalidValue;
    }
  });
}

}  // namespace grp
}  // namespace
