// K7: the int16 masked banded Gotoh DP for Hopper (sm_90a).
//
//   k7_banded_score16   symbol windows, score + sink, int16 state
//       replaces nvbio_tpu/ops/banded_dp.py  banded_score_pallas_staged
//       with compute_dtype="int16" (_make_kernel_masked)
//
// What it computes is nvbio_tpu_torch/alignment/batched.py
// banded_score_batch16 (the plain version, an op-for-op int16
// transcription of the JAX kernel): the DP state in int16, masked cells
// pinned to NEG16 = -20000 every row, and K7's own output contract: a
// non-LOCAL end value at or below NEG16 / 2 is no path (NEG_INF), the
// SEMI_GLOBAL sink is the smallest k among the best cells of the last
// pattern row (k = 0 when no cell has a path), the GLOBAL sink the goal
// cell k = tlen - plen + w, the LOCAL sink the earliest row, then the
// smallest k.
//
// Design: the sub-warp group kernel of group_gotoh.cuh (K1-K4) on
// halfword pairs.
//   - a group of G lanes owns a PAIR of alignments, one in each halfword
//     of every state word (alignment 2p in the low, 2p + 1 in the high
//     half; an odd batch's last pair carries an empty second one); lane
//     l holds CPT consecutive band cells of both, with H, F and the text
//     under them in registers, so every step of the recurrence is one
//     DPX or logic instruction for two cells.  A 128-thread block holds
//     128 / G pairs.  The tier (G, CPT) goes by the live cells (below),
//     k7_plan: (4, 4) up to 16, then G = 4, 8, 16, 32 at 8 cells a lane
//     up to 256, then (32, 16) and (32, 24) up to 768.  No tier uses
//     device scratch.
//   - only the live band: cell k of row i holds column j = i + k - w,
//     valid only for j >= 0, and rows run to Lp8, so a cell below w - Lp8
//     is valid in no row.  The wrapper passes k_lo = max(0, w - Lp8)
//     (ops/banded_dp.py k7_live_range); the guard admits at most 736
//     cells from k_lo to 2w (Lp8 16, w 719).  The group covers cells
//     2w + 1 - G*CPT .. 2w, right-aligned, so the band's right edge is
//     the last lane's last cell and reads NEG16 above it, as the plain
//     version's padded band does.
//   - no masking in the recurrence: F takes max(., NEG16) (a free
//     operand of its first DPX op), so every H, F and Hhat stays >=
//     NEG16.  Inside the guard (int16_ok: every path score above -9000,
//     eo + ee + band * ee < 9000) a valid cell of SEMI_GLOBAL or GLOBAL
//     is reachable (> -9000), and a cell no path reaches stays between
//     NEG16 and NEG16 + Lp8 * match <= -11000.  An invalid cell feeds
//     only cells of its own column or further right (diagonal, F down
//     its column, E rightwards): those left of column 0 stay in that
//     dead range, those past tlen reach no valid cell, and the sinks
//     mask them.  LOCAL's zero clamp leaves the cells left of column 0
//     at 0 (their text is PAD, scored -n_penalty) and gives a cell past
//     tlen no strict gain over a valid cell at an earlier row or lower k,
//     so neither moves its sink.  Both arguments need the scheme's
//     convention, penalties >= 0 (alignment/types.py), and the guard's
//     bound needs mismatch_min <= mismatch_max (it reads mismatch_max as
//     the largest mismatch penalty); the wrapper checks both.  Cells left of the band (k < 0, in the first lanes when
//     the group is wider than the band) would take live values through
//     F from cell 0; where they can reach a column >= 0 (w < Lp8, tiers
//     up to 256 cells) their Hhat is pinned to NEG16 by a per-cell mask,
//     so they stay dead and feed E nothing.  PINC cells of a lane are
//     masked: 1 where one cell is left of the band (a band of 2^m - 1
//     cells: band_w 7, 15, 31, 63), else CPT.
//   - E as a group scan: with g[k] = max_{x < k}(Hhat[x] - (k - 1 - x) *
//     ee), E[k] = g[k] - (eo + ee) and g[k + 1] = max(g[k] - ee,
//     Hhat[k]), one __viaddmax_s16x2 a cell.  Each lane folds its cells
//     from a dead start into the g its cells give the next lane's first
//     cell, then one exclusive max-scan over the group moves those right,
//     each step a __shfl_up_sync and one __viaddmax_s16x2 that also
//     decays the value by d * CPT * ee (at G <= 4 one gather of the lanes
//     to the left, shuffled at once); the second pass folds again from
//     the lane's prefix and takes H = max(Hhat, g - (eo + ee)), one op
//     each.  Every value stays inside int16: Hhat >= NEG16, so every
//     lane's scan value is >= NEG16 and a step lowers it by at most
//     (G / 2) * CPT * ee < 9000 inside the guard.
//   - the substitution is two prmt byte-table lookups, one a half, and
//     one LOP3 that packs them: a row's table per alignment (pattern
//     symbol, quality-scaled mismatch, N) is 8 bytes, and the text word
//     of a cell is a selector taking byte t0 (sign-extended) into the
//     low half and byte t1 into the high half, so both lookups share it.
//     Schemes past a signed byte take the compare-and-select form
//     (__vcmpeq2, __vcmpgts2; 24 % slower at the row shape), which
//     such a scheme needs only at bands up to 53 cells (Plan), so only
//     the tiers up to 64 cells have it.
//   - nothing global on the row chain: every R rows the group stages
//     the next rows' tables and the text symbol that enters the band
//     from registers loaded a chunk ahead; the text slides one cell a
//     row (__shfl_down_sync, the group's last lane takes the new one).
//   - sinks, lane by lane, reduced over the group once at the end:
//     SEMI_GLOBAL's best cell of the row where a half's plen ends (cells
//     past tlen masked there), GLOBAL's goal cell, LOCAL's running best
//     (the lane's row maximum every row, its lowest k when it improves).
//
// What bounds it on the H100: integer instruction throughput.  A cell
// pair takes about 10 instructions (substitution 3, F 2, Hhat 1, E 3,
// text slide 1; a pinned cell 1 more) and a lane-row some 25 more for
// shuffles, the scan and staging; only the inputs and outputs move
// through device memory.  It runs at 31-54 % of that bound (PERF.md §6).

#include "group_gotoh.cuh"

namespace {
namespace k7 {

// threads a block, rows a staging chunk, the warp mask, the sink
// candidate and its group reduction: group_gotoh.cuh's
using grp::Best;
using grp::FULL;
using grp::NT;
using grp::R;
constexpr int NEG16 = -20000;
// non-LOCAL end values at or below this are no path
constexpr int DEAD16 = NEG16 / 2;

__host__ __device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xFFFFu) |
         (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ int half(uint32_t x, int h) {
  return static_cast<int16_t>(h ? (x >> 16) : (x & 0xFFFFu));
}

// per halfword: m ? a : b (m is 0x0000 or 0xFFFF in each half)
__device__ __forceinline__ uint32_t sel(uint32_t m, uint32_t a, uint32_t b) {
  return (a & m) | (b & ~m);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t s) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(s));
  return r;
}

// The text word of a cell.  Byte table: the selector of both halves,
// nibbles (t0, t0 sign, t1, t1 sign) over grp::lut_row's indices (0-3
// the bases, 4 an N, 5 a symbol below 0); otherwise the symbol pair.
template <bool LUT>
__device__ __forceinline__ uint32_t text_word(int t0, int t1) {
  if (!LUT) return pack2(t0, t1);
  auto idx = [](int t) {
    return t < 0 ? 5u : (t >= 4 ? 4u : static_cast<unsigned>(t));
  };
  const unsigned i0 = idx(t0), i1 = idx(t1);
  return i0 | (i0 | 8u) << 4 | i1 << 8 | (i1 | 8u) << 12;
}

// k_start: the group's first band cell, 2w + 1 - G * CPT.  The bounds
// ask for 4 blocks (16 warps, 128 registers) an SM at 16 and 24 cells a
// lane, but for GLOBAL's 24-cell tier, which spills at 128 registers; a
// minimum of one block elsewhere let ptxas take more registers, and ran
// faster at every measured shape than no minimum (PERF.md §6).
template <int G, int CPT, int ATYPE, bool LUT, int PINC>
__global__ void __launch_bounds__(
    NT, (CPT >= 16 && !(ATYPE == GLOBAL && CPT >= 24)) ? 4 : 1)
    k7_group_kernel(const Args a, const int k_start) {
  constexpr int NGRP = NT / G;
  constexpr int Q = (R + G - 1) / G;  // staged rows a lane loads
  // per row, byte table: both alignments' tables (lo, hi) x 2; compare
  // form: the pattern pair, its N mask, minus the mismatch penalties
  __shared__ __align__(16) uint4 sh_tab[NGRP][R];
  // the text word that enters the band's last cell after the row
  __shared__ uint32_t sh_txt[NGRP][R];

  const int slot = threadIdx.x / G, lane = threadIdx.x % G;
  const int np = (a.nb + 1) / 2;
  // every lane of a warp runs the same rows, so shuffles take the whole
  // warp: a group past the batch runs the last pair and writes nothing
  const int pr_live = blockIdx.x * NGRP + slot;
  if (__all_sync(FULL, pr_live >= np)) return;
  const bool live = pr_live < np;
  const int pr = live ? pr_live : np - 1;
  const Scheme sc = a.sc;
  const int w = a.band_w, lp = a.lp, lp8 = (lp + 7) / 8 * 8;
  const int k0 = k_start + lane * CPT;  // this lane's first band cell

  int b[2], plen[2], tlen[2], p16[2], t16[2], tl[2];
  const int8_t* pat[2];
  const uint8_t* qual[2];
  const int8_t* txt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    b[h] = 2 * pr + h;
    const bool in = b[h] < a.nb;
    const int bb = in ? b[h] : 2 * pr;
    plen[h] = in ? a.plens[bb] : 0;
    tlen[h] = in ? a.tlens[bb] : 0;
    p16[h] = static_cast<int16_t>(plen[h]);  // the plain version's int16
    t16[h] = static_cast<int16_t>(tlen[h]);
    tl[h] = min(a.lt, tlen[h]);
    pat[h] = a.pats + static_cast<int64_t>(bb) * lp;
    qual[h] = a.quals + static_cast<int64_t>(bb) * lp;
    txt[h] = a.texts + static_cast<int64_t>(bb) * a.lt;
  }
  // window symbol m of half h; PAD outside [0, min(Lt, tlen))
  auto text_at = [&](int h, int m) -> int {
    return (m >= 0 && m < tl[h]) ? __ldg(txt[h] + m) : PAD_SYMBOL;
  };

  const int eo = sc.eo, ee = sc.ee;
  const uint32_t neg2 = pack2(NEG16, NEG16);
  const uint32_t nfofe2 = pack2(-(sc.fo + sc.fe), -(sc.fo + sc.fe));
  const uint32_t nfe2 = pack2(-sc.fe, -sc.fe);
  const uint32_t nee2 = pack2(-ee, -ee);
  const uint32_t neoee2 = pack2(-(eo + ee), -(eo + ee));
  // compare form: N, match and the N penalty
  const uint32_t three2 = pack2(3, 3), match2 = pack2(sc.match, sc.match);
  const uint32_t nn2 = pack2(-sc.n_penalty, -sc.n_penalty);

  // row 0, as the plain version: in-band cells with j0 <= tlen
  uint32_t H[CPT], F[CPT], T[CPT], keep[PINC > 0 ? PINC : 1];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int k = k0 + c;
    const int j0 = k - w;
    int h0;
    if (ATYPE == GLOBAL)
      h0 = j0 == 0 ? 0 : (j0 > 0 ? -(eo + ee * j0) : NEG16);
    else
      h0 = j0 >= 0 ? 0 : NEG16;
    H[c] = pack2(j0 <= t16[0] ? h0 : NEG16, j0 <= t16[1] ? h0 : NEG16);
    F[c] = neg2;
    T[c] = text_word<LUT>(text_at(0, k - w), text_at(1, k - w));
    if constexpr (PINC > 0)
      if (c < PINC) keep[c] = k >= 0 ? 0xFFFFFFFFu : 0u;
  }

  // this lane's sink candidates, a half each: SEMI_GLOBAL the best cell
  // of row plen (lowest k), GLOBAL the goal cell, LOCAL the running best
  Best mine[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    mine[h] = ATYPE == LOCAL ? Best{0, 0, 0} : Best{NEG16, 0, 0};

  // score-only: the rows stop at the longest pattern's end in the warp
  // (the rows past a pattern's end change none of its outputs)
  const int n_rows = __reduce_max_sync(
      FULL, max(min(max(p16[0], p16[1]), lp8), 0));
  // a chunk ahead: the pattern symbols and qualities of both halves, and
  // the text symbols entering the band after the row (window symbol
  // i + 1 + w under cell 2w of row i + 2), a byte each
  uint32_t pf_pq[Q], pf_t[Q];
  auto prefetch = [&](int r0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int rr = lane + q * G, i = r0 + rr;
      uint32_t pq = 0, t = 0;
      if (rr < R && i < n_rows) {
        // rows past lp are PAD with quality 0
        const bool in = i < lp;
        pq = (static_cast<uint32_t>(in ? pat[0][i] : PAD_SYMBOL) & 0xFFu) |
             (static_cast<uint32_t>(in ? pat[1][i] : PAD_SYMBOL) & 0xFFu)
                 << 8 |
             static_cast<uint32_t>(in ? qual[0][i] : 0) << 16 |
             static_cast<uint32_t>(in ? qual[1][i] : 0) << 24;
        t = (static_cast<uint32_t>(text_at(0, i + 1 + w)) & 0xFFu) |
            (static_cast<uint32_t>(text_at(1, i + 1 + w)) & 0xFFu) << 8;
      }
      pf_pq[q] = pq;
      pf_t[q] = t;
    }
  };
  prefetch(0);

  for (int r0 = 0; r0 < n_rows; r0 += R) {
    __syncwarp();  // the previous chunk's reads are done
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int rr = lane + q * G;
      if (rr < R) {
        const uint32_t pq = pf_pq[q];
        const int pp[2] = {static_cast<int8_t>(pq & 0xFFu),
                           static_cast<int8_t>((pq >> 8) & 0xFFu)};
        int mm[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int qv = static_cast<int>((pq >> (16 + 8 * h)) & 0xFFu);
          mm[h] = sc.mm_min +
                  floor_div40((sc.mm_max - sc.mm_min) * min(qv, 40));
        }
        if (LUT) {
          const uint2 l0 = grp::lut_row(pp[0], mm[0], sc);
          const uint2 l1 = grp::lut_row(pp[1], mm[1], sc);
          sh_tab[slot][rr] = make_uint4(l0.x, l0.y, l1.x, l1.y);
        } else {
          sh_tab[slot][rr] = make_uint4(
              pack2(pp[0], pp[1]),
              (pp[0] >= 4 ? 0x0000FFFFu : 0u) | (pp[1] >= 4 ? 0xFFFF0000u : 0u),
              pack2(-mm[0], -mm[1]), 0u);
        }
        const uint32_t t = pf_t[q];
        sh_txt[slot][rr] = text_word<LUT>(static_cast<int8_t>(t & 0xFFu),
                                          static_cast<int8_t>(t >> 8));
      }
    }
    __syncwarp();
    prefetch(r0 + R);  // lands while this chunk's rows run
    const int nr = min(R, n_rows - r0);

    for (int rr = 0; rr < nr; ++rr) {
      const uint4 in = sh_tab[slot][rr];
      const int row = r0 + rr + 1;
      // the previous row's H, F of cell k0 + CPT (the next lane's first)
      uint32_t nxt_h = __shfl_down_sync(FULL, H[0], 1, G);
      uint32_t nxt_f = __shfl_down_sync(FULL, F[0], 1, G);
      if (lane == G - 1) nxt_h = nxt_f = neg2;

      // pass 1: F, Hhat (into H), and the lane's fold of g
      uint32_t run = neg2;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        uint32_t s;
        if (LUT) {
          const uint32_t r0w = prmt(in.x, in.y, T[c]);
          const uint32_t r1w = prmt(in.z, in.w, T[c]);
          s = (r0w & 0x0000FFFFu) | (r1w & 0xFFFF0000u);
        } else {
          const uint32_t eq = __vcmpeq2(T[c], in.x);
          const uint32_t isn = __vcmpgts2(T[c], three2) | in.y;
          s = sel(isn, nn2, sel(eq, match2, in.z));
        }
        const uint32_t up_h = c + 1 < CPT ? H[c + 1] : nxt_h;
        const uint32_t up_f = c + 1 < CPT ? F[c + 1] : nxt_f;
        // F = max(up_f - fe, up_h - (fo + fe), NEG16)
        const uint32_t fn =
            __viaddmax_s16x2(up_f, nfe2, __viaddmax_s16x2(up_h, nfofe2, neg2));
        // Hhat = max(H + s, F) (LOCAL: and 0)
        uint32_t hh = ATYPE == LOCAL ? __viaddmax_s16x2_relu(H[c], s, fn)
                                     : __viaddmax_s16x2(H[c], s, fn);
        if constexpr (PINC > 0)
          if (c < PINC) hh = sel(keep[c], hh, neg2);
        F[c] = fn;
        H[c] = hh;  // cell c - 1 has read H[c] already
        run = __viaddmax_s16x2(run, nee2, hh);  // g of the next cell
      }
      // the exclusive scan over the group: g at the lane's first cell
      uint32_t x = neg2;
      if constexpr (G <= 4) {  // every lane's total at once
#pragma unroll
        for (int d = 1; d < G; ++d) {
          const uint32_t y = __shfl_up_sync(FULL, run, d, G);
          if (lane >= d)
            x = __viaddmax_s16x2(
                y, pack2(-(d - 1) * CPT * ee, -(d - 1) * CPT * ee), x);
        }
      } else {  // Kogge-Stone: a lane below d reads its own value back,
                // which the decay lowers
        x = __shfl_up_sync(FULL, run, 1, G);
        if (lane == 0) x = neg2;
#pragma unroll
        for (int d = 1; d < G; d <<= 1)
          x = __viaddmax_s16x2(__shfl_up_sync(FULL, x, d, G),
                               pack2(-d * CPT * ee, -d * CPT * ee), x);
      }
      // pass 2: H = max(Hhat, g - (eo + ee)), folding again from g
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const uint32_t hh = H[c];
        H[c] = __viaddmax_s16x2(x, neoee2, hh);
        x = __viaddmax_s16x2(x, nee2, hh);
      }

      if (ATYPE == SEMI_GLOBAL) {
        if (row == p16[0] || row == p16[1]) {
          // cells past tlen masked: cell c holds j <= tlen iff c <= lim
          // (lim = tlen + w - row - k0, per half)
          const uint32_t lim2 =
              pack2(max(min(t16[0] + w - row - k0, CPT), -1),
                    max(min(t16[1] + w - row - k0, CPT), -1));
          // NEG16 in the halves where lim - c < 0
          auto masked = [&](int c) {
            const uint32_t d =
                __viaddmax_s16x2(lim2, pack2(-c, -c), 0x80008000u);
            return sel(prmt(d, 0u, 0xBB99u), neg2, H[c]);
          };
          // the row's best per half and the lowest c holding it (a cell
          // takes the lead only when strictly above)
          uint32_t mx = neg2, kb = 0u;
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            bool ge_hi, ge_lo;
            mx = __vibmax_s16x2(mx, masked(c), &ge_hi, &ge_lo);
            const uint32_t cw = static_cast<uint32_t>(c);
            if (!ge_lo) kb = (kb & 0xFFFF0000u) | cw;
            if (!ge_hi) kb = (kb & 0x0000FFFFu) | cw << 16;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (row == p16[h]) mine[h] = {half(mx, h), 0, k0 + half(kb, h)};
        }
      } else if (ATYPE == GLOBAL) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (row == p16[h]) {
            // the goal cell k = tlen - plen + w, if this lane holds it
            const int kg = tlen[h] - plen[h] + w, at = kg - k0;
            uint32_t v = neg2;
#pragma unroll
            for (int c = 0; c < CPT; ++c) v = c == at ? H[c] : v;
            mine[h].v = kg >= 0 ? half(v, h) : NEG16;
          }
      } else {
        uint32_t rm = H[0];
#pragma unroll
        for (int c = 1; c < CPT; ++c) rm = __vmaxs2(rm, H[c]);
        bool upd[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          upd[h] = row <= p16[h] && half(rm, h) > mine[h].v;
        if (upd[0] || upd[1]) {
          uint32_t kb = 0u;  // the lowest c per half holding rm
#pragma unroll
          for (int c = CPT - 1; c >= 0; --c)
            kb = sel(__vcmpeq2(H[c], rm), pack2(c, c), kb);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (upd[h]) mine[h] = {half(rm, h), row, k0 + half(kb, h)};
        }
      }

      // slide the text one cell: cell k takes cell k + 1's word
      const uint32_t t_in = __shfl_down_sync(FULL, T[0], 1, G);
#pragma unroll
      for (int c = 0; c + 1 < CPT; ++c) T[c] = T[c + 1];
      T[CPT - 1] = lane == G - 1 ? sh_txt[slot][rr] : t_in;
    }
  }

  Best top[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) top[h] = grp::group_best<G>(mine[h]);
  if (lane != 0 || !live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (b[h] >= a.nb) continue;
    int score, pe, k;
    if (ATYPE == LOCAL) {
      score = top[h].v;
      pe = top[h].r;
      k = top[h].k;
    } else {
      const bool dead = top[h].v <= DEAD16;
      score = dead ? NEG_INF : top[h].v;
      pe = plen[h];
      k = ATYPE == GLOBAL ? tlen[h] - plen[h] + w : (dead ? 0 : top[h].k);
    }
    if (plen[h] <= 0) {
      score = ATYPE == LOCAL ? 0 : NEG_INF;
      pe = 0;
      k = w;
    }
    a.out[b[h]] = score;
    a.out[a.nb + b[h]] = pe;
    a.out[2 * a.nb + b[h]] = max(pe + k - w, 0);
  }
}

template <int V>
using Int = std::integral_constant<int, V>;

// The tiers by live cells, chosen by measurement (PERF.md §6): 8 cells a
// lane from 17 to 256 (4 x 8 beat 8 x 4 at 31 cells, 8 x 8 beat 16 x 4
// at 63, 16 x 8 beat 32 x 4 at 127; 4 x 4 beat 2 x 8 at 15), 16 and 24
// past it (the Lp 16-32 wide bands, 4 096-8 192 pairs).  Calls
// f(Int<G>, Int<CPT>) for n live cells; cudaErrorInvalidValue past 768.
template <class F>
cudaError_t with_tier(int n, F&& f) {
  if (n <= 16) return f(Int<4>(), Int<4>());
  if (n <= 32) return f(Int<4>(), Int<8>());
  if (n <= 64) return f(Int<8>(), Int<8>());
  if (n <= 128) return f(Int<16>(), Int<8>());
  if (n <= 256) return f(Int<32>(), Int<8>());
  if (n <= 512) return f(Int<32>(), Int<16>());
  if (n <= 768) return f(Int<32>(), Int<24>());
  return cudaErrorInvalidValue;
}

// The instantiation a call takes: the tier (G, CPT), the group's first
// band cell, the pinned cells a lane, the substitution form and the
// grid.  Cells left of the band reach columns >= 0 only where w < Lp8,
// which the guard admits at up to 215 live cells: the tiers up to 256
// pin, one cell a lane where at most one is left of the band (the byte
// table) or every cell.  The compare form serves the tiers up to 64
// cells: a scheme past a signed byte with mismatch_min <= mismatch_max
// has some value >= 128 in int16_ok's bound, so (Lp8 + band) * 128 <
// 9000 and Lp8 >= 16 leave at most 53 cells.
struct Plan {
  int g, cpt, k_start, pinc, lut, grid;
};

inline cudaError_t plan(const Args& a, int k_lo, Plan& p) {
  const int w = a.band_w, lp8 = (a.lp + 7) / 8 * 8;
  // the range must hold every cell the plain version can mark valid
  const int k_max = w > lp8 ? w - lp8 : 0;
  if (w < 0 || k_lo < 0 || k_lo > 2 * w || (lp8 > 0 && k_lo > k_max))
    return cudaErrorInvalidValue;
  p.lut = grp::lut_ok(a.sc);
  return with_tier(2 * w + 1 - k_lo, [&](auto g, auto c) {
    constexpr int G = decltype(g)::value, CPT = decltype(c)::value;
    p.g = G;
    p.cpt = CPT;
    p.k_start = 2 * w + 1 - G * CPT;
    if (G * CPT > 256 && p.k_start < 0 && w < lp8)
      return cudaErrorInvalidValue;  // outside the guard: no pinning tier
    if (!p.lut && G * CPT > 64) return cudaErrorInvalidValue;
    p.pinc = G * CPT > 256 ? 0 : (p.lut && p.k_start >= -1 ? 1 : CPT);
    p.grid = ((a.nb + 1) / 2 + NT / G - 1) / (NT / G);
    return cudaSuccess;
  });
}

template <int G, int CPT, int ATYPE>
cudaError_t launch_atype(const Args& a, const Plan& p, cudaStream_t stream) {
  const dim3 grid(p.grid), block(NT);
  if constexpr (G * CPT > 256) {
    k7_group_kernel<G, CPT, ATYPE, true, 0>
        <<<grid, block, 0, stream>>>(a, p.k_start);
  } else {
    if (p.lut && p.pinc == 1)
      k7_group_kernel<G, CPT, ATYPE, true, 1>
          <<<grid, block, 0, stream>>>(a, p.k_start);
    else if (p.lut)
      k7_group_kernel<G, CPT, ATYPE, true, CPT>
          <<<grid, block, 0, stream>>>(a, p.k_start);
    else if constexpr (G * CPT <= 64)
      k7_group_kernel<G, CPT, ATYPE, false, CPT>
          <<<grid, block, 0, stream>>>(a, p.k_start);
    else
      return cudaErrorInvalidValue;  // plan refuses it
  }
  return cudaGetLastError();
}

}  // namespace k7
}  // namespace

extern "C" {

// All pointers are device pointers; out is (3, nb) int32.  k_lo is the
// first live band cell (ops/banded_dp.py k7_live_range: max(0, band_w -
// Lp8), 2 * band_w when Lp8 is 0).  The byte table serves schemes whose
// scores fit a signed byte, the compare form the others.  Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for a
// call no instantiation serves, k7_plan's).
int k7_banded_score16(const void* pats, const void* quals, const void* plens,
                      const void* texts, const void* tlens, int nb, int lp,
                      int lt, int band_w, int k_lo, int atype, int match,
                      int mm_min, int mm_max, int n_penalty, int eo, int ee,
                      int fo, int fe, void* out, void* stream) {
  if (nb == 0) return 0;
  Args a = make_args(pats, quals, plens, tlens, nb, lp, band_w, match,
                     mm_min, mm_max, n_penalty, eo, ee, fo, fe, out);
  a.texts = static_cast<const int8_t*>(texts);
  a.lt = lt;
  k7::Plan p;
  const cudaError_t e = k7::plan(a, k_lo, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(k7::with_tier(2 * band_w + 1 - k_lo,
                                        [&](auto g, auto c) {
    constexpr int G = decltype(g)::value, CPT = decltype(c)::value;
    switch (atype) {
      case GLOBAL:
        return k7::launch_atype<G, CPT, GLOBAL>(a, p, st);
      case SEMI_GLOBAL:
        return k7::launch_atype<G, CPT, SEMI_GLOBAL>(a, p, st);
      case LOCAL:
        return k7::launch_atype<G, CPT, LOCAL>(a, p, st);
      default:
        return cudaErrorInvalidValue;
    }
  }));
}

// The instantiation k7_banded_score16 takes for the same arguments (no
// pointers): plan[0..5] = G, CPT, the group's first band cell, the
// pinned cells a lane, 1 for the byte table (0 the compare form), and
// the blocks of the grid.  Returns what k7_banded_score16 would for a
// call it refuses (cudaErrorInvalidValue), else 0.
int k7_plan(int nb, int lp, int band_w, int k_lo, int match, int mm_min,
            int mm_max, int n_penalty, int* plan) {
  Args a = make_args(nullptr, nullptr, nullptr, nullptr, nb, lp, band_w,
                     match, mm_min, mm_max, n_penalty, 0, 0, 0, 0, nullptr);
  k7::Plan p;
  const cudaError_t e = k7::plan(a, k_lo, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int v[6] = {p.g, p.cpt, p.k_start, p.pinc, p.lut, p.grid};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
  return 0;
}

}  // extern "C"
