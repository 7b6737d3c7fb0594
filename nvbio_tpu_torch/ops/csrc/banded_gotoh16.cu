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
// Design: one thread, the band in registers, E sequential along the
// band (the design of K1 before it moved to group_gotoh.cuh), with TWO
// alignments per thread.  The TPU
// kernel packed two int16 elements per 32-bit lane slot; here each
// 32-bit register holds the same cell of two alignments, lane 2t in its
// low and lane 2t + 1 in its high halfword, and every step of the
// recurrence is one SIMD / DPX halfword instruction for both:
//     __vcmpeq2 / __vcmpgts2   substitution masks
//     __viaddmax_s16x2         max(a + b, c): F, Hhat, E
//     __vimax3_s16x2           LOCAL's max(., ., 0)
//     __vmaxs2, __vsub2        H, the gap-open terms
// Each half keeps its own pattern, qualities, text, plen, tlen, valid
// masks and sink.  The kernel takes only shapes inside the reference's
// guard (ops/banded_dp.py int16_ok): there every reachable score lies
// above -9000 and every unreachable one between about -29000 and
// -11000, so no halfword comes near +-32768, and the wrapping forms used
// here (__vadd2, __vsub2, the add inside __viaddmax_s16x2) agree with
// saturating ones and with JAX's int16.  The JAX kernel solves E with a
// Kogge-Stone scan whose shifts fill NEG16; the sequential E here gives
// the same value on every reachable cell and a different value at or
// below NEG16 / 2 on unreachable ones, which the output contract maps
// to the same result.
//
// Tiers: bands of up to 16, 32 and 64 cells keep H, F and the text
// symbols under the band in registers (CAP, unrolled).  The guard admits
// bands of up to ~1440 cells (at Lp8 = 16); wider than 64 cells, H and F
// live in device scratch ([cell][thread] words, coalesced across a warp)
// and text symbols are read per cell.
//
// What bounds it on the H100: integer issue in the register tiers (a
// cell is about 15 halfword-pair instructions for two alignments, and
// only the inputs and outputs move).  The scratch tier is bound by
// latency instead: a thread's band (8 bytes a cell pair) outgrows L1, so
// each cell waits on an L2 round trip for the H and F its loads read.

#include "gotoh_common.cuh"

namespace {

constexpr int THREADS16 = 128;
constexpr int NEG16 = -20000;
// non-LOCAL end values at or below this are no path
constexpr int DEAD16 = NEG16 / 2;

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
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

struct Consts {
  uint32_t neg2, three2, nnpen2, match2, fofe2, nfe2, eoee2, nee2;
};

struct Row {
  uint32_t p2, pn2, nmm2;  // pattern symbols, pattern-N mask, -mismatch
};

// The two text windows of a thread; PAD outside [0, min(lt, tlen)).
struct Texts {
  const int8_t* tx[2];
  int tl[2];
  __device__ __forceinline__ uint32_t pair(int m) const {
    const int s0 = (m >= 0 && m < tl[0]) ? tx[0][m] : PAD_SYMBOL;
    const int s1 = (m >= 0 && m < tl[1]) ? tx[1][m] : PAD_SYMBOL;
    return pack2(s0, s1);
  }
};

// One band cell for both alignments.  h_old: this cell's H of the
// previous row (the diagonal); up_h, up_f: cell k + 1 of the previous
// row (the vertical); e_prev, hm_prev: E and masked Hhat of cell k - 1.
template <int ATYPE>
__device__ __forceinline__ void cell(const Consts& c, const Row& r,
                                     uint32_t t2, uint32_t h_old,
                                     uint32_t up_h, uint32_t up_f,
                                     uint32_t vm, bool first,
                                     uint32_t& e_prev, uint32_t& hm_prev,
                                     uint32_t& h_out, uint32_t& f_out) {
  const uint32_t eq = __vcmpeq2(t2, r.p2);
  const uint32_t isn = __vcmpgts2(t2, c.three2) | r.pn2;
  const uint32_t s = sel(isn, c.nnpen2, sel(eq, c.match2, r.nmm2));
  // F = max(up_f - fe, up_h - (fo + fe))
  const uint32_t f_new =
      __viaddmax_s16x2(up_f, c.nfe2, __vsub2(up_h, c.fofe2));
  // Hhat = max(H + s, F) (LOCAL: and 0)
  const uint32_t hhat =
      ATYPE == LOCAL ? __vimax3_s16x2(__vadd2(h_old, s), f_new, 0u)
                     : __viaddmax_s16x2(h_old, s, f_new);
  // E = max(Hhat_m[k - 1] - (eo + ee), E[k - 1] - ee)
  const uint32_t a_open = __vsub2(hm_prev, c.eoee2);
  const uint32_t e = first ? a_open : __viaddmax_s16x2(e_prev, c.nee2, a_open);
  e_prev = e;
  hm_prev = sel(vm, hhat, c.neg2);
  h_out = sel(vm, __vmaxs2(hhat, e), c.neg2);  // LOCAL: Hhat >= 0 already
  f_out = sel(vm, f_new, c.neg2);
}

// CAP > 0: H, F, T in registers, CAP >= band cells; CAP == 0: H and F in
// scratch, band cells.
template <int CAP, int ATYPE>
__global__ void __launch_bounds__(THREADS16)
banded_gotoh16_kernel(const Args a, uint32_t* __restrict__ scratch) {
  constexpr bool REGS = CAP > 0;
  const int nt = (a.nb + 1) / 2;
  const int t = blockIdx.x * THREADS16 + threadIdx.x;
  if (t >= nt) return;
  const Scheme sc = a.sc;
  const int w = a.band_w;
  const int band = 2 * w + 1;
  const int ncell = REGS ? CAP : band;
  const int lp = a.lp;
  const int lp8 = (lp + 7) / 8 * 8;

  // the thread's two alignments; an odd batch's last thread carries an
  // empty second one whose outputs are not written
  int b[2], plen[2], tlen[2], p16[2];
  const int8_t* pat[2];
  const uint8_t* qual[2];
  Texts tx;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    b[h] = 2 * t + h;
    const bool live = b[h] < a.nb;
    const int bb = live ? b[h] : 2 * t;
    plen[h] = live ? a.plens[bb] : 0;
    tlen[h] = live ? a.tlens[bb] : 0;
    p16[h] = static_cast<int16_t>(plen[h]);  // the kernel compares in int16
    pat[h] = a.pats + static_cast<int64_t>(bb) * lp;
    qual[h] = a.quals + static_cast<int64_t>(bb) * lp;
    tx.tx[h] = a.texts + static_cast<int64_t>(bb) * a.lt;
    tx.tl[h] = min(a.lt, tlen[h]);
  }
  const int t16[2] = {static_cast<int16_t>(tlen[0]),
                      static_cast<int16_t>(tlen[1])};

  Consts c;
  c.neg2 = pack2(NEG16, NEG16);
  c.three2 = pack2(3, 3);
  c.nnpen2 = pack2(-sc.n_penalty, -sc.n_penalty);
  c.match2 = pack2(sc.match, sc.match);
  c.fofe2 = pack2(sc.fo + sc.fe, sc.fo + sc.fe);
  c.nfe2 = pack2(-sc.fe, -sc.fe);
  c.eoee2 = pack2(sc.eo + sc.ee, sc.eo + sc.ee);
  c.nee2 = pack2(-sc.ee, -sc.ee);

  uint32_t H[REGS ? CAP : 1], F[REGS ? CAP : 1], T[REGS ? CAP : 1];
  uint32_t* Hs = scratch;
  uint32_t* Fs = REGS ? nullptr : scratch + static_cast<int64_t>(band) * nt;
  auto sidx = [&](int k) { return static_cast<int64_t>(k) * nt + t; };

  // row 0
  const uint32_t tl2 = pack2(t16[0], t16[1]);
#pragma unroll
  for (int k = 0; k < ncell; ++k) {
    const int j0 = k - w;
    int h0;
    if (ATYPE == GLOBAL)
      h0 = j0 == 0 ? 0 : (j0 > 0 ? -(sc.eo + sc.ee * j0) : NEG16);
    else
      h0 = j0 >= 0 ? 0 : NEG16;
    const uint32_t m = k < band ? __vcmpges2(tl2, pack2(j0, j0)) : 0u;
    const uint32_t h = sel(m, pack2(h0, h0), c.neg2);
    if constexpr (REGS) {
      H[k] = h;
      F[k] = c.neg2;
      T[k] = tx.pair(k - w);
    } else {
      Hs[sidx(k)] = h;
      Fs[sidx(k)] = c.neg2;
    }
  }

  // sinks: non-LOCAL the last pattern row's (best value, k); LOCAL the
  // running (best, row, k)
  int best[2], best_i[2] = {0, 0}, best_k[2] = {0, 0};
  best[0] = best[1] = ATYPE == LOCAL ? 0 : NEG16;
  int k_goal[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) k_goal[h] = tlen[h] - plen[h] + w;

  const int n_rows = min(lp8, max(max(p16[0], p16[1]), 0));
  for (int i0 = 0; i0 < n_rows; ++i0) {
    const int row = i0 + 1;
    int p[2], mm[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = i0 < lp;  // rows past lp are PAD with quality 0
      p[h] = in ? pat[h][i0] : PAD_SYMBOL;
      const int q = in ? min(static_cast<int>(qual[h][i0]), 40) : 0;
      mm[h] = sc.mm_min + floor_div40((sc.mm_max - sc.mm_min) * q);
    }
    Row r;
    r.p2 = pack2(p[0], p[1]);
    r.pn2 = (p[0] >= 4 ? 0x0000FFFFu : 0u) | (p[1] >= 4 ? 0xFFFF0000u : 0u);
    r.nmm2 = pack2(-mm[0], -mm[1]);
    // cell k is valid for j = i0 + 1 + k - w in [0, tlen] and k < band:
    // k >= k_lo, and k <= k_hi per half
    const int k_lo = w - i0 - 1;
    const uint32_t khi2 =
        pack2(max(min(t16[0] + w - i0 - 1, band - 1), -1),
              max(min(t16[1] + w - i0 - 1, band - 1), -1));

    uint32_t e_prev = 0u, hm_prev = c.neg2, rowmax = c.neg2;
    uint32_t h_old = REGS ? 0u : Hs[sidx(0)];
#pragma unroll
    for (int k = 0; k < ncell; ++k) {
      uint32_t up_h, up_f, t2;
      if constexpr (REGS) {
        up_h = k + 1 < CAP ? H[k + 1] : c.neg2;
        up_f = k + 1 < CAP ? F[k + 1] : c.neg2;
        t2 = T[k];
        h_old = H[k];
      } else {
        up_h = k + 1 < band ? Hs[sidx(k + 1)] : c.neg2;
        up_f = k + 1 < band ? Fs[sidx(k + 1)] : c.neg2;
        t2 = tx.pair(i0 + k - w);
      }
      const uint32_t vm =
          k >= k_lo ? __vcmpges2(khi2, static_cast<uint32_t>(k) * 0x10001u)
                    : 0u;
      uint32_t h_new, f_new;
      cell<ATYPE>(c, r, t2, h_old, up_h, up_f, vm, k == 0, e_prev, hm_prev,
                  h_new, f_new);
      if constexpr (REGS) {
        H[k] = h_new;
        F[k] = f_new;
      } else {
        Hs[sidx(k)] = h_new;
        Fs[sidx(k)] = f_new;
        h_old = up_h;
      }
      if (ATYPE == LOCAL) rowmax = __vmaxs2(rowmax, h_new);
    }

    auto get_h = [&](int k) -> uint32_t {
      if constexpr (REGS) return H[k];
      else return Hs[sidx(k)];
    };
    // the smallest k per half whose H equals mx's half
    auto lowest_k = [&](uint32_t mx) -> uint32_t {
      uint32_t kb = 0u;
#pragma unroll
      for (int k = ncell - 1; k >= 0; --k)
        kb = sel(__vcmpeq2(get_h(k), mx), static_cast<uint32_t>(k) * 0x10001u,
                 kb);
      return kb;
    };
    if (ATYPE == SEMI_GLOBAL) {
      if (row == p16[0] || row == p16[1]) {
        uint32_t mx = c.neg2;
#pragma unroll
        for (int k = 0; k < ncell; ++k) mx = __vmaxs2(mx, get_h(k));
        const uint32_t kb = lowest_k(mx);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (row == p16[h]) {
            best[h] = half(mx, h);
            best_k[h] = half(kb, h);
          }
      }
    } else if (ATYPE == GLOBAL) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row == p16[h]) {
          const int kg = k_goal[h];
          uint32_t x = c.neg2;
          if constexpr (REGS) {
#pragma unroll
            for (int k = 0; k < CAP; ++k) x = k == kg ? H[k] : x;
          } else {
            if (kg >= 0 && kg < band) x = Hs[sidx(kg)];
          }
          best[h] = half(x, h);
        }
    } else {
      bool upd[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        upd[h] = row <= p16[h] && half(rowmax, h) > best[h];
      if (upd[0] || upd[1]) {
        const uint32_t kb = lowest_k(rowmax);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (upd[h]) {
            best[h] = half(rowmax, h);
            best_i[h] = row;
            best_k[h] = half(kb, h);
          }
      }
    }

    if constexpr (REGS) {  // slide the text window one symbol
#pragma unroll
      for (int k = 0; k + 1 < CAP; ++k) T[k] = T[k + 1];
      T[CAP - 1] = tx.pair(i0 + CAP - w);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (b[h] >= a.nb) continue;
    int score, pe, k;
    if (ATYPE == LOCAL) {
      score = best[h];
      pe = best_i[h];
      k = best_k[h];
    } else {
      const bool dead = best[h] <= DEAD16;
      score = dead ? NEG_INF : best[h];
      pe = plen[h];
      k = ATYPE == GLOBAL ? k_goal[h] : (dead ? 0 : best_k[h]);
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

template <int CAP>
cudaError_t launch_atype(const Args& a, int atype, uint32_t* scratch,
                         cudaStream_t stream) {
  const int nt = (a.nb + 1) / 2;
  const dim3 grid((nt + THREADS16 - 1) / THREADS16), block(THREADS16);
  switch (atype) {
    case GLOBAL:
      banded_gotoh16_kernel<CAP, GLOBAL><<<grid, block, 0, stream>>>(a, scratch);
      break;
    case SEMI_GLOBAL:
      banded_gotoh16_kernel<CAP, SEMI_GLOBAL>
          <<<grid, block, 0, stream>>>(a, scratch);
      break;
    case LOCAL:
      banded_gotoh16_kernel<CAP, LOCAL><<<grid, block, 0, stream>>>(a, scratch);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 32-bit scratch words a k7_banded_score16 call needs: 0 for bands held
// in registers (up to 64 cells), else H and F for every thread's band.
long long k7_scratch_words(int nb, int band_w) {
  const int band = 2 * band_w + 1;
  if (band <= 64) return 0;
  return 2LL * band * ((nb + 1) / 2);
}

// All pointers are device pointers; out is (3, nb) int32; scratch holds
// k7_scratch_words(nb, band_w) words (may be null when that is 0).
// Returns the cudaError_t of the launch (0 on success).
int k7_banded_score16(const void* pats, const void* quals, const void* plens,
                      const void* texts, const void* tlens, int nb, int lp,
                      int lt, int band_w, int atype, int match, int mm_min,
                      int mm_max, int n_penalty, int eo, int ee, int fo,
                      int fe, void* out, void* scratch, void* stream) {
  if (nb == 0) return 0;
  Args a = make_args(pats, quals, plens, tlens, nb, lp, band_w, match, mm_min,
                     mm_max, n_penalty, eo, ee, fo, fe, out);
  a.texts = static_cast<const int8_t*>(texts);
  a.lt = lt;
  uint32_t* s = static_cast<uint32_t*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int band = 2 * band_w + 1;
  cudaError_t rc;
  if (band <= 16)
    rc = launch_atype<16>(a, atype, s, st);
  else if (band <= 32)
    rc = launch_atype<32>(a, atype, s, st);
  else if (band <= 64)
    rc = launch_atype<64>(a, atype, s, st);
  else if (s == nullptr)
    rc = cudaErrorInvalidValue;
  else
    rc = launch_atype<0>(a, atype, s, st);
  return static_cast<int>(rc);
}

}  // extern "C"
