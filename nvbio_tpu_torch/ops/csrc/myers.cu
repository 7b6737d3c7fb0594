// Myers bit-vector edit distance for Hopper (sm_90a): K6.
//
//   k6_myers   GLOBAL and SEMI_GLOBAL edit distance of each pattern
//              against its text, (distance, t_end) per alignment, on the
//              tier k6_plan gives the shape (written into a host int)
//   k6_plan    that tier, with the words a lane and the strips
//   replaces nvbio_tpu/ops/myers_pallas.py  _make_myers_kernel /
//   myers_pallas.
//
// What it computes is nvbio_tpu_torch/alignment/myers.py (the plain
// version, a port of the JAX twin nvbio_tpu/alignment/myers.py) column
// for column: W = ceil(Lp / 32) words per bit vector, Peq from symbols
// 0..3 of the first plen pattern symbols, the low max(plen, 1) bits
// kept, the end bit at plen - 1; per text column j < tlen the add with
// carry across words, the ph/mh shift with the top bit carried into the
// next word (GLOBAL fills 1 into word 0), the masks, and the distance
// update from the end bit; SEMI_GLOBAL keeps the least distance and its
// (1-based) column, first on ties, and returns min(best, plen).
//
// The TPU kernel put 128-512 alignments across lanes and the W words
// across sublanes, so its add with carry became a Kogge-Stone lookahead
// of sublane shifts.  Here two tiers, by W (k6_plan):
//
// W <= 8 (patterns to 256 bp; the tool's 100 bp is W = 4): k6_kernel<W>,
// one thread an alignment, its words in registers, the carry a plain
// 64-bit add per word; texts in 64-column tiles staged in shared memory
// by the whole block.  Bound: ~11 instructions a word and column (a LOP3
// for any function of three words, a funnel shift for each shift with
// its carried bit, an IADD3 for the add with carry), the integer issue
// rate.
//
// W > 8: k6_warp_kernel<K>, the words of one alignment across the lanes
// of S warps (strips): lane l of strip s holds words 32 K s + K l ..
// + K - 1 (Peq as three bit planes, VP, VN) in registers.  A text column
// in a strip: each lane adds its K words with carry-in 0, which gives a
// generate bit g (carry out of its K words) and a propagate bit p (their
// sum is all ones; never both); with G and P the warp's ballots of g and
// p and c the strip's carry-in, T = (G | P) + G + c in 64 bits carries
// into lane l bit l of T ^ P, and out of the strip bit 32 of T; a lane
// whose carry-in is 1 adds it through its words.  The top bits of ph and
// mh reach lane l from lane l - 1 by a shuffle (lane 0 of strip 0 takes
// the fill, lane 0 of strip s > 0 strip s - 1's top bits).  Strip s + 1
// needs, at column j, strip s's carry-out and top ph/mh bits at column j:
// strip s packs them 32 columns to a word each (in registers) and hands
// the three words of each 32-column chunk on through a ring of RING
// chunks in shared memory with a published and a consumed chunk count
// (polled once a chunk, as wavefront_gotoh.cu's bs_strip rings), so the
// strips run as a pipeline, strip s + 1 a chunk behind strip s, with no
// block barrier in the loop (a ring read a column at a time put a shared
// load on each column's dependent chain and measured slower).
// Carries and shifts only go upward, so bits above the end bit never
// reach it: the plen masks are not needed, words above the end word are
// never read, and strips wholly above it exit at once.  The lane holding
// the end word keeps the distance.  Each warp stages a chunk's 32 text
// columns in shared memory (a lane reads one symbol, 32 contiguous bytes a
// warp) as the masks of the symbol's two bits, which every lane reads a
// column ahead, a broadcast.  k6_plan takes the smallest K of 1, 2, 8
// whose strips fit max_strips(K): one warp an alignment (a block WARP_WPB
// of them) to 32 words, then one block an alignment, up to 8 strips of 2
// words a lane, and 8 words a lane past 512 words (turns on an H100,
// PERF.md).
// What bounds it: ~11 instructions a word and column as above (the
// integer pipe's 64 lanes an SM), plus ~25 a lane and column for the
// lookahead (two ballots, the 64-bit add), the shuffles, the distance and
// the ring, shared by the lane's K words; the warps in flight (a batch of
// 128 alignments of 8 kb holds 4 an SM, one a scheduler: the column's
// dependent chain is then the limit); at S > 1 the pipeline's fill (a
// chunk a strip) and one block an alignment, so a batch of fewer
// alignments than SMs (64 of 32 kb) leaves SMs idle.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 64;  // text columns staged per step
constexpr int MAX_REG_WORDS = 8;
constexpr unsigned FULL = 0xffffffffu;
// the warp tier: alignments (warps) a block at S == 1, and the chunks of
// 32 text columns a ring between two strips holds (a power of two)
constexpr int WARP_WPB = 4;
constexpr int RING = 8;
constexpr int PAD_SYMBOL = 7;
// k6_plan's tiers
constexpr int TIER_THREAD = 0, TIER_WARP = 1;

struct MyersArgs {
  const int8_t* pats;    // (nb, lp)
  const int32_t* plens;  // (nb,)
  const int8_t* texts;   // (nb, lt)
  const int32_t* tlens;  // (nb,)
  int nb, lp, lt;
  bool global;
  int strips;            // the warp tier's S
  int32_t* out;          // (2, nb): distance, t_end
};

// low m bits of word w set
__device__ __forceinline__ uint32_t low_mask(int m, int w) {
  const int lo = w * 32;
  if (m >= lo + 32) return 0xffffffffu;
  if (m <= lo) return 0u;
  return (1u << (m - lo)) - 1u;
}

// the state of one alignment in registers
template <int W>
struct State {
  uint32_t peq[4][W], vp[W], vn[W];
  __device__ __forceinline__ uint32_t& P(int c, int w) { return peq[c][w]; }
  __device__ __forceinline__ uint32_t& VP(int w) { return vp[w]; }
  __device__ __forceinline__ uint32_t& VN(int w) { return vn[w]; }
};

template <int W>
__global__ void __launch_bounds__(THREADS) k6_kernel(MyersArgs a) {
  __shared__ int8_t tile[THREADS][TILE + 4];
  const int b0 = blockIdx.x * THREADS;
  const int b = b0 + threadIdx.x;
  const bool live = b < a.nb;
  State<W> s;
  const int plen = live ? a.plens[b] : 0;
  const int tlen = live ? a.tlens[b] : 0;
  const int m = max(plen, 1);
  const int m1 = max(plen - 1, 0);
  const int end_word = m1 >> 5;
  const uint32_t end_bit = static_cast<uint32_t>(m1 & 31);
  const uint32_t fill = a.global ? 1u : 0u;

  // word w of each state vector, over the words in order, unrolled
  auto for_words = [&](auto&& body) {
#pragma unroll
    for (int w = 0; w < W; ++w) body(w);
  };
  if (live) {
    const int8_t* pat = a.pats + static_cast<int64_t>(b) * a.lp;
    for_words([&](int w) {
      uint32_t e0 = 0, e1 = 0, e2 = 0, e3 = 0;
      for (int bit = 0; bit < 32; ++bit) {
        const int i = w * 32 + bit;
        if (i >= a.lp || i >= plen) break;
        const int c = pat[i];
        const uint32_t v = 1u << bit;
        e0 |= c == 0 ? v : 0u;
        e1 |= c == 1 ? v : 0u;
        e2 |= c == 2 ? v : 0u;
        e3 |= c == 3 ? v : 0u;
      }
      s.P(0, w) = e0;
      s.P(1, w) = e1;
      s.P(2, w) = e2;
      s.P(3, w) = e3;
      s.VP(w) = low_mask(m, w);
      s.VN(w) = 0u;
    });
  }
  int dist = plen;
  int best = plen > 0 ? (1 << 30) : 0;
  int bestj = 0;

  for (int j0 = 0; j0 < a.lt; j0 += TILE) {
    __syncthreads();
    // stage texts[b0 .. b0 + THREADS)[j0 .. j0 + TILE) row by row
    for (int idx = threadIdx.x; idx < THREADS * TILE; idx += THREADS) {
      const int row = idx / TILE, col = idx % TILE;
      const int bb = b0 + row, jj = j0 + col;
      tile[row][col] = (bb < a.nb && jj < a.lt)
                           ? a.texts[static_cast<int64_t>(bb) * a.lt + jj]
                           : int8_t(7);
    }
    __syncthreads();
    const int jend = min(min(j0 + TILE, tlen), a.lt);
    for (int j = j0; j < jend; ++j) {
      const int c = tile[threadIdx.x][j - j0];
      const bool sym = c >= 0 && c < 4;
      uint32_t carry = 0, ph_in = fill, mh_in = 0;
      int ebit = 0, mbit = 0;
      for_words([&](int w) {
        // selects of values, so that register arrays stay registers
        const uint32_t eq =
            !sym ? 0u
                 : (c == 0 ? uint32_t(s.P(0, w))
                           : (c == 1 ? uint32_t(s.P(1, w))
                                     : (c == 2 ? uint32_t(s.P(2, w))
                                               : uint32_t(s.P(3, w)))));
        const uint32_t vp = s.VP(w), vn = s.VN(w);
        const uint32_t xv = eq | vn;
        const uint64_t sum = static_cast<uint64_t>(eq & vp) + vp + carry;
        carry = static_cast<uint32_t>(sum >> 32);
        const uint32_t xh = (static_cast<uint32_t>(sum) ^ vp) | eq;
        uint32_t ph = vn | ~(xh | vp);
        uint32_t mh = vp & xh;
        if (w == end_word) {
          ebit = (ph >> end_bit) & 1u;
          mbit = (mh >> end_bit) & 1u;
        }
        const uint32_t lmask = low_mask(m, w);
        const uint32_t ph_top = ph >> 31, mh_top = mh >> 31;
        ph = ((ph << 1) | ph_in) & lmask;
        mh = ((mh << 1) | mh_in) & lmask;
        ph_in = ph_top;
        mh_in = mh_top;
        s.VP(w) = (mh | ~(xv | ph)) & lmask;
        s.VN(w) = (ph & xv) & lmask;
      });
      dist += ebit - mbit;
      if (dist < best) {
        best = dist;
        bestj = j + 1;
      }
    }
  }
  if (!live) return;
  if (a.global) {
    a.out[b] = dist;
    a.out[a.nb + b] = tlen;
  } else {
    a.out[b] = min(best, plen);
    a.out[a.nb + b] = bestj;
  }
}

template <int W>
cudaError_t launch_w(const MyersArgs& a, cudaStream_t stream) {
  const int blocks = (a.nb + THREADS - 1) / THREADS;
  k6_kernel<W><<<blocks, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---- the warp tier ----

// s = a + b over K words (carry-in 0), returning the carry out; and s +=
// (c != 0) through the K words (c + 0xffffffff carries out iff c != 0).
// One PTX carry chain each.
template <int K>
struct Chain;

template <>
struct Chain<1> {
  static __device__ __forceinline__ uint32_t add(uint32_t (&s)[1],
                                                 const uint32_t (&a)[1],
                                                 const uint32_t (&b)[1]) {
    uint32_t g;
    asm("add.cc.u32 %0, %2, %3;\n\taddc.u32 %1, 0, 0;"
        : "=r"(s[0]), "=r"(g)
        : "r"(a[0]), "r"(b[0]));
    return g;
  }
  static __device__ __forceinline__ void inc(uint32_t (&s)[1], uint32_t c) {
    asm("{\n\t.reg .u32 t;\n\tadd.cc.u32 t, %1, 0xffffffff;\n\t"
        "addc.u32 %0, %0, 0;\n\t}"
        : "+r"(s[0])
        : "r"(c));
  }
};

template <>
struct Chain<2> {
  static __device__ __forceinline__ uint32_t add(uint32_t (&s)[2],
                                                 const uint32_t (&a)[2],
                                                 const uint32_t (&b)[2]) {
    uint32_t g;
    asm("add.cc.u32 %0, %3, %5;\n\taddc.cc.u32 %1, %4, %6;\n\t"
        "addc.u32 %2, 0, 0;"
        : "=r"(s[0]), "=r"(s[1]), "=r"(g)
        : "r"(a[0]), "r"(a[1]), "r"(b[0]), "r"(b[1]));
    return g;
  }
  static __device__ __forceinline__ void inc(uint32_t (&s)[2], uint32_t c) {
    asm("{\n\t.reg .u32 t;\n\tadd.cc.u32 t, %2, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %0, 0;\n\taddc.u32 %1, %1, 0;\n\t}"
        : "+r"(s[0]), "+r"(s[1])
        : "r"(c));
  }
};

template <>
struct Chain<8> {
  static __device__ __forceinline__ uint32_t add(uint32_t (&s)[8],
                                                 const uint32_t (&a)[8],
                                                 const uint32_t (&b)[8]) {
    uint32_t g;
    asm("add.cc.u32 %0, %9, %17;\n\taddc.cc.u32 %1, %10, %18;\n\t"
        "addc.cc.u32 %2, %11, %19;\n\taddc.cc.u32 %3, %12, %20;\n\t"
        "addc.cc.u32 %4, %13, %21;\n\taddc.cc.u32 %5, %14, %22;\n\t"
        "addc.cc.u32 %6, %15, %23;\n\taddc.cc.u32 %7, %16, %24;\n\t"
        "addc.u32 %8, 0, 0;"
        : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]),
          "=r"(s[5]), "=r"(s[6]), "=r"(s[7]), "=r"(g)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
          "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
          "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
    return g;
  }
  static __device__ __forceinline__ void inc(uint32_t (&s)[8], uint32_t c) {
    asm("{\n\t.reg .u32 t;\n\tadd.cc.u32 t, %8, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %0, 0;\n\taddc.cc.u32 %1, %1, 0;\n\t"
        "addc.cc.u32 %2, %2, 0;\n\taddc.cc.u32 %3, %3, 0;\n\t"
        "addc.cc.u32 %4, %4, 0;\n\taddc.cc.u32 %5, %5, 0;\n\t"
        "addc.cc.u32 %6, %6, 0;\n\taddc.u32 %7, %7, 0;\n\t}"
        : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]),
          "+r"(s[5]), "+r"(s[6]), "+r"(s[7])
        : "r"(c));
  }
};

// The words a lane K of the warp tier, and the strips a block holds at
// most with each (k6_plan takes the smallest K whose strips fit): one
// warp an alignment to 32 words, then up to 8 strips of 2 words a lane,
// past 512 words 8 words a lane (18 strips reach the JAX guard's 4 520
// words).  On an H100 (PERF.md) a K is kept only where it is at least
// 10 % faster than its neighbours: at 256 words 2 words a lane on 4
// strips beat 1 on 8 by 12 %; 4 words a lane, within 10 % of 2 at 512
// words and of 8 at 1 024, is not kept.
constexpr int WARP_KS[] = {1, 2, 8};
__host__ __device__ constexpr int max_strips(int k) {
  return k == 1 ? 1 : k == 2 ? 8 : 18;
}
__host__ __device__ constexpr int warp_threads(int k) {
  return 32 * (max_strips(k) > WARP_WPB ? max_strips(k) : WARP_WPB);
}

// (a wait of ~seconds means a fault in the protocol: trap, so that the
// launch fails instead of hanging the card)
__device__ __forceinline__ void ring_wait(const volatile int* c, int need) {
  for (int n = 0; *c < need; ++n) {
    if (n == (1 << 26)) __trap();
    __nanosleep(32);
  }
  __threadfence_block();
}

__device__ __forceinline__ void ring_publish(volatile int* c, int v,
                                             bool me) {
  __syncwarp();
  __threadfence_block();
  if (me) *c = v;
}

// One alignment on S strips (S == a.strips), or S == 1 and WARP_WPB
// alignments a block.  Each warp stages a chunk's 32 text columns in
// ``sym`` as the masks of the symbol's two bits (read by every lane, a
// broadcast); ring[s] holds the chunks of boundary s (strip s to s + 1):
// strip s's carry-out, top ph and top mh bits, a word each, column t of
// an n-column chunk at bit n - 1 - t; cnt the boundary's published and
// consumed chunk counts.
template <int K, bool GLOBAL>
__global__ void __launch_bounds__(warp_threads(K))
    k6_warp_kernel(MyersArgs a) {
  constexpr int MAXS = max_strips(K);
  constexpr int NW = MAXS > WARP_WPB ? MAXS : WARP_WPB;  // warps a block
  __shared__ uint2 sym[NW][32];
  __shared__ uint32_t ring[MAXS > 1 ? MAXS - 1 : 1][RING][3];
  __shared__ int cnt[2 * MAXS];
  constexpr int SPAN = 32 * K;  // words a strip
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = a.strips;
  const int b = S == 1 ? blockIdx.x * WARP_WPB + warp : blockIdx.x;
  const int s = S == 1 ? 0 : warp;
  if (S > 1) {
    if (threadIdx.x < 2 * MAXS) cnt[threadIdx.x] = 0;
    __syncthreads();
  }
  if (b >= a.nb) return;
  const int plen = a.plens[b];
  const int tlen = a.tlens[b];
  const int cols = min(max(tlen, 0), a.lt);
  // plens past the words' reach (undefined in the plain version) are cut
  const int m1 = min(max(plen - 1, 0), SPAN * S * 32 - 1);
  const int end_word = m1 >> 5;
  const int s_end = end_word / SPAN;
  if (s > s_end) return;  // above the end word: nothing reaches it
  const bool more = s < s_end;  // strip s + 1 reads this strip's bits
  const int w0 = SPAN * s + K * lane;
  const uint32_t lane_bit = 1u << lane;

  // Peq as bit planes: symbol bit 0, bit 1, and not valid (valid: 0..3,
  // i < plen)
  uint32_t x0[K], x1[K], nv[K], vp[K], vn[K], em[K];
  {
    const int8_t* pat = a.pats + static_cast<int64_t>(b) * a.lp;
    const int pend = min(plen, a.lp);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      uint32_t e0 = 0, e1 = 0, ev = 0;
      const int i0 = (w0 + k) * 32;
      for (int bit = 0; bit < 32 && i0 + bit < pend; ++bit) {
        const int c = __ldg(pat + i0 + bit);
        const uint32_t u = static_cast<unsigned>(c) < 4u ? 1u << bit : 0u;
        ev |= u;
        e0 |= c & 1 ? u : 0u;
        e1 |= c & 2 ? u : 0u;
      }
      x0[k] = e0;
      x1[k] = e1;
      nv[k] = ~ev;
      vp[k] = FULL;
      vn[k] = 0u;
      em[k] = w0 + k == end_word ? 1u << (m1 & 31) : 0u;
    }
  }
  const int8_t* text = a.texts + static_cast<int64_t>(b) * a.lt;
  volatile int* const in_prod = cnt + 2 * (s > 0 ? s - 1 : 0);
  volatile int* const in_cons = in_prod + 1;
  volatile int* const out_prod = cnt + 2 * s;
  volatile int* const out_cons = out_prod + 1;
  const uint2* cm = sym[warp];
  int dist = plen;
  int best = plen > 0 ? (1 << 30) : 0;
  int bestj = 0;

  // column t of the n-column chunk at j0, c its symbol's bit masks; IN
  // takes strip s - 1's bits from rc, rp, rm, OUT adds this strip's to oc,
  // op, om; CLEAN: every symbol of the chunk is 0..3 (else BV marks the
  // valid ones)
  auto column = [&](int j0, int t, int n, uint2 c, uint32_t BV, uint32_t rc,
                    uint32_t rp, uint32_t rm, uint32_t& oc, uint32_t& op,
                    uint32_t& om, auto in_tag, auto out_tag,
                    auto clean_tag) {
    constexpr bool IN = decltype(in_tag)::value;
    constexpr bool OUT = decltype(out_tag)::value;
    constexpr bool CLEAN = decltype(clean_tag)::value;
    uint32_t eq[K], av[K], sm[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      eq[k] = ~((x1[k] ^ c.y) | (x0[k] ^ c.x) | nv[k]);
      if (!CLEAN) eq[k] &= 0u - ((BV >> t) & 1u);
      av[k] = eq[k] & vp[k];
    }
    const uint32_t g = Chain<K>::add(sm, av, vp);
    uint32_t all = sm[0];
#pragma unroll
    for (int k = 1; k < K; ++k) all &= sm[k];
    const uint32_t G = __ballot_sync(FULL, g);
    const uint32_t P = __ballot_sync(FULL, all == FULL);
    const int sh = 32 - n + t;  // column t's bit of a ring word to bit 31
    const uint64_t T =
        static_cast<uint64_t>(G | P) + G + (IN ? (rc << sh) >> 31 : 0u);
    Chain<K>::inc(sm, (static_cast<uint32_t>(T) ^ P) & lane_bit);
    uint32_t ph[K], mh[K], xv[K];
    uint32_t ep = 0, emh = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      xv[k] = eq[k] | vn[k];
      const uint32_t xh = (sm[k] ^ vp[k]) | eq[k];
      ph[k] = vn[k] | ~(xh | vp[k]);
      mh[k] = vp[k] & xh;
      ep |= ph[k] & em[k];
      emh |= mh[k] & em[k];
    }
    uint32_t pin = __shfl_up_sync(FULL, ph[K - 1], 1);
    uint32_t min_ = __shfl_up_sync(FULL, mh[K - 1], 1);
    if (lane == 0) {  // strip 0: the fill
      pin = IN ? rp << sh : (GLOBAL ? FULL : 0u);
      min_ = IN ? rm << sh : 0u;
    }
    if (OUT) {
      oc = oc * 2u + static_cast<uint32_t>(T >> 32);
      op = __funnelshift_l(ph[K - 1], op, 1);
      om = __funnelshift_l(mh[K - 1], om, 1);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // (ph << 1) with the top bit of the word below
      const uint32_t phs = __funnelshift_l(k ? ph[k - 1] : pin, ph[k], 1);
      const uint32_t mhs = __funnelshift_l(k ? mh[k - 1] : min_, mh[k], 1);
      vp[k] = mhs | ~(xv[k] | phs);
      vn[k] = phs & xv[k];
    }
    dist += (ep != 0u) - (emh != 0u);
    if (!GLOBAL && dist < best) {
      best = dist;
      bestj = j0 + t + 1;
    }
  };

  const int nch = (cols + 31) >> 5;
  int sy = lane < cols ? __ldg(text + lane) : PAD_SYMBOL;
  for (int ch = 0; ch < nch; ++ch) {
    const int j0 = ch * 32;
    const int n = min(32, cols - j0);
    __syncwarp();  // the chunk before is read
    sym[warp][lane] = make_uint2(0u - (sy & 1), 0u - ((sy >> 1) & 1));
    const uint32_t BV = __ballot_sync(FULL, static_cast<unsigned>(sy) < 4u);
    const bool clean = (BV | (n == 32 ? 0u : ~0u << n)) == FULL;
    sy = j0 + 32 + lane < cols ? __ldg(text + j0 + 32 + lane) : PAD_SYMBOL;
    uint32_t rc = 0, rp = 0, rm = 0, oc = 0, op = 0, om = 0;
    if (s > 0) {
      ring_wait(in_prod, ch + 1);
      const volatile uint32_t* slot = ring[s - 1][ch & (RING - 1)];
      rc = slot[0];
      rp = slot[1];
      rm = slot[2];
      ring_publish(in_cons, ch + 1, lane == 0);
    }
    __syncwarp();
    // each column's masks are read a column ahead, off its dependent chain
    auto run = [&](auto in_tag, auto out_tag, auto clean_tag) {
      uint2 c = cm[0];
#pragma unroll 2
      for (int t = 0; t < n; ++t) {
        const uint2 cn = cm[min(t + 1, n - 1)];
        column(j0, t, n, c, BV, rc, rp, rm, oc, op, om, in_tag, out_tag,
               clean_tag);
        c = cn;
      }
    };
    auto by_clean = [&](auto in_tag, auto out_tag) {
      if (clean)
        run(in_tag, out_tag, std::true_type{});
      else
        run(in_tag, out_tag, std::false_type{});
    };
    if (s > 0) {
      if (more)
        by_clean(std::true_type{}, std::true_type{});
      else
        by_clean(std::true_type{}, std::false_type{});
    } else {
      if (more)
        by_clean(std::false_type{}, std::true_type{});
      else
        by_clean(std::false_type{}, std::false_type{});
    }
    if (more) {
      ring_wait(out_cons, ch + 1 - RING);
      if (lane == 31) {
        volatile uint32_t* slot = ring[s][ch & (RING - 1)];
        slot[0] = oc;
        slot[1] = op;
        slot[2] = om;
      }
      ring_publish(out_prod, ch + 1, lane == 31);
    }
  }
  if (s == s_end && lane == (end_word - SPAN * s) / K) {
    a.out[b] = GLOBAL ? dist : min(best, plen);
    a.out[a.nb + b] = GLOBAL ? tlen : bestj;
  }
}

// The tier of a call at Lp, with the words a lane and the strips:
// W <= 8 the thread tier, else the warp tier at the smallest K of
// WARP_KS whose strips fit a block.  False past the widest reach.
bool plan_of(int lp, int* tier, int* k, int* strips) {
  const int words = (lp + 31) / 32;
  *tier = TIER_THREAD;
  *k = 0;
  *strips = 0;
  if (words <= MAX_REG_WORDS) return true;
  for (const int kk : WARP_KS) {
    const int ss = (words + 32 * kk - 1) / (32 * kk);
    if (ss <= max_strips(kk)) {
      *tier = TIER_WARP;
      *k = kk;
      *strips = ss;
      return true;
    }
  }
  return false;
}

template <int K>
cudaError_t launch_warp(const MyersArgs& a, cudaStream_t stream) {
  const int blocks =
      a.strips == 1 ? (a.nb + WARP_WPB - 1) / WARP_WPB : a.nb;
  const int threads = 32 * (a.strips == 1 ? WARP_WPB : a.strips);
  if (a.global)
    k6_warp_kernel<K, true><<<blocks, threads, 0, stream>>>(a);
  else
    k6_warp_kernel<K, false><<<blocks, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The tier a call at Lp takes, into plan[0..2]: tier (0 the thread tier,
// 1 the warp tier), words a lane and strips (0 on the thread tier).
// Returns 0, or cudaErrorInvalidValue past the widest reach.
int k6_plan(int lp, void* plan) {
  int* p = static_cast<int*>(plan);
  return plan_of(lp, p, p + 1, p + 2)
             ? 0
             : static_cast<int>(cudaErrorInvalidValue);
}

// All pointers are device pointers but ``tier``, a host int that receives
// the tier the call takes (k6_plan's); out is (2, nb) int32 (distance,
// t_end).  Returns the cudaError_t of the launch (0 on success).
int k6_myers(const void* pats, const void* plens, const void* texts,
             const void* tlens, int nb, int lp, int lt, int global,
             void* out, void* tier, void* stream) {
  int k = 0, strips = 0;
  int* t = static_cast<int*>(tier);
  if (!plan_of(lp, t, &k, &strips))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  MyersArgs a;
  a.pats = static_cast<const int8_t*>(pats);
  a.plens = static_cast<const int32_t*>(plens);
  a.texts = static_cast<const int8_t*>(texts);
  a.tlens = static_cast<const int32_t*>(tlens);
  a.nb = nb;
  a.lp = lp;
  a.lt = lt;
  a.global = global != 0;
  a.strips = strips;
  a.out = static_cast<int32_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (*t == TIER_WARP) {
    switch (k) {
      case 1: return static_cast<int>(launch_warp<1>(a, st));
      case 2: return static_cast<int>(launch_warp<2>(a, st));
      default: return static_cast<int>(launch_warp<8>(a, st));
    }
  }
  switch ((lp + 31) / 32) {
    case 0:
    case 1: return static_cast<int>(launch_w<1>(a, st));
    case 2: return static_cast<int>(launch_w<2>(a, st));
    case 3: return static_cast<int>(launch_w<3>(a, st));
    case 4: return static_cast<int>(launch_w<4>(a, st));
    case 5: return static_cast<int>(launch_w<5>(a, st));
    case 6: return static_cast<int>(launch_w<6>(a, st));
    case 7: return static_cast<int>(launch_w<7>(a, st));
    default: return static_cast<int>(launch_w<8>(a, st));
  }
}

}  // extern "C"
