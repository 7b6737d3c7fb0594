// Myers bit-vector edit distance for Hopper (sm_90a): K6.
//
//   k6_myers   GLOBAL and SEMI_GLOBAL edit distance of each pattern
//              against its text, (distance, t_end) per alignment
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
// Design.  The TPU kernel put 128-512 alignments across lanes and the W
// words across sublanes, so its add with carry became a Kogge-Stone
// lookahead of sublane shifts and its unsigned compares a sign-flip
// trick.  Here one thread owns one alignment and walks its words in
// order, so the carry is a plain 64-bit add per word, and CUDA compares
// unsigned words natively.  For W <= 8 (patterns to 256 bp, the tool's
// 100 bp is W = 4) the state (Peq x 4, VP, VN) lives in registers through
// a template on W; beyond that it lives in device scratch laid out
// word-major, [6W][nb], so that a warp's accesses to one word coalesce.
// The texts are read in 64-column tiles staged in shared memory by the
// whole block (row-wise, so the global reads coalesce); each thread then
// reads its own row of the tile.
//
// What bounds it on the H100: about 20 32-bit operations per word per
// text column, i.e. the integer issue rate; the texts (Lt bytes per
// alignment) are read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 64;  // text columns staged per step
constexpr int MAX_REG_WORDS = 8;

struct MyersArgs {
  const int8_t* pats;    // (nb, lp)
  const int32_t* plens;  // (nb,)
  const int8_t* texts;   // (nb, lt)
  const int32_t* tlens;  // (nb,)
  int nb, lp, lt, words;
  bool global;
  uint32_t* scratch;     // (6 * words, nb) when words > MAX_REG_WORDS
  int32_t* out;          // (2, nb): distance, t_end
};

// low m bits of word w set
__device__ __forceinline__ uint32_t low_mask(int m, int w) {
  const int lo = w * 32;
  if (m >= lo + 32) return 0xffffffffu;
  if (m <= lo) return 0u;
  return (1u << (m - lo)) - 1u;
}

// the state of one alignment: registers (W > 0) or scratch (W == 0)
template <int W>
struct State {
  uint32_t peq[4][W > 0 ? W : 1], vp[W > 0 ? W : 1], vn[W > 0 ? W : 1];
  __device__ __forceinline__ uint32_t& P(int c, int w) { return peq[c][w]; }
  __device__ __forceinline__ uint32_t& VP(int w) { return vp[w]; }
  __device__ __forceinline__ uint32_t& VN(int w) { return vn[w]; }
};

template <>
struct State<0> {
  uint32_t* base;
  int stride;  // nb
  __device__ __forceinline__ uint32_t& at(int row) {
    return base[static_cast<int64_t>(row) * stride];
  }
  int words;
  __device__ __forceinline__ uint32_t& P(int c, int w) {
    return at(c * words + w);
  }
  __device__ __forceinline__ uint32_t& VP(int w) { return at(4 * words + w); }
  __device__ __forceinline__ uint32_t& VN(int w) { return at(5 * words + w); }
};

template <int W>
__global__ void __launch_bounds__(THREADS) k6_kernel(MyersArgs a) {
  __shared__ int8_t tile[THREADS][TILE + 4];
  const int b0 = blockIdx.x * THREADS;
  const int b = b0 + threadIdx.x;
  const bool live = b < a.nb;
  const int nw = W > 0 ? W : a.words;
  State<W> s;
  if constexpr (W == 0) {
    s.base = a.scratch + (live ? b : 0);
    s.stride = a.nb;
    s.words = a.words;
  }
  const int plen = live ? a.plens[b] : 0;
  const int tlen = live ? a.tlens[b] : 0;
  const int m = max(plen, 1);
  const int m1 = max(plen - 1, 0);
  const int end_word = m1 >> 5;
  const uint32_t end_bit = static_cast<uint32_t>(m1 & 31);
  const uint32_t fill = a.global ? 1u : 0u;

  // word w of each state vector, over the words in order: unrolled into
  // registers for W > 0, a loop over scratch otherwise
  auto for_words = [&](auto&& body) {
    if constexpr (W > 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) body(w);
    } else {
      for (int w = 0; w < nw; ++w) body(w);
    }
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

}  // namespace

extern "C" {

// Device words of scratch k6_myers needs for nb alignments of lp symbols
// (0 when the state fits in registers).
long long k6_scratch_words(int nb, int lp) {
  const int words = (lp + 31) / 32;
  return words > MAX_REG_WORDS ? 6LL * words * nb : 0;
}

// All pointers are device pointers; out is (2, nb) int32 (distance,
// t_end); scratch holds k6_scratch_words(nb, lp) uint32 words.  Returns
// the cudaError_t of the launch (0 on success).
int k6_myers(const void* pats, const void* plens, const void* texts,
             const void* tlens, int nb, int lp, int lt, int global,
             void* scratch, void* out, void* stream) {
  if (nb == 0) return 0;
  MyersArgs a;
  a.pats = static_cast<const int8_t*>(pats);
  a.plens = static_cast<const int32_t*>(plens);
  a.texts = static_cast<const int8_t*>(texts);
  a.tlens = static_cast<const int32_t*>(tlens);
  a.nb = nb;
  a.lp = lp;
  a.lt = lt;
  a.words = (lp + 31) / 32;
  a.global = global != 0;
  a.scratch = static_cast<uint32_t*>(scratch);
  a.out = static_cast<int32_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.words) {
    case 1: return static_cast<int>(launch_w<1>(a, st));
    case 2: return static_cast<int>(launch_w<2>(a, st));
    case 3: return static_cast<int>(launch_w<3>(a, st));
    case 4: return static_cast<int>(launch_w<4>(a, st));
    case 5: return static_cast<int>(launch_w<5>(a, st));
    case 6: return static_cast<int>(launch_w<6>(a, st));
    case 7: return static_cast<int>(launch_w<7>(a, st));
    case 8: return static_cast<int>(launch_w<8>(a, st));
    default: return static_cast<int>(launch_w<0>(a, st));
  }
}

}  // extern "C"
