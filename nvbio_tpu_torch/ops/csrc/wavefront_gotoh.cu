// Anti-diagonal wide-band banded Gotoh DP for Hopper (sm_90a): K5.
//
//   k5_wavefront_score       score + sink, raw twin values
//   k5_wavefront_score_matrix  the same with substitution scores from a
//                            K x K table (protein SW: BLOSUM62)
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
// What bounds it on the H100: per cell about 30 int32 operations and 9
// shared-memory accesses behind one barrier per diagonal, with one block
// of up to 1024 threads per alignment; the parallelism is the cells of a
// diagonal times the alignments in flight.  With flags, the (w + 1) / 2
// bytes written per diagonal.

#include <limits.h>

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
