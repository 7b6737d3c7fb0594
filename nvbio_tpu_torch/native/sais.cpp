// Suffix-array construction by induced sorting (SA-IS).
//
// Native host path for large-reference index construction (nvBWT
// equivalent).  The reference GPU library builds multi-gigabase BWTs
// with a blockwise difference-cover sort (ref: nvbio/sufsort/sufsort.h
// cuda::blockwise_suffix_sort, dcs.h, compression_sort.h); that design
// leans on comparator-based segmented sorts which have no XLA
// counterpart, so the TPU build uses linear-time induced sorting on the
// host for beyond-HBM references (this file) and an on-device
// prefix-doubling sort for in-HBM references (sufsort/device.py).
//
// Algorithm: Nong, Zhang & Chan, "Two Efficient Algorithms for Linear
// Time Suffix Array Construction" (2009) — implemented from the paper's
// description.  Convention matches sufsort/sa.py: the suffix array of T
// is computed as SA(T + '$') with the sentinel smaller than every
// symbol, and the leading sentinel row dropped.
//
// Index type is templated: int32 for n < 2^31 (half the memory
// traffic), int64 beyond (hg38 fwd+rev concatenation needs it).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>
#if defined(__linux__)
#include <sys/mman.h>
#endif

// Big-buffer allocator (2 MB aligned).  NOTE: MADV_HUGEPAGE was tried
// and REVERTED — this host runs THP defrag=madvise, so the advice
// triggers synchronous compaction at fault time and a 4 GB buffer can
// stall for minutes on a fragmented machine.  Plain pages it is.
template <typename T>
struct HugeBuf {
  T* p = nullptr;
  size_t n = 0;
  explicit HugeBuf(size_t count) : n(count) {
    size_t bytes = (count * sizeof(T) + (1 << 21) - 1) & ~size_t((1 << 21) - 1);
    p = (T*)aligned_alloc(1 << 21, bytes);
  }
  ~HugeBuf() { free(p); }
  HugeBuf(const HugeBuf&) = delete;
  T* data() { return p; }
};

static inline double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}
static inline bool sais_verbose() {
  static int v = -1;
  if (v < 0) v = getenv("NVBIO_SAIS_VERBOSE") ? 1 : 0;
  return v;
}
#define SAIS_T(label) do { if (sais_verbose() && n > (1 << 24)) { \
    double t1 = now_s(); \
    fprintf(stderr, "[sais n=%lld] %-12s %.2fs\n", (long long)n, label, \
            t1 - _tprev); _tprev = t1; } } while (0)

namespace {

template <typename I>
struct TypeBits {
  // S/L type flags, one bit per position.
  std::vector<uint64_t> w;
  explicit TypeBits(I n) : w((size_t(n) + 63) / 64, 0) {}
  inline bool get(I i) const { return (w[size_t(i) >> 6] >> (i & 63)) & 1; }
  inline void set(I i, bool v) {
    uint64_t m = uint64_t(1) << (i & 63);
    if (v) w[size_t(i) >> 6] |= m; else w[size_t(i) >> 6] &= ~m;
  }
};

template <typename I, typename T>
inline bool is_lms(const TypeBits<I>& t, const T*, I i) {
  return i > 0 && t.get(i) && !t.get(i - 1);
}

template <typename I, typename T>
void get_counts(const T* s, I n, I K, std::vector<I>& C) {
  C.assign(size_t(K), 0);
  for (I i = 0; i < n; ++i) ++C[size_t(s[i])];
}

template <typename I>
void get_buckets(const std::vector<I>& C, std::vector<I>& B, bool end) {
  I sum = 0;
  B.resize(C.size());
  for (size_t i = 0; i < C.size(); ++i) {
    sum += C[i];
    B[i] = end ? sum : sum - C[i];
  }
}

// Induce L-type then S-type suffixes from the placed seeds.
//
// Entries carry one bit in their sign: +(j+1) when t(j-1) is L-type,
// -(j+1) when it is S-type (or j == 0); 0 is empty.  The writer always
// knows t(j) for the position it places, so the predecessor's type is
// a pure symbol comparison (equal symbols inherit the writer's type) —
// the hot loops never touch the type bitvector, whose random lookups
// miss cache at gigabase scale.  Software prefetch hides the random
// text reads (the induced position is known PF iterations ahead).
template <typename I, typename T>
void induce(const T* s, I* SA, I n, I K, const std::vector<I>& C,
            std::vector<I>& B, bool decode) {
  const I PF = 16;
  // left-to-right pass: predecessors of entries flagged pred-L
  get_buckets(C, B, false);
  for (I i = 0; i < n; ++i) {
    if (i + PF < n) {
      I vp = SA[i + PF];
      if (vp > 1) __builtin_prefetch(s + (vp - 2));
    }
    I v = SA[i];
    if (v > 0) {
      I nj = v - 2;  // j - 1 where j = v - 1 (flag implies j > 0)
      T c = s[nj];
      bool predL = nj > 0 && s[nj - 1] >= c;  // equal inherits L
      SA[B[size_t(c)]++] = predL ? (nj + 1) : -(nj + 1);
    }
  }
  // right-to-left pass: predecessors of entries flagged pred-S
  get_buckets(C, B, true);
  for (I i = n; i-- > 0;) {
    if (i >= PF) {
      I vp = SA[i - PF];
      if (vp < -1) __builtin_prefetch(s + (-vp - 2));
    }
    I v = SA[i];
    if (v < -1) {  // pred is S and j > 0
      I nj = -v - 2;
      T c = s[nj];
      bool predL = nj > 0 && s[nj - 1] > c;  // equal inherits S
      SA[--B[size_t(c)]] = predL ? (nj + 1) : -(nj + 1);
    }
    if (decode && v != 0) SA[i] = (v > 0 ? v : -v) - 1;
  }
}

// Core recursion.  s[n-1] must be a unique smallest sentinel (value 0).
template <typename I, typename T>
void sais_rec(const T* s, I* SA, I n, I K) {
  if (n == 1) { SA[0] = 0; return; }
  double _tprev = now_s();
  TypeBits<I> t(n);
  t.set(n - 1, true);
  for (I i = n - 1; i-- > 0;)
    t.set(i, s[i] < s[i + 1] || (s[i] == s[i + 1] && t.get(i + 1)));

  SAIS_T("typebits");
  std::vector<I> C, B;
  get_counts(s, n, K, C);

  // ---- stage 1: sort LMS substrings by induction -------------------
  // entries are sign-encoded (see induce); an LMS seed's predecessor
  // is L by definition, so seeds carry the + flag
  for (I i = 0; i < n; ++i) SA[i] = 0;
  get_buckets(C, B, true);
  for (I i = 1; i < n; ++i)
    if (is_lms(t, s, i)) SA[--B[size_t(s[i])]] = i + 1;
  SAIS_T("seed1");
  induce(s, SA, n, K, C, B, /*decode=*/true);
  SAIS_T("induce1");

  // compact sorted LMS positions to the front
  I n1 = 0;
  for (I i = 0; i < n; ++i) {
    if (i + 16 < n) {
      I jp = SA[i + 16];
      __builtin_prefetch(&t.w[size_t(jp) >> 6]);
    }
    if (is_lms(t, s, SA[i])) SA[n1++] = SA[i];
  }

  SAIS_T("compact");
  // name LMS substrings in SA[n1..n)
  for (I i = n1; i < n; ++i) SA[i] = -1;
  I name = 0;
  I prev = -1;
  for (I i = 0; i < n1; ++i) {
    if (i + 4 < n1) {
      I pp = SA[i + 4];
      __builtin_prefetch(s + pp);
      __builtin_prefetch(&t.w[size_t(pp) >> 6]);
    }
    I pos = SA[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (I d = 0;; ++d) {
        if (s[pos + d] != s[prev + d] || t.get(pos + d) != t.get(prev + d)) {
          diff = true;
          break;
        }
        if (d > 0) {
          bool lp = is_lms(t, s, pos + d), lq = is_lms(t, s, prev + d);
          if (lp != lq) { diff = true; break; }
          if (lp) break;  // both substrings ended, equal
        }
      }
    }
    if (diff) { ++name; prev = pos; }
    SA[n1 + pos / 2] = name - 1;
  }
  SAIS_T("naming");
  // gather names into the reduced string (text order)
  I k = n - 1;
  for (I i = n; i-- > I(n1);)
    if (SA[i] >= 0) SA[k--] = SA[i];
  I* s1 = SA + n - n1;

  // ---- recurse if names are not unique -----------------------------
  if (name < n1) {
    sais_rec<I, I>(s1, SA, n1, name);
  } else {
    for (I i = 0; i < n1; ++i) SA[size_t(s1[i])] = i;
  }

  SAIS_T("recurse");
  // map reduced-problem order back to LMS text positions
  {
    I j = 0;
    std::vector<I> P;
    P.resize(size_t(n1));
    for (I i = 1; i < n; ++i)
      if (is_lms(t, s, i)) P[size_t(j++)] = i;
    for (I i = 0; i < n1; ++i) {
      if (i + 16 < n1) __builtin_prefetch(&P[size_t(SA[i + 16])]);
      SA[i] = P[size_t(SA[i])];
    }
  }

  SAIS_T("pmap");
  // ---- stage 2: place LMS in final order, induce the rest ----------
  for (I i = n1; i < n; ++i) SA[i] = 0;
  get_buckets(C, B, true);
  for (I i = n1; i-- > 0;) {
    I j = SA[i];
    SA[i] = 0;
    SA[--B[size_t(s[j])]] = j + 1;  // LMS: predecessor is L
  }
  SAIS_T("seed2");
  induce(s, SA, n, K, C, B, /*decode=*/true);
  SAIS_T("induce2");
}

template <typename I, typename O>
long run_sais(const uint8_t* text, long n, O* sa_out) {
  // append sentinel; shift symbols +1 so 0 is the unique sentinel
  uint8_t maxsym = 0;
  for (long i = 0; i < n; ++i)
    if (text[i] > maxsym) maxsym = text[i];
  I m = I(n) + 1;
  HugeBuf<I> SA{size_t(m)};
  if (!SA.data()) return -3;
  if (maxsym < 255) {
    HugeBuf<uint8_t> s{size_t(m)};
    if (!s.data()) return -3;
    for (long i = 0; i < n; ++i) s.data()[size_t(i)] = text[i] + 1;
    s.data()[size_t(n)] = 0;
    sais_rec<I, uint8_t>(s.data(), SA.data(), m, I(maxsym) + 2);
  } else {
    HugeBuf<I> s{size_t(m)};
    if (!s.data()) return -3;
    for (long i = 0; i < n; ++i) s.data()[size_t(i)] = I(text[i]) + 1;
    s.data()[size_t(n)] = 0;
    sais_rec<I, I>(s.data(), SA.data(), m, I(maxsym) + 2);
  }
  if (SA.data()[0] != I(n)) return -1;  // sentinel row must sort first
  for (long i = 0; i < n; ++i) sa_out[i] = (O)SA.data()[size_t(i) + 1];
  return 0;
}

}  // namespace

namespace {

// Fused BWT + packed words + blocked occ tables in ONE pass over the
// suffix array (fmindex/build.py build_fm_arrays).  Replaces four
// NumPy stages (bwt gather, pack_2bit's ~12x-traffic shift/reduce,
// the occ slab loop, and a (n/16, 4) int64 cumsum buffer) with a
// single traversal whose only non-streaming access is the unavoidable
// text[sa[i]-1] gather (software-prefetched ~24 rows ahead).
//
// Layout matches fmindex/build.py exactly: BLOCK=128 symbols/block,
// WORDS=8 uint32 words/block (16 symbols/word, LSB-first 2-bit),
// n_blocks = ceil((n+1)/128) + 1, zero-padded tail symbols counted as
// 'A', row `primary` (suffix '$') holding a counted dummy 'A'.
// occ_abs[b] = exclusive block-start counts (int32); occ_sub[b][w] =
// word-start minus block-start (int8, <= 112).
template <typename I>
long fm_bwt_occ_impl(const uint8_t* text, long n, const I* sa,
                     uint32_t* bwt_words, int32_t* occ_abs,
                     int8_t* occ_sub, long long* primary) {
  if (n <= 0) return -1;
  const long m = n + 1;
  const long n_blocks = (m + 127) / 128 + 1;
  long long cum[4] = {0, 0, 0, 0};
  *primary = -1;
  long idx = 0;
  for (long b = 0; b < n_blocks; ++b) {
    for (int c = 0; c < 4; ++c) occ_abs[b * 4 + c] = (int32_t)cum[c];
    for (int w = 0; w < 8; ++w) {
      for (int c = 0; c < 4; ++c)
        occ_sub[(b * 8 + w) * 4 + c] =
            (int8_t)(cum[c] - (long long)occ_abs[b * 4 + c]);
      uint32_t word = 0;
      for (int s = 0; s < 16; ++s, ++idx) {
        uint32_t sym = 0;
        if (idx < m) {
          if (idx + 24 < m)
            __builtin_prefetch(&text[(long)sa[idx + 23] - 1]);
          if (idx == 0) {
            sym = uint32_t(text[n - 1] & 3);
          } else {
            const long p = (long)sa[idx - 1];
            if (p == 0) *primary = idx;  // dummy 'A' stays counted
            else sym = uint32_t(text[p - 1] & 3);
          }
        }
        word |= sym << (2 * s);
        cum[sym]++;
      }
      bwt_words[b * 8 + w] = word;
    }
  }
  return *primary < 0 ? -2 : 0;
}

// Sampled-SA (SSA) mark bitmap + rank blocks + sampled values in one
// pass (fmindex/build.py build_fm_arrays tail).  Row i of the
// conceptual matrix holds SA value (i == 0 ? n : sa[i-1]); rows with
// value % k < thresh are marked (thresh 2 = the bi-marked fm2
// variant).  Outputs: LSB-first 32-bit mark words over the padded row
// range, exclusive popcount prefix per word (int32), and the marked
// values in row order (int32).  `cap` bounds the vals buffer: the
// write stops (return -4) BEFORE overflowing it, so a mis-sized
// caller allocation can never corrupt the heap.  Returns the number
// of marked rows.
template <typename I>
long ssa_build_impl(const I* sa, long n, int k, int thresh,
                    long n_words, uint32_t* mark_words,
                    int32_t* mark_abs, int32_t* vals, long cap) {
  const long m = n + 1;
  const bool pow2 = (k & (k - 1)) == 0;
  const uint32_t km = uint32_t(k - 1);
  long long cum = 0;
  long nv = 0;
  long idx = 0;
  for (long w = 0; w < n_words; ++w) {
    mark_abs[w] = (int32_t)cum;
    uint32_t word = 0;
    for (int r = 0; r < 32; ++r, ++idx) {
      if (idx >= m) continue;
      const int64_t v = (idx == 0) ? (int64_t)n : (int64_t)sa[idx - 1];
      const int64_t res = pow2 ? (int64_t)(uint64_t(v) & km) : v % k;
      if (res < thresh) {
        if (nv >= cap) return -4;
        word |= 1u << r;
        vals[nv++] = (int32_t)v;
        ++cum;
      }
    }
    mark_words[w] = word;
  }
  return nv;
}

}  // namespace

extern "C" {

// Suffix array (sentinel-smallest convention) of `text` (uint8
// symbols), written to sa_out[0..n).  Returns 0 on success.
long sais_u8(const uint8_t* text, long n, long long* sa_out) {
  if (n <= 0) return 0;
  if (n + 1 < 0x7fffffffL) return run_sais<int32_t>(text, n, sa_out);
  return run_sais<int64_t>(text, n, sa_out);
}

// int32 output variant for n + 1 < 2^31: lets the caller keep the SA
// in 4n bytes end-to-end (an hg-scale shard saves ~9 GB of int64
// temporaries + a conversion pass).
long sais_u8_i32(const uint8_t* text, long n, int32_t* sa_out) {
  if (n <= 0) return 0;
  if (n + 1 >= 0x7fffffffL) return -2;
  return run_sais<int32_t>(text, n, sa_out);
}

// BWT emit: bwt_out[i] = text[sa[i]-1] for sa[i]>0; the sentinel row
// (sa row with sa==0 → conceptual row holds '$') is reported via
// *primary and its slot written as 0.  sa has n entries (sentinel row
// excluded); bwt_out has n+1 (row 0 = suffix '$' → text[n-1]).
long sais_bwt(const uint8_t* text, long n, const long long* sa,
              uint8_t* bwt_out, long long* primary) {
  if (n <= 0) return -1;
  bwt_out[0] = text[n - 1];
  *primary = -1;
  for (long i = 0; i < n; ++i) {
    long long p = sa[i];
    if (p == 0) { bwt_out[i + 1] = 0; *primary = i + 1; }
    else bwt_out[i + 1] = text[p - 1];
  }
  return *primary < 0 ? -1 : 0;
}

// Fused BWT+pack+occ entry points (see fm_bwt_occ_impl above).
long fm_bwt_occ_i32(const uint8_t* text, long n, const int32_t* sa,
                    uint32_t* bwt_words, int32_t* occ_abs,
                    int8_t* occ_sub, long long* primary) {
  return fm_bwt_occ_impl<int32_t>(text, n, sa, bwt_words, occ_abs,
                                  occ_sub, primary);
}

long fm_bwt_occ_i64(const uint8_t* text, long n, const int64_t* sa,
                    uint32_t* bwt_words, int32_t* occ_abs,
                    int8_t* occ_sub, long long* primary) {
  return fm_bwt_occ_impl<int64_t>(text, n, sa, bwt_words, occ_abs,
                                  occ_sub, primary);
}

// SSA mark/rank/values entry points (see ssa_build_impl above).
long ssa_build_i32(const int32_t* sa, long n, int k, int thresh,
                   long n_words, uint32_t* mark_words,
                   int32_t* mark_abs, int32_t* vals, long cap) {
  return ssa_build_impl<int32_t>(sa, n, k, thresh, n_words, mark_words,
                                 mark_abs, vals, cap);
}

long ssa_build_i64(const int64_t* sa, long n, int k, int thresh,
                   long n_words, uint32_t* mark_words,
                   int32_t* mark_abs, int32_t* vals, long cap) {
  return ssa_build_impl<int64_t>(sa, n, k, thresh, n_words, mark_words,
                                 mark_abs, vals, cap);
}

// k-mer suffix-key histogram for the FM-index lookup table
// (fmindex/build.py build_kmer_lut).  For every suffix i of `text`
// (2-bit symbols; out-of-range positions read as 'A'), the key is the
// first k symbols packed big-endian, and key2 = key*2 + (suffix has
// >= k symbols).  counts[key2] (size 2 << 2k, caller-zeroed) receives
// the multiset histogram; the Python side turns its cumsum into the
// [lo, hi) SA ranges.
//
// The histogram spans 2^(2k+1) bins (33 MB of uint32 at k=11), so
// naive increments take a cache+TLB miss per suffix.  Each 1M-key
// chunk is instead counting-partitioned by the top 8 key bits, then
// drained bucket by bucket — every drain touches one nbin/256 slice
// (~130 KB at k=11) that stays L2-resident.  ~8x over the blocked
// NumPy rolling-key build at hg-shard scale.
long kmer_hist(const uint8_t* text, long n, int k, long long* counts) {
  if (n <= 0 || k < 1 || k > 15) return -1;
  // Per-bin tallies accumulate in uint32 (a bin can receive up to n
  // counts); make the implicit n < 2^32 bound explicit and local.
  if (n >= (1LL << 32)) return -2;
  const uint32_t mask = (1u << (2 * k)) - 1;
  const long nbin = 2L << (2 * k);
  uint32_t key = 0;
  for (int j = 0; j < k; ++j)
    key = (key << 2) | (j < n ? uint32_t(text[j] & 3) : 0u);

  if (2 * k + 1 <= 18) {  // histogram <= 1 MB: direct increments
    std::vector<uint32_t> hist(size_t(nbin), 0);
    for (long i = 0; i < n; ++i) {
      hist[(key << 1) | (i + k <= n ? 1u : 0u)]++;
      long nx = i + k;
      key = ((key << 2) | (nx < n ? uint32_t(text[nx] & 3) : 0u)) & mask;
    }
    for (long j = 0; j < nbin; ++j) counts[j] += (long long)hist[j];
    return 0;
  }

  const int NB = 256;
  const int shift = 2 * k + 1 - 8;  // bucket = key2 >> shift
  const long CH = 1L << 20;
  HugeBuf<uint32_t> hist{size_t(nbin)};
  if (!hist.p) return -3;
  std::memset(hist.p, 0, size_t(nbin) * sizeof(uint32_t));
  std::vector<uint32_t> kbuf{}, part{};
  kbuf.resize(size_t(CH));
  part.resize(size_t(CH));
  std::vector<uint32_t> boff(NB + 1);
  for (long s = 0; s < n; s += CH) {
    const long m = (n - s < CH) ? (n - s) : CH;
    for (long t = 0; t < m; ++t) {
      const long i = s + t;
      kbuf[size_t(t)] = (key << 1) | (i + k <= n ? 1u : 0u);
      const long nx = i + k;
      key = ((key << 2) | (nx < n ? uint32_t(text[nx] & 3) : 0u)) & mask;
    }
    uint32_t bcnt[NB];
    std::memset(bcnt, 0, sizeof(bcnt));
    for (long t = 0; t < m; ++t) bcnt[kbuf[size_t(t)] >> shift]++;
    boff[0] = 0;
    for (int b = 0; b < NB; ++b) boff[b + 1] = boff[b] + bcnt[b];
    uint32_t cur[NB];
    std::memcpy(cur, boff.data(), sizeof(cur));
    for (long t = 0; t < m; ++t) {
      const uint32_t k2 = kbuf[size_t(t)];
      part[cur[k2 >> shift]++] = k2;
    }
    for (long t = 0; t < m; ++t) hist.p[part[size_t(t)]]++;
  }
  for (long j = 0; j < nbin; ++j) counts[j] += (long long)hist.p[j];
  return 0;
}

}  // extern "C"
