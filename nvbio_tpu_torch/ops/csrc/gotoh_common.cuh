// What the banded Gotoh kernels (banded_gotoh.cu, long_gotoh.cu) share:
// the output contract's constants, the scoring scheme, the argument block
// of their C entry points, and the quality-scaled mismatch term.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG_INF = -(1 << 30);
constexpr int SCORE_FLOOR = -(1 << 19);
constexpr int PAD_SYMBOL = 7;

enum AType { GLOBAL = 0, SEMI_GLOBAL = 1, LOCAL = 2 };

struct Scheme {
  int match, mm_min, mm_max, n_penalty;
  int eo, ee, fo, fe;  // E (read gap, CIGAR D) and F (ref gap, CIGAR I)
};

struct Args {
  const int8_t* pats;        // (nb, lp)
  const uint8_t* quals;      // (nb, lp)
  const int32_t* plens;      // (nb,)
  const int32_t* tlens;      // (nb,)
  const int8_t* texts;       // (nb, lt) symbol windows
  const int32_t* gwords;     // packed genome, 16 symbols per word
  const int64_t* win_start;  // (nb,) window start in symbols (packed)
  int64_t n_words;
  int nb, lp, lt, band_w;
  Scheme sc;
  int32_t* out;              // (3, nb): score, p_end, t_end
  uint8_t* dirs;             // (nb, lp, 2 * band_w + 1)
};

// Python's // (floor) for the quality term, also when --mp gives MX < MN
__device__ __forceinline__ int floor_div40(int x) {
  const int d = x / 40;
  return (x % 40 != 0 && x < 0) ? d - 1 : d;
}

Args make_args(const void* pats, const void* quals, const void* plens,
               const void* tlens, int nb, int lp, int band_w, int match,
               int mm_min, int mm_max, int n_penalty, int eo, int ee, int fo,
               int fe, void* out) {
  Args a = {};
  a.pats = static_cast<const int8_t*>(pats);
  a.quals = static_cast<const uint8_t*>(quals);
  a.plens = static_cast<const int32_t*>(plens);
  a.tlens = static_cast<const int32_t*>(tlens);
  a.nb = nb;
  a.lp = lp;
  a.band_w = band_w;
  a.sc = Scheme{match, mm_min, mm_max, n_penalty, eo, ee, fo, fe};
  a.out = static_cast<int32_t*>(out);
  return a;
}

}  // namespace
