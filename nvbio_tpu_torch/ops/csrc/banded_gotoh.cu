// Banded Gotoh affine-gap DP for Hopper (sm_90a): K1, K3 and K2.
//
//   k1_banded_score          symbol windows, score + sink
//       replaces nvbio_tpu/ops/banded_dp.py  banded_score_pallas
//       (_make_kernel32, reached through banded_score_pallas_staged)
//   k3_banded_score_packed   windows of the 2-bit packed genome, score + sink
//       replaces nvbio_tpu/ops/banded_dp.py  banded_score_pallas_packed
//       (_make_kernel32_packed)
//   k2_banded_directions     symbol windows, score + sink + one flag byte
//       per band cell
//       replaces nvbio_tpu/ops/banded_dp.py  banded_directions_pallas
//       (_make_kernel32 with dirs_ref)
//
// What they compute is nvbio_tpu_torch/alignment/batched.py cell for cell
// (the plain PyTorch versions, which mirror the JAX twin): invalid cells
// (j < 0 or j > tlen) are masked to NEG_INF every row, so no sentinel
// drift needs bounding, and the outputs follow the Pallas kernels'
// contract (floor clamp, SEMI_GLOBAL last-row mask with the lowest k on
// ties, LOCAL earliest-row-then-lowest-k sink, zero-length patterns,
// t_end = max(p_end + k - w, 0), a GLOBAL goal outside the band gives
// NEG_INF).
//
// All three run the sub-warp band-parallel kernel of group_gotoh.cuh
// (shared with K4's tiers up to 128 cells), for bands up to 64 cells:
// G lanes own an alignment, CPT cells each (its with_tier gives both by
// band and by flags).  The TPU kernels put the batch across VPU lanes and
// the band across sublanes and solved the in-row E recurrence with a
// Kogge-Stone scan; on the H100 one thread an alignment (the design
// these entries had before) ran E sequentially along the band, kept too
// few warps in flight on the mapper's calls (~32 768 lanes, 8 warps an
// SM) to hide the row-to-row dependence, and read pattern, quality and
// genome words uncoalesced on that chain.  The group kernel folds E with
// a group max-scan, stages the next 16 rows' pattern, mismatch and text
// symbols in shared memory a chunk ahead, scores a cell with one prmt
// into a per-row byte table and DPX max forms, and, with several lanes an
// alignment, keeps several times the warps in flight.  What bounds it:
// integer issue (the score cell's least count is 10 instructions, 18
// with flags, chip_smoke.py GOTOH_OPS) plus the group's per-row
// shuffles, scan and staging; with flags also the 16-byte stores of the
// flag rows.  The score-only kernels stop at the longest pattern of the
// warp, so the mapper's zero-length pad lanes past its kept candidates
// cost a warp nothing once all its groups are pads.

#include "gotoh_common.cuh"
#include "group_gotoh.cuh"

namespace {

// the widest band, in cells (the wrappers' MAX_BAND: route() sends wider
// bands to K4, and these entry points refuse them)
constexpr int MAX_BAND = 64;

template <bool PACKED, bool DIRS>
int launch(const Args& a, int atype, void* stream) {
  return static_cast<int>(grp::launch<PACKED, DIRS, MAX_BAND>(
      a, atype, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// All pointers are device pointers; out is (3, nb) int32.  Returns the
// cudaError_t of the launch (0 on success).
int k1_banded_score(const void* pats, const void* quals, const void* plens,
                    const void* texts, const void* tlens, int nb, int lp,
                    int lt, int band_w, int atype, int match, int mm_min,
                    int mm_max, int n_penalty, int eo, int ee, int fo, int fe,
                    void* out, void* stream) {
  Args a = make_args(pats, quals, plens, tlens, nb, lp, band_w, match, mm_min,
                     mm_max, n_penalty, eo, ee, fo, fe, out);
  a.texts = static_cast<const int8_t*>(texts);
  a.lt = lt;
  return launch<false, false>(a, atype, stream);
}

int k3_banded_score_packed(const void* pats, const void* quals,
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
  return launch<true, false>(a, atype, stream);
}

int k2_banded_directions(const void* pats, const void* quals,
                         const void* plens, const void* texts,
                         const void* tlens, int nb, int lp, int lt,
                         int band_w, int atype, int match, int mm_min,
                         int mm_max, int n_penalty, int eo, int ee, int fo,
                         int fe, void* out, void* dirs, void* stream) {
  Args a = make_args(pats, quals, plens, tlens, nb, lp, band_w, match, mm_min,
                     mm_max, n_penalty, eo, ee, fo, fe, out);
  a.texts = static_cast<const int8_t*>(texts);
  a.lt = lt;
  a.dirs = static_cast<uint8_t*>(dirs);
  return launch<false, true>(a, atype, stream);
}

// cudaGetErrorString for the wrapper's messages
const char* banded_gotoh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
