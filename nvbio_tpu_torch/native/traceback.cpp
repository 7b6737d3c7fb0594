// Batch traceback walk + CIGAR/MD/NM construction (host fast path).
//
// Mirrors nvbio_tpu/alignment/cigar.py (traceback_banded,
// cigar_to_string, make_md_string) byte-for-byte; the Python versions
// remain the oracle and fallback.  The reference builds these strings
// in device kernels (ref: nvBowtie/bowtie2/cuda/traceback_inl.h
// finish_alignment_best, mds.h); on TPU the direction flags come from
// the device and the string assembly is host-native, so this loop must
// not be interpreted Python at 100k+ reads/batch.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {
constexpr int DIAG = 0, FROM_E = 1, FROM_F = 2, ORIGIN = 3;
const char* DNA = "ACGTNNNN";

inline void put_int(std::vector<char>& out, long v) {
  char buf[24];
  int n = snprintf(buf, sizeof buf, "%ld", v);
  out.insert(out.end(), buf, buf + n);
}
}  // namespace

namespace {

// Shared: build CIGAR + MD + NM from walk-order op chars (end->start).
inline void build_strings(
    const std::vector<char>& rev, long p_start, long t_start, long plen,
    const uint8_t* pat, const int8_t* win, int global_mode,
    std::vector<char>& cig, std::vector<char>& md,
    int32_t* nm_out, int32_t* span_out) {
  std::vector<char> rev2 = rev;
  long t0 = t_start;
  if (global_mode && t0 > 0) {
    for (long x = 0; x < t0; ++x) rev2.push_back('D');
    t0 = 0;
  }
  if (p_start) { put_int(cig, p_start); cig.push_back('S'); }
  long consumed = p_start, span = 0;
  for (long x = (long)rev2.size(); x > 0;) {
    char op = rev2[x - 1];
    long run = 0;
    while (x > 0 && rev2[x - 1] == op) { ++run; --x; }
    put_int(cig, run);
    cig.push_back(op);
    if (op == 'M' || op == 'I') consumed += run;
    if (op == 'M' || op == 'D') span += run;
  }
  long tail = plen - consumed;
  if (tail > 0) { put_int(cig, tail); cig.push_back('S'); }
  if (cig.empty()) cig.push_back('*');
  long pi = p_start, tj = t0, mrun = 0, nm = 0;
  for (long x = (long)rev2.size(); x > 0;) {
    char op = rev2[x - 1];
    long run = 0;
    while (x > 0 && rev2[x - 1] == op) { ++run; --x; }
    if (op == 'M') {
      for (long y = 0; y < run; ++y) {
        uint8_t a = pat[pi];
        int8_t b = win[tj];
        if (a == (uint8_t)b && a < 4) {
          ++mrun;
        } else {
          put_int(md, mrun);
          md.push_back(DNA[(uint8_t)b & 7]);
          mrun = 0;
          ++nm;
        }
        ++pi; ++tj;
      }
    } else if (op == 'I') {
      pi += run;
      nm += run;
    } else {
      put_int(md, mrun);
      mrun = 0;
      md.push_back('^');
      for (long y = 0; y < run; ++y)
        md.push_back(DNA[(uint8_t)win[tj + y] & 7]);
      tj += run;
      nm += run;
    }
  }
  put_int(md, mrun);
  *nm_out = (int32_t)nm;
  *span_out = (int32_t)span;
}

}  // namespace

// Build SAM strings from device-walked 2-bit op streams (walk order,
// 4 codes/byte; 0=none 1=M 2=D 3=I).
extern "C" long ops_batch(
    const uint8_t* ops, long R, long SP /* packed bytes per read */,
    const int32_t* p_start, const int32_t* t_start,
    const uint8_t* aligned,
    const uint8_t* pats, const int32_t* plens, long Lp,
    const int8_t* genome, const long long* win_start, int global_mode,
    char* cig_blob, long cig_cap, long long* cig_offs,
    char* md_blob, long md_cap, long long* md_offs,
    int32_t* nm_out, long long* pos_out, int32_t* refspan_out) {
  std::vector<char> rev, cig, md;
  long cig_w = 0, md_w = 0;
  cig_offs[0] = 0;
  md_offs[0] = 0;
  const char OPC[4] = {0, 'M', 'D', 'I'};
  for (long r = 0; r < R; ++r) {
    cig.clear(); md.clear();
    nm_out[r] = 0; pos_out[r] = 0; refspan_out[r] = 0;
    if (aligned[r]) {
      rev.clear();
      const uint8_t* row = ops + r * SP;
      for (long b = 0; b < SP; ++b) {
        uint8_t v = row[b];
        for (int s = 0; s < 8; s += 2) {
          int code = (v >> s) & 3;
          if (code) rev.push_back(OPC[code]);
        }
      }
      long ts = t_start[r];
      build_strings(rev, p_start[r], ts, plens[r],
                    pats + r * Lp, genome + win_start[r], global_mode,
                    cig, md, &nm_out[r], &refspan_out[r]);
      pos_out[r] = win_start[r] + (global_mode && ts > 0 ? 0 : ts);
    }
    if (cig_w + (long)cig.size() > cig_cap) return -1;
    if (md_w + (long)md.size() > md_cap) return -2;
    memcpy(cig_blob + cig_w, cig.data(), cig.size());
    cig_w += (long)cig.size();
    memcpy(md_blob + md_w, md.data(), md.size());
    md_w += (long)md.size();
    cig_offs[r + 1] = cig_w;
    md_offs[r + 1] = md_w;
  }
  return 0;
}

extern "C" long tb_batch(
    const uint8_t* dirs, long R, long Lp, long BAND,
    const int32_t* p_end, const int32_t* t_end, const uint8_t* aligned,
    const uint8_t* pats, const int32_t* plens,
    const int8_t* genome, long long glen,
    const long long* win_start, int band_w, int global_mode,
    char* cig_blob, long cig_cap, long long* cig_offs,
    char* md_blob, long md_cap, long long* md_offs,
    int32_t* nm_out, int32_t* pos_out, int32_t* refspan_out) {
  std::vector<char> rev;   // reversed op chars
  std::vector<char> cig;   // one read's CIGAR text
  std::vector<char> md;    // one read's MD text
  long cig_w = 0, md_w = 0;
  cig_offs[0] = 0;
  md_offs[0] = 0;
  for (long r = 0; r < R; ++r) {
    cig.clear();
    md.clear();
    nm_out[r] = 0;
    pos_out[r] = 0;
    refspan_out[r] = 0;
    if (aligned[r]) {
      const uint8_t* D = dirs + r * Lp * BAND;
      long i = p_end[r];
      long k = (long)t_end[r] - i + band_w;
      rev.clear();
      int state = 0;  // 0=H 1=E 2=F
      for (;;) {
        if (state == 0) {
          if (i == 0) break;
          int f = D[(i - 1) * BAND + k] & 3;
          if (f == ORIGIN) break;
          if (f == DIAG) { rev.push_back('M'); --i; }
          else if (f == FROM_E) state = 1;
          else state = 2;
        } else if (state == 1) {
          rev.push_back('D');
          int was_open = (D[(i - 1) * BAND + k] >> 2) & 1;
          --k;
          if (was_open) state = 0;
        } else {
          rev.push_back('I');
          int was_open = (D[(i - 1) * BAND + k] >> 3) & 1;
          --i; ++k;
          if (was_open) state = 0;
        }
      }
      long j = i + k - band_w;
      if (global_mode && j > 0) {
        for (long x = 0; x < j; ++x) rev.push_back('D');
        j = 0;
      }
      long p_start = i, t_start = j;
      // ---- CIGAR: soft clips + run-length of reversed ops ----
      if (p_start) { put_int(cig, p_start); cig.push_back('S'); }
      long consumed = p_start, span = 0;
      for (long x = (long)rev.size(); x > 0;) {
        char op = rev[x - 1];
        long run = 0;
        while (x > 0 && rev[x - 1] == op) { ++run; --x; }
        put_int(cig, run);
        cig.push_back(op);
        if (op == 'M' || op == 'I') consumed += run;
        if (op == 'M' || op == 'D') span += run;
      }
      long tail = plens[r] - consumed;
      if (tail > 0) { put_int(cig, tail); cig.push_back('S'); }
      if (cig.empty()) cig.push_back('*');
      // ---- MD / NM over the forward-order ops ----
      const uint8_t* pat = pats + r * Lp;
      const int8_t* win = genome + win_start[r];
      long pi = p_start, tj = t_start, mrun = 0, nm = 0;
      for (long x = (long)rev.size(); x > 0;) {
        char op = rev[x - 1];
        long run = 0;
        while (x > 0 && rev[x - 1] == op) { ++run; --x; }
        if (op == 'M') {
          for (long y = 0; y < run; ++y) {
            uint8_t a = pat[pi];
            int8_t b = win[tj];
            if (a == (uint8_t)b && a < 4) {
              ++mrun;
            } else {
              put_int(md, mrun);
              md.push_back(DNA[(uint8_t)b & 7]);
              mrun = 0;
              ++nm;
            }
            ++pi; ++tj;
          }
        } else if (op == 'I') {
          pi += run;
          nm += run;
        } else {  // D
          put_int(md, mrun);
          mrun = 0;
          md.push_back('^');
          for (long y = 0; y < run; ++y)
            md.push_back(DNA[(uint8_t)win[tj + y] & 7]);
          tj += run;
          nm += run;
        }
      }
      put_int(md, mrun);
      nm_out[r] = (int32_t)nm;
      pos_out[r] = (int32_t)(win_start[r] + t_start);
      refspan_out[r] = (int32_t)span;
    }
    if (cig_w + (long)cig.size() > cig_cap) return -1;
    if (md_w + (long)md.size() > md_cap) return -2;
    memcpy(cig_blob + cig_w, cig.data(), cig.size());
    cig_w += (long)cig.size();
    memcpy(md_blob + md_w, md.data(), md.size());
    md_w += (long)md.size();
    cig_offs[r + 1] = cig_w;
    md_offs[r + 1] = md_w;
  }
  (void)glen;
  return 0;
}
