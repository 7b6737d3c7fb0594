// Native host I/O: FASTQ parsing + BGZF compression.
//
// Plays the role of the reference's host-native I/O layer (ref:
// io/sequence/sequence_fastq.cpp FASTQ scanner; contrib zlib + BGZF in
// output_bam.cpp): the mapper's input path must keep TPUs fed, so the
// byte-level work is C++ (SURVEY.md §7.0).  Exposed through ctypes —
// plain C ABI, no pybind11 (not available in this image).
//
// Build: g++ -O3 -shared -fPIC fastio.cpp -o _fastio.so -lz

#include <cstring>
#include <cstdint>
#include <zlib.h>

static signed char SYM[256];
static bool sym_init = false;

static void init_sym() {
    if (sym_init) return;
    for (int i = 0; i < 256; i++) SYM[i] = 4;  // N/unknown
    SYM[(int)'A'] = SYM[(int)'a'] = 0;
    SYM[(int)'C'] = SYM[(int)'c'] = 1;
    SYM[(int)'G'] = SYM[(int)'g'] = 2;
    SYM[(int)'T'] = SYM[(int)'t'] = 3;
    sym_init = true;
}

extern "C" {

// Parse a complete FASTQ buffer into padded batch matrices.
//   reads:  (max_reads, max_len) int8, pre-filled by caller (pad = 7)
//   quals:  (max_reads, max_len) uint8
//   lens:   (max_reads,) int32
//   names:  flat char blob (\0-separated), capacity names_cap
//   name_offs: (max_reads+1,) int64 offsets into names
// Returns #reads parsed, or -1 on malformed input / capacity overflow.
long fastq_parse(const char* buf, long n, long max_len,
                 signed char* reads, unsigned char* quals, int* lens,
                 char* names, long names_cap, long* name_offs,
                 long max_reads) {
    init_sym();
    long i = 0, r = 0, noff = 0;
    name_offs[0] = 0;
    while (i < n) {
        while (i < n && (buf[i] == '\n' || buf[i] == '\r')) i++;
        if (i >= n) break;
        if (buf[i] != '@' || r >= max_reads) return -1;
        i++;  // skip '@'
        long ns = i;
        while (i < n && buf[i] != '\n' && buf[i] != ' ' && buf[i] != '\t'
               && buf[i] != '\r') i++;
        long nlen = i - ns;
        if (noff + nlen + 1 > names_cap) return -1;
        memcpy(names + noff, buf + ns, nlen);
        noff += nlen;
        names[noff++] = '\0';
        name_offs[r + 1] = noff;
        while (i < n && buf[i] != '\n') i++;  // rest of header
        i++;
        long ss = i;  // sequence line
        while (i < n && buf[i] != '\n' && buf[i] != '\r') i++;
        long slen = i - ss;
        long keep = slen < max_len ? slen : max_len;
        signed char* rd = reads + r * max_len;
        for (long j = 0; j < keep; j++) rd[j] = SYM[(unsigned char)buf[ss + j]];
        lens[r] = (int)keep;
        while (i < n && buf[i] != '\n') i++;
        i++;
        if (i >= n || buf[i] != '+') return -1;
        while (i < n && buf[i] != '\n') i++;  // '+' line
        i++;
        long qs = i;
        while (i < n && buf[i] != '\n' && buf[i] != '\r') i++;
        if (i - qs < slen) return -1;
        unsigned char* qd = quals + r * max_len;
        for (long j = 0; j < keep; j++) {
            int q = (unsigned char)buf[qs + j] - 33;
            qd[j] = q < 0 ? 0 : (unsigned char)q;
        }
        while (i < n && buf[i] != '\n') i++;
        i++;
        r++;
    }
    return r;
}

// Count FASTQ records (cheap pre-pass for allocation).
long fastq_count(const char* buf, long n) {
    long lines = 0;
    for (long i = 0; i < n; i++) if (buf[i] == '\n') lines++;
    if (n > 0 && buf[n - 1] != '\n') lines++;
    return lines / 4;
}

// BGZF-compress `data` into independent <=0xFF00-byte blocks.
// Returns bytes written to out, or -1 if out_cap too small.
long bgzf_compress(const unsigned char* data, long n,
                   unsigned char* out, long out_cap, int level) {
    const long CHUNK = 0xFF00;
    long off = 0, w = 0;
    while (off < n) {
        long m = n - off < CHUNK ? n - off : CHUNK;
        // deflate raw
        unsigned char cbuf[0x11000];
        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                         Z_DEFAULT_STRATEGY) != Z_OK) return -1;
        zs.next_in = (Bytef*)(data + off);
        zs.avail_in = (uInt)m;
        zs.next_out = cbuf;
        zs.avail_out = sizeof(cbuf);
        if (deflate(&zs, Z_FINISH) != Z_STREAM_END) {
            deflateEnd(&zs);
            return -1;
        }
        long clen = (long)zs.total_out;
        deflateEnd(&zs);
        long bsize = clen + 25 + 1;
        if (w + bsize + 1 > out_cap || bsize > 0x10000) return -1;
        unsigned char* h = out + w;
        h[0] = 0x1f; h[1] = 0x8b; h[2] = 8; h[3] = 4;
        memset(h + 4, 0, 5);
        h[9] = 0xff;
        h[10] = 6; h[11] = 0;          // XLEN
        h[12] = 'B'; h[13] = 'C'; h[14] = 2; h[15] = 0;
        uint16_t bs16 = (uint16_t)(bsize - 1);
        memcpy(h + 16, &bs16, 2);
        memcpy(h + 18, cbuf, clen);
        uint32_t crc = crc32(0L, data + off, (uInt)m);
        uint32_t isz = (uint32_t)m;
        memcpy(h + 18 + clen, &crc, 4);
        memcpy(h + 22 + clen, &isz, 4);
        w += bsize;
        off += m;
    }
    return w;
}

}  // extern "C"
