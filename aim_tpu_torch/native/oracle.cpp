// aim-tpu native host runtime.
//
// Fresh C++ implementation of the host-side tier of the framework:
//   * pair-file parsing + packing  (role of get_reads, ref: WFA/DPU-MRAM/host/host.c:91-134)
//   * exact-semantics scalar aligners used as the test ORACLE for the TPU
//     kernels (role of the DPU kernels, ref: NW/SWG/WFA */dpu/*.c)
//   * batch CIGAR traceback walkers over device-produced direction bits /
//     wavefront histories (the sequential, branchy tail of each alignment
//     that is host work in this design)
//   * run-length CIGAR emission byte-identical to the reference host
//     (ref: host.c:69-89, 332-353).
//
// "Exact semantics" includes the reference's 1-D DP-buffer layout
// dp[(text_len+1)*h + v] with v ranging to pattern_len, which aliases
// tape slots whenever pattern_len > text_len (ref: NW/DPU-WRAM/dpu/nw.c:139-145,
// SWG/DPU-WRAM/dpu/swg.c:151-162).  The oracle reproduces it by simulating
// the flat tape in program order, so its scores/CIGARs match the reference
// hardware output on every input, including those edge cases.
//
// NOTE: independent implementation — algorithms re-derived from the
// reference's observable behavior; no code copied.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <string>
#include <algorithm>

// ---------------------------------------------------------------------------
// Common helpers
// ---------------------------------------------------------------------------

static inline long idx2(long i, long j, long stride) { return i * stride + j; }

// ---------------------------------------------------------------------------
// Pair-file parser
//
// Format: two lines per pair, '>' + pattern, '<' + text
// (ref: host.c get_reads; Datasets/sample-l100-e1-40K).
// Packs sequences into [max_pairs, read_size] uint8 row-major buffers
// (zero-filled tails) and length arrays.  Returns the number of pairs
// parsed, or -(1+line_index) if a sequence exceeds read_size.
// ---------------------------------------------------------------------------

extern "C" long aim_parse_pairs(const char *path, long max_pairs, int read_size,
                     uint8_t *patterns, uint8_t *texts,
                     int32_t *pattern_lens, int32_t *text_lens) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return -1000000000L;
  // Slurp the file; datasets are tens of MB, host RAM is plentiful.
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf((size_t)fsize);
  if (fsize > 0 && std::fread(buf.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    std::fclose(f);
    return -1000000001L;
  }
  std::fclose(f);

  long pos = 0, n = 0, line_no = 0;
  while (n < max_pairs && pos < fsize) {
    // Pattern line (memchr: the byte-at-a-time scan measured 2x slower,
    // PERFNOTES.md §5).
    long start1 = pos;
    const char *nl1 = (const char *)memchr(buf.data() + pos, '\n',
                                           (size_t)(fsize - pos));
    pos = nl1 ? (long)(nl1 - buf.data()) : fsize;
    long len1 = pos - start1 + (pos < fsize ? 1 : 0);  // getline-style length
    if (pos < fsize) ++pos;
    if (len1 <= 0) break;
    ++line_no;
    // Text line.
    if (pos >= fsize) break;
    long start2 = pos;
    const char *nl2 = (const char *)memchr(buf.data() + pos, '\n',
                                           (size_t)(fsize - pos));
    pos = nl2 ? (long)(nl2 - buf.data()) : fsize;
    long len2 = pos - start2 + (pos < fsize ? 1 : 0);
    if (pos < fsize) ++pos;
    ++line_no;
    // Strip sentinel char + newline: length - 2 (ref: host.c:112-117).
    long plen = len1 - 2;
    long tlen = len2 - 2;
    if (plen > read_size || tlen > read_size) return -(line_no);
    if (plen < 0) plen = 0;
    if (tlen < 0) tlen = 0;
    // tail-only memset: the head is overwritten by the memcpy (halves
    // the store traffic; parse is the host-pipeline floor, PERFNOTES §5)
    std::memset(patterns + n * read_size + plen, 0, (size_t)(read_size - plen));
    std::memset(texts + n * read_size + tlen, 0, (size_t)(read_size - tlen));
    std::memcpy(patterns + n * read_size, buf.data() + start1 + 1, (size_t)plen);
    std::memcpy(texts + n * read_size, buf.data() + start2 + 1, (size_t)tlen);
    pattern_lens[n] = (int32_t)plen;
    text_lens[n] = (int32_t)tlen;
    ++n;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Streaming per-range parser + pair counter (multi-host sharding).
//
// The reference host streams each DPU's contiguous block sequentially
// (ref: host.c:91-134, 191-209); the multi-host analogue lets each process
// touch O(its block): the seek phase memchr-counts newlines without
// copying, and only the [start_pair, start_pair + max_pairs) window is
// parsed into the caller's buffers.  Semantics (getline-style lengths,
// sentinel strip, fatal READ_SIZE reject with GLOBAL line number, pair
// dropped when the text line is missing) are identical to
// aim_parse_pairs above.
// ---------------------------------------------------------------------------

namespace {

struct LineReader {
  FILE *f;
  std::vector<char> chunk;
  size_t pos = 0, avail = 0;
  std::string line;  // reused across next() calls
  explicit LineReader(FILE *f_) : f(f_), chunk(1 << 20) {}
  bool refill() {
    avail = std::fread(chunk.data(), 1, chunk.size(), f);
    pos = 0;
    return avail > 0;
  }
  // Reads one line into `line` (no '\n'). Returns false at EOF with no
  // content; *had_nl says whether a '\n' terminated the line.
  bool next(bool *had_nl) {
    line.clear();
    *had_nl = false;
    for (;;) {
      if (pos >= avail && !refill()) return !line.empty();
      char *base = chunk.data() + pos;
      char *nl = (char *)memchr(base, '\n', avail - pos);
      if (nl) {
        line.append(base, (size_t)(nl - base));
        pos = (size_t)(nl - chunk.data()) + 1;
        *had_nl = true;
        return true;
      }
      line.append(base, avail - pos);
      pos = avail;
    }
  }
  // Skips one line without copying. Same return semantics as next();
  // *len_out gets the content length (no '\n').
  bool skip(bool *had_nl, long *len_out) {
    *had_nl = false;
    long len = 0;
    for (;;) {
      if (pos >= avail && !refill()) { *len_out = len; return len > 0; }
      char *base = chunk.data() + pos;
      char *nl = (char *)memchr(base, '\n', avail - pos);
      if (nl) {
        len += (long)(nl - base);
        pos = (size_t)(nl - chunk.data()) + 1;
        *had_nl = true;
        *len_out = len;
        return true;
      }
      len += (long)(avail - pos);
      pos = avail;
    }
  }
};

}  // namespace

// Counts complete pairs (same termination rules as the parser), up to
// max_pairs; newline scan only, no copies.
extern "C" long aim_count_pairs(const char *path, long max_pairs) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return -1000000000L;
  LineReader r(f);
  long n = 0;
  while (n < max_pairs) {
    bool nl;
    long len;
    if (!r.skip(&nl, &len)) break;          // EOF, nothing read
    if (len + (nl ? 1 : 0) <= 0) break;     // getline-style empty
    if (!r.skip(&nl, &len)) break;          // pattern without text: drop
    ++n;
  }
  std::fclose(f);
  return n;
}

// Shared parse loop over an already-positioned reader; line_no is the
// global 0-based line count at the reader's position (fatal READ_SIZE
// line numbers stay global).  Semantics identical to aim_parse_pairs.
static long parse_window(LineReader &r, long line_no, long max_pairs,
                         int read_size, uint8_t *patterns, uint8_t *texts,
                         int32_t *pattern_lens, int32_t *text_lens) {
  std::string line1;
  long n = 0;
  while (n < max_pairs) {
    bool nl1;
    if (!r.next(&nl1)) break;
    long len1 = (long)r.line.size() + (nl1 ? 1 : 0);
    if (len1 <= 0) break;
    ++line_no;
    line1.swap(r.line);
    bool nl2;
    if (!r.next(&nl2)) break;  // pattern without text: pair dropped
    ++line_no;
    long len2 = (long)r.line.size() + (nl2 ? 1 : 0);
    // Checks deferred until both lines are read so the fatal line number
    // matches aim_parse_pairs (it reports after consuming the pair).
    long plen = len1 - 2;
    long tlen = len2 - 2;
    if (plen > read_size || tlen > read_size) return -(line_no);
    if (plen < 0) plen = 0;
    if (tlen < 0) tlen = 0;
    std::memset(patterns + n * read_size + plen, 0, (size_t)(read_size - plen));
    std::memset(texts + n * read_size + tlen, 0, (size_t)(read_size - tlen));
    std::memcpy(patterns + n * read_size, line1.data() + 1, (size_t)plen);
    std::memcpy(texts + n * read_size, r.line.data() + 1, (size_t)tlen);
    pattern_lens[n] = (int32_t)plen;
    text_lens[n] = (int32_t)tlen;
    ++n;
  }
  return n;
}

extern "C" long aim_parse_pairs_range(const char *path, long start_pair,
                                      long max_pairs, int read_size,
                                      uint8_t *patterns, uint8_t *texts,
                                      int32_t *pattern_lens,
                                      int32_t *text_lens) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return -1000000000L;
  LineReader r(f);
  long line_no = 0;
  for (long i = 0; i < 2 * start_pair; ++i) {
    bool nl;
    long len;
    if (!r.skip(&nl, &len)) { std::fclose(f); return 0; }
    ++line_no;
  }
  long n = parse_window(r, line_no, max_pairs, read_size, patterns, texts,
                        pattern_lens, text_lens);
  std::fclose(f);
  return n;
}

// Byte offsets (and global 0-based line numbers) of pairs k*step,
// k = 0..n_offsets-1, via one streaming newline scan — the boundary
// pass for intra-process parallel parsing: each worker thread then
// parses its window directly with aim_parse_pairs_at (no per-thread
// re-scan of the file head).  Scans at most max_pairs pairs; returns
// the number of complete pairs seen (the aim_count_pairs rules).
extern "C" long aim_pair_offsets(const char *path, long step, long max_pairs,
                                 long n_offsets, int64_t *offsets_out,
                                 int64_t *lines_out) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return -1000000000L;
  LineReader r(f);
  long n = 0;
  int64_t byte_off = 0;
  long line_no = 0;
  while (n < max_pairs) {
    if (step > 0 && n % step == 0 && n / step < n_offsets) {
      offsets_out[n / step] = byte_off;
      lines_out[n / step] = line_no;
    }
    bool nl;
    long len;
    if (!r.skip(&nl, &len)) break;          // EOF, nothing read
    if (len + (nl ? 1 : 0) <= 0) break;     // getline-style empty
    byte_off += len + (nl ? 1 : 0);
    ++line_no;
    if (!r.skip(&nl, &len)) break;          // pattern without text: drop
    byte_off += len + (nl ? 1 : 0);
    ++line_no;
    ++n;
  }
  std::fclose(f);
  return n;
}

// Parse up to max_pairs pairs starting at a pair-aligned byte offset
// (from aim_pair_offsets); start_line is the global line count there so
// fatal READ_SIZE line numbers match the sequential parser exactly.
extern "C" long aim_parse_pairs_at(const char *path, int64_t byte_offset,
                                   long start_line, long max_pairs,
                                   int read_size, uint8_t *patterns,
                                   uint8_t *texts, int32_t *pattern_lens,
                                   int32_t *text_lens) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return -1000000000L;
  if (byte_offset > 0 && std::fseek(f, (long)byte_offset, SEEK_SET) != 0) {
    std::fclose(f);
    return 0;
  }
  LineReader r(f);
  long n = parse_window(r, start_line, max_pairs, read_size, patterns,
                        texts, pattern_lens, text_lens);
  std::fclose(f);
  return n;
}

// ---------------------------------------------------------------------------
// NW (edit distance, linear gap) oracle — exact flat-tape semantics.
//
// cell type int16 (NW_W16, ref: NW/*/common/common.h:87).
// Direction-bit codes shared with the TPU kernel + walker:
//   0 = 'D' (v-1), 1 = 'I' (h-1), 2 = diag 'M', 3 = diag 'X'.
// Tie-break priority D -> I -> diag, X iff cell == diag + MISMATCH
// (ref: NW/DPU-WRAM/dpu/nw.c:76-94).
// ---------------------------------------------------------------------------

typedef int16_t nw_cell_t;

static void nw_pair(const uint8_t *pat, const uint8_t *txt, int plen, int tlen,
                    int mismatch, int gap_i, int gap_d, int backtrace,
                    std::vector<nw_cell_t> &tape, int32_t *score_out,
                    char *ops, int32_t *begin_out, int32_t *end_out,
                    int max_ops) {
  const long nc = tlen + 1;  // tape row stride (ref nw.c num_cols)
  // Tape covers indices up to nc*tlen + plen.
  // (tape is sized by the caller to (R+1)*(R+1)+R and reused.)
  tape[0] = 0;
  {
    int cell = 0;
    for (int v = 1; v <= plen; ++v) { cell += gap_d; tape[v] = (nw_cell_t)cell; }
    cell = 0;
    for (int h = 1; h <= tlen; ++h) { cell += gap_i; tape[idx2(h, 0, nc)] = (nw_cell_t)cell; }
  }
  nw_cell_t score = 0;
  for (int h = 1; h <= tlen; ++h) {
    const uint8_t tc = txt[h - 1];
    for (int v = 1; v <= plen; ++v) {
      nw_cell_t del = (nw_cell_t)(tape[idx2(h, v - 1, nc)] + gap_d);
      nw_cell_t ins = (nw_cell_t)(tape[idx2(h - 1, v, nc)] + gap_i);
      nw_cell_t dia = (nw_cell_t)(tape[idx2(h - 1, v - 1, nc)] +
                                  (pat[v - 1] == tc ? 0 : mismatch));
      nw_cell_t best = std::min(dia, std::min(ins, del));
      tape[idx2(h, v, nc)] = best;
      score = best;
    }
  }
  *score_out = (int32_t)score;
  int max_operations = plen + tlen;
  int begin = max_operations - 1, end = max_operations;
  if (backtrace) {
    // Value-based walk over the FINAL tape (ref: nw.c:67-107).
    int op = end - 1;
    int h = tlen, v = plen;
    while (h > 0 && v > 0) {
      nw_cell_t cur = tape[idx2(h, v, nc)];
      if (cur == (nw_cell_t)(tape[idx2(h, v - 1, nc)] + gap_d)) {
        ops[op--] = 'D'; --v;
      } else if (cur == (nw_cell_t)(tape[idx2(h - 1, v, nc)] + gap_i)) {
        ops[op--] = 'I'; --h;
      } else {
        ops[op--] = (cur == (nw_cell_t)(tape[idx2(h - 1, v - 1, nc)] + mismatch))
                        ? 'X' : 'M';
        --h; --v;
      }
    }
    while (h > 0) { ops[op--] = 'I'; --h; }
    while (v > 0) { ops[op--] = 'D'; --v; }
    begin = op + 1;
  }
  *begin_out = begin;
  *end_out = end;
  (void)max_ops;
}

extern "C" void aim_nw_align(const uint8_t *patterns, const uint8_t *texts,
                  const int32_t *plens, const int32_t *tlens, long n,
                  int read_size, int mismatch, int gap_i, int gap_d,
                  int backtrace, int32_t *scores, char *ops,
                  int32_t *begin_off, int32_t *end_off) {
  const int max_ops = 2 * read_size;
  std::vector<nw_cell_t> tape((size_t)(read_size + 1) * (read_size + 1) + read_size + 2);
  for (long i = 0; i < n; ++i) {
    char *o = ops + i * max_ops;
    if (backtrace) std::memset(o, 'M', (size_t)max_ops);  // ref: nw.c:192
    nw_pair(patterns + i * read_size, texts + i * read_size, plens[i], tlens[i],
            mismatch, gap_i, gap_d, backtrace, tape, &scores[i], o,
            &begin_off[i], &end_off[i], max_ops);
  }
}

// Batch walker over device-produced NW direction bits.
// bits layout: [n, h_stride rows, w_stride bytes] uint8 with 4 two-bit
// cell codes per byte (cell v at byte v>>2, shift (v&3)*2).
extern "C" void aim_nw_traceback_bits(const uint8_t *bits, long h_stride, long w_stride,
                           const int32_t *plens, const int32_t *tlens, long n,
                           int max_ops, char *ops, int32_t *begin_off,
                           int32_t *end_off) {
  for (long i = 0; i < n; ++i) {
    const uint8_t *b = bits + i * h_stride * w_stride;
    char *o = ops + i * max_ops;
    std::memset(o, 'M', (size_t)max_ops);
    int plen = plens[i], tlen = tlens[i];
    int max_operations = plen + tlen;
    int op = max_operations - 1;
    int h = tlen, v = plen;
    while (h > 0 && v > 0) {
      uint8_t code = (b[h * w_stride + (v >> 2)] >> ((v & 3) * 2));
      switch (code & 3) {
        case 0: o[op--] = 'D'; --v; break;
        case 1: o[op--] = 'I'; --h; break;
        case 2: o[op--] = 'M'; --h; --v; break;
        default: o[op--] = 'X'; --h; --v; break;
      }
    }
    while (h > 0) { o[op--] = 'I'; --h; }
    while (v > 0) { o[op--] = 'D'; --v; }
    begin_off[i] = op + 1;
    end_off[i] = max_operations;
  }
}

// ---------------------------------------------------------------------------
// SWG (Gotoh affine-gap, global, minimizing) oracle — exact flat-tape
// semantics with selectable cell width (int8 iff MAX_SCORE < 127 in the
// short-read tier, ref: SWG/DPU-WRAM/common/common.h:71-75).
//
// Direction-bit codes shared with the TPU kernel + walker (per cell):
//   bits 0..1: M-layer choice: 0 = enter D, 1 = enter I, 2 = diag 'M',
//              3 = diag 'X'   (priority D -> I -> match -> mismatch,
//              ref: SWG/DPU-WRAM/dpu/swg.c:79-98)
//   bit 2: D was opened here (D == M(h,v-1) + GAP_O + GAP_E)
//   bit 3: I was opened here (I == M(h-1,v) + GAP_O + GAP_E)
// ---------------------------------------------------------------------------

template <typename C>
static void swg_pair(const uint8_t *pat, const uint8_t *txt, int plen, int tlen,
                     int match, int mismatch, int gap_o, int gap_e,
                     int max_score, int backtrace, std::vector<C> &m_tape,
                     std::vector<C> &i_tape, std::vector<C> &d_tape,
                     int32_t *score_out, char *ops, int32_t *begin_out,
                     int32_t *end_out) {
  const long nc = tlen + 1;
  d_tape[0] = (C)max_score;  // MAX_SCORE doubles as the init sentinel
  i_tape[0] = (C)max_score;  // (ref: swg.c:128-130)
  m_tape[0] = 0;
  for (int v = 1; v <= plen; ++v) {
    d_tape[v] = (C)(gap_o + v * gap_e);
    i_tape[v] = (C)max_score;
    m_tape[v] = d_tape[v];
  }
  for (int h = 1; h <= tlen; ++h) {
    long t = idx2(h, 0, nc);
    d_tape[t] = (C)max_score;
    i_tape[t] = (C)(gap_o + h * gap_e);
    m_tape[t] = i_tape[t];
  }
  int score = 0;
  for (int h = 1; h <= tlen; ++h) {
    const uint8_t tc = txt[h - 1];
    for (int v = 1; v <= plen; ++v) {
      long t = idx2(h, v, nc), tu = t - 1, tl = t - nc, td = t - nc - 1;
      C del_new = (C)(m_tape[tu] + gap_o + gap_e);
      C d_from_extend = (C)(d_tape[tu] + gap_e);
      C del = std::min(del_new, d_from_extend);
      d_tape[t] = del;
      C ins_new = (C)(m_tape[tl] + gap_o + gap_e);
      C i_from_extend = (C)(i_tape[tl] + gap_e);
      C ins = std::min(ins_new, i_from_extend);
      i_tape[t] = ins;
      C m_diag = (C)(m_tape[td] + (pat[v - 1] == tc ? match : mismatch));
      C best = std::min(m_diag, std::min(ins, del));
      m_tape[t] = best;
      score = (int)best;  // sign-extended like the reference's int score
    }
  }
  *score_out = score;
  int max_operations = plen + tlen;
  int begin = max_operations - 1, end = max_operations;
  if (backtrace) {
    // 3-layer automaton over the FINAL tapes (ref: swg.c:45-119).
    int op = end - 1;
    int h = tlen, v = plen;
    int layer = 0;  // 0=M 1=I 2=D
    while (h > 0 && v > 0) {
      long t = idx2(h, v, nc);
      if (layer == 2) {
        ops[op--] = 'D';
        if (d_tape[t] == (C)(m_tape[t - 1] + gap_o + gap_e)) layer = 0;
        --v;
      } else if (layer == 1) {
        ops[op--] = 'I';
        if (i_tape[t] == (C)(m_tape[t - nc] + gap_o + gap_e)) layer = 0;
        --h;
      } else {
        if (m_tape[t] == d_tape[t]) {
          layer = 2;
        } else if (m_tape[t] == i_tape[t]) {
          layer = 1;
        } else if (m_tape[t] == (C)(m_tape[t - nc - 1] + match)) {
          ops[op--] = 'M'; --h; --v;
        } else if (m_tape[t] == (C)(m_tape[t - nc - 1] + mismatch)) {
          ops[op--] = 'X'; --h; --v;
        } else {
          // ref: swg.c:99-104 aborts; mark and bail.
          ops[op--] = '?';
          break;
        }
      }
    }
    while (h > 0) { ops[op--] = 'I'; --h; }
    while (v > 0) { ops[op--] = 'D'; --v; }
    begin = op + 1;
  }
  *begin_out = begin;
  *end_out = end;
}

extern "C" void aim_swg_align(const uint8_t *patterns, const uint8_t *texts,
                   const int32_t *plens, const int32_t *tlens, long n,
                   int read_size, int match, int mismatch, int gap_o,
                   int gap_e, int max_score, int cell_width, int backtrace,
                   int32_t *scores, char *ops, int32_t *begin_off,
                   int32_t *end_off) {
  const int max_ops = 2 * read_size;
  size_t tsz = (size_t)(read_size + 1) * (read_size + 1) + read_size + 2;
  if (cell_width == 1) {
    std::vector<int8_t> m(tsz), ii(tsz), d(tsz);
    for (long i = 0; i < n; ++i) {
      char *o = ops + i * max_ops;
      if (backtrace) std::memset(o, 'M', (size_t)max_ops);
      swg_pair<int8_t>(patterns + i * read_size, texts + i * read_size,
                       plens[i], tlens[i], match, mismatch, gap_o, gap_e,
                       max_score, backtrace, m, ii, d, &scores[i], o,
                       &begin_off[i], &end_off[i]);
    }
  } else {
    std::vector<int16_t> m(tsz), ii(tsz), d(tsz);
    for (long i = 0; i < n; ++i) {
      char *o = ops + i * max_ops;
      if (backtrace) std::memset(o, 'M', (size_t)max_ops);
      swg_pair<int16_t>(patterns + i * read_size, texts + i * read_size,
                        plens[i], tlens[i], match, mismatch, gap_o, gap_e,
                        max_score, backtrace, m, ii, d, &scores[i], o,
                        &begin_off[i], &end_off[i]);
    }
  }
}

// Batch walker over device-produced SWG direction bits (format above).
extern "C" void aim_swg_traceback_bits(const uint8_t *bits, long h_stride, long w_stride,
                            const int32_t *plens, const int32_t *tlens, long n,
                            int max_ops, char *ops, int32_t *begin_off,
                            int32_t *end_off) {
  for (long i = 0; i < n; ++i) {
    const uint8_t *b = bits + i * h_stride * w_stride;
    char *o = ops + i * max_ops;
    std::memset(o, 'M', (size_t)max_ops);
    int plen = plens[i], tlen = tlens[i];
    int max_operations = plen + tlen;
    int op = max_operations - 1;
    int h = tlen, v = plen;
    int layer = 0;
    while (h > 0 && v > 0) {
      uint8_t code = (b[h * w_stride + (v >> 1)] >> ((v & 1) * 4)) & 0xF;
      if (layer == 2) {
        o[op--] = 'D';
        if (code & 4) layer = 0;
        --v;
      } else if (layer == 1) {
        o[op--] = 'I';
        if (code & 8) layer = 0;
        --h;
      } else {
        switch (code & 3) {
          case 0: layer = 2; break;
          case 1: layer = 1; break;
          case 2: o[op--] = 'M'; --h; --v; break;
          default: o[op--] = 'X'; --h; --v; break;
        }
      }
    }
    while (h > 0) { o[op--] = 'I'; --h; }
    while (v > 0) { o[op--] = 'D'; --v; }
    begin_off[i] = op + 1;
    end_off[i] = max_operations;
  }
}

// ---------------------------------------------------------------------------
// WFA (gap-affine wavefront) oracle + dense-history backtrace walker.
//
// Dense history layout (shared with the TPU kernels):
//   hist_{m,i,d}: [S+1, K] int16, K = 2*max_score+1, lane index = k+max_score
//   klo/khi:      [S+1] int32   (post-reduce extents)
//   flags:        [S+1] uint8   bit0 exists, bit1 m_null, bit2 i_null,
//                               bit3 d_null
// "exists" is the analogue of mramIdx[s] != 0 (ref: wfa.c:300-302): a score
// whose wavefront was never allocated reads as NULL everywhere.  A
// reduce-nulled wavefront is stored with m_null set but its extended m
// offsets intact, and the backtrace's m-reads deliberately ignore m_null —
// both reproducing the reference (ref: wfa_backtracing.c:73-166 checks klo/khi
// and d_null/iwavefront only, never m_null).
// ---------------------------------------------------------------------------

typedef int16_t wfa_off_t;
static const wfa_off_t WFA_NULL = (wfa_off_t)(INT16_MIN / 2);

struct WfaDense {
  int smax;   // MAX_SCORE
  int K;      // 2*smax+1
  wfa_off_t *m, *i, *d;  // [S+1, K]
  int32_t *klo, *khi;    // [S+1]
  uint8_t *flags;        // [S+1]
};

static inline int f_exists(uint8_t f) { return f & 1; }
static inline int f_mnull(uint8_t f) { return (f >> 1) & 1; }
static inline int f_inull(uint8_t f) { return (f >> 2) & 1; }
static inline int f_dnull(uint8_t f) { return (f >> 3) & 1; }

// Forward pass for one pair, recording the dense history.  Returns the
// final score: the end-reached score, or max_score+1 on overflow
// (ref: wfa.c:399-404).
static int wfa_forward_dense(const uint8_t *pat, const uint8_t *txt, int plen,
                             int tlen, int mismatch, int gap_o, int gap_e,
                             int smax, int reduce, WfaDense &H) {
  const int K = H.K;
  const long KS = (long)K;
  // score 0: lo = hi = 0, kernel 0 (i/d null), m[0] = 0 (ref: wfa.c:364-366).
  for (int s = 0; s <= smax; ++s) H.flags[s] = 0;
  {
    wfa_off_t *m0 = H.m + 0 * KS;
    std::fill(m0, m0 + K, WFA_NULL);
    m0[smax] = 0;
    H.klo[0] = 0; H.khi[0] = 0;
    H.flags[0] = 1 /*exists*/ | (1 << 2) /*i_null*/ | (1 << 3) /*d_null*/;
  }
  const int ak = tlen - plen;  // alignment diagonal
  int score = 0;
  bool cur_exists = true;
  while (true) {
    wfa_off_t *m = H.m + (long)score * KS;
    int klo = H.klo[score], khi = H.khi[score];
    bool m_null = !cur_exists || f_mnull(H.flags[score]);
    // ---- extend (ref: wfa.c:193-215) ----
    if (!m_null) {
      for (int k = klo; k <= khi; ++k) {
        int off = m[k + H.smax];
        if (off < 0) continue;
        int v = off - k, h = off;
        while (v < plen && h < tlen && v >= 0 && h >= 0 &&
               pat[v] == txt[h]) { ++v; ++h; ++off; }
        m[k + H.smax] = (wfa_off_t)(h);
      }
    }
    // ---- reduce (WFA-adaptive, ref: wfa.c:70-141) ----
    if (reduce && !m_null && (khi - klo + 1) >= 10) {
      int min_dist = std::max(plen, tlen);
      for (int k = klo; k <= khi; ++k) {
        int off = m[k + H.smax];
        int dist = std::max(plen - (off - k), tlen - off);
        min_dist = std::min(dist, min_dist);
      }
      int klo_orig = klo, khi_orig = khi;
      int top_limit = std::min(ak - 1, khi);
      for (int k = klo; k < top_limit; ++k) {
        int off = m[k + H.smax];
        int dist = std::max(plen - (off - k), tlen - off);
        if (dist - min_dist <= 50) break;
        ++klo;
      }
      int bottom_limit = std::max(ak + 1, klo);
      for (int k = khi_orig; k > bottom_limit; --k) {
        int off = m[k + H.smax];
        int dist = std::max(plen - (off - k), tlen - off);
        if (dist - min_dist <= 50) break;
        --khi;
      }
      if (klo > khi) {
        // Null the wavefront but RESTORE the extents (ref: wfa.c:132-140).
        H.flags[score] |= (1 << 1) | (1 << 2) | (1 << 3);
        klo = klo_orig; khi = khi_orig;
      }
      H.klo[score] = klo; H.khi[score] = khi;
      m_null = !cur_exists || f_mnull(H.flags[score]);
    }
    // ---- end reached? (ref: wfa.c:217-237) ----
    if (!m_null && klo <= ak && ak <= khi && m[ak + H.smax] >= tlen)
      return score;
    // ---- next score ----
    ++score;
    if (score > smax) return score;  // overflow: MAX_SCORE+1
    // compute_next (ref: wfa.c:275-354)
    int s_sub = score - mismatch;
    int s_o = score - gap_o - gap_e;
    int s_e = score - gap_e;
    uint8_t f_sub = (s_sub >= 0) ? H.flags[s_sub] : 0;
    uint8_t f_o = (s_o >= 0) ? H.flags[s_o] : 0;
    uint8_t f_e = (s_e >= 0) ? H.flags[s_e] : 0;
    bool m_sub_null = !(f_exists(f_sub)) || f_mnull(f_sub);
    bool m_o_null = !(f_exists(f_o)) || f_mnull(f_o);
    bool i_e_null = !(f_exists(f_e)) || f_inull(f_e);
    bool d_e_null = !(f_exists(f_e)) || f_dnull(f_e);
    bool i_out_null = m_o_null && i_e_null;
    bool d_out_null = m_o_null && d_e_null;
    if (m_sub_null && i_out_null && d_out_null) {
      H.flags[score] = 0;  // exists = 0 (mramIdx[score] = 0)
      cur_exists = false;
      H.klo[score] = 1; H.khi[score] = -1;
      continue;
    }
    int sub_lo = m_sub_null ? 1 : H.klo[s_sub];
    int sub_hi = m_sub_null ? -1 : H.khi[s_sub];
    int o_lo = m_o_null ? 1 : H.klo[s_o];
    int o_hi = m_o_null ? -1 : H.khi[s_o];
    int e_lo = (i_e_null && d_e_null) ? 1 : H.klo[s_e];
    int e_hi = (i_e_null && d_e_null) ? -1 : H.khi[s_e];
    int lo = std::min(std::min(sub_lo, o_lo), e_lo) - 1;
    int hi = std::max(std::max(sub_hi, o_hi), e_hi) + 1;
    // clamp to representable range (cannot exceed |score| in exact WFA)
    if (lo < -H.smax) lo = -H.smax;
    if (hi > H.smax) hi = H.smax;
    H.klo[score] = lo; H.khi[score] = hi;
    H.flags[score] = 1 | ((i_out_null ? 1 : 0) << 2) | ((d_out_null ? 1 : 0) << 3);
    cur_exists = true;
    wfa_off_t *mn = H.m + (long)score * KS;
    wfa_off_t *in = H.i + (long)score * KS;
    wfa_off_t *dn = H.d + (long)score * KS;
    std::fill(mn, mn + K, WFA_NULL);
    if (!i_out_null) std::fill(in, in + K, WFA_NULL);
    if (!d_out_null) std::fill(dn, dn + K, WFA_NULL);
    const wfa_off_t *m_sub = m_sub_null ? nullptr : H.m + (long)s_sub * KS;
    const wfa_off_t *m_o = m_o_null ? nullptr : H.m + (long)s_o * KS;
    const wfa_off_t *i_e = i_e_null ? nullptr : H.i + (long)s_e * KS;
    const wfa_off_t *d_e = d_e_null ? nullptr : H.d + (long)s_e * KS;
    for (int k = lo; k <= hi; ++k) {
      // The -10 sentinels reproduce the reference's uninitialized-looking
      // defaults, which are live values: a skipped branch contributes -10
      // to the M max (ref: wfa.c:243,255,266).
      wfa_off_t ins = -10;
      if (!m_o_null || !i_e_null) {
        wfa_off_t ins_g = (!m_o_null && o_lo <= k - 1 && k - 1 <= o_hi)
                              ? m_o[k - 1 + H.smax] : WFA_NULL;
        wfa_off_t ins_i = (!i_e_null && e_lo <= k - 1 && k - 1 <= e_hi)
                              ? i_e[k - 1 + H.smax] : WFA_NULL;
        if (ins_g == WFA_NULL && ins_i == WFA_NULL) ins = WFA_NULL;
        else ins = (wfa_off_t)(std::max(ins_g, ins_i) + 1);
        in[k + H.smax] = ins;
      }
      wfa_off_t del = -10;
      if (!m_o_null || !d_e_null) {
        wfa_off_t del_g = (!m_o_null && o_lo <= k + 1 && k + 1 <= o_hi)
                              ? m_o[k + 1 + H.smax] : WFA_NULL;
        wfa_off_t del_d = (!d_e_null && e_lo <= k + 1 && k + 1 <= e_hi)
                              ? d_e[k + 1 + H.smax] : WFA_NULL;
        del = std::max(del_g, del_d);  // no both-null special case (ref :262)
        dn[k + H.smax] = del;
      }
      wfa_off_t sub = -10;
      if (!m_sub_null) {
        sub = (sub_lo <= k && k <= sub_hi)
                  ? (wfa_off_t)(m_sub[k + H.smax] + 1) : WFA_NULL;
      }
      mn[k + H.smax] = std::max(del, std::max(sub, ins));
    }
  }
}

// Backtrace over a dense history for one pair
// (ref: WFA/DPU-MRAM/dpu/wfa_backtracing.c:219-375).
static void wfa_backtrace_dense(const WfaDense &H, const uint8_t *pat,
                                const uint8_t *txt, int plen, int tlen,
                                int mismatch, int gap_o, int gap_e,
                                int alignment_score, char *ops,
                                int32_t *begin_out, int max_operations) {
  const long KS = (long)H.K;
  const int ak = tlen - plen;
  int score = alignment_score;
  int k = ak;
  int op = *begin_out;  // caller passes max_operations-1
  // Guarded start read (the normal path's start is always in band; the
  // overflow-compat start may not be — out-of-band reads NULL).
  wfa_off_t offset =
      (f_exists(H.flags[score]) && H.klo[score] <= k && k <= H.khi[score])
          ? H.m[(long)score * KS + k + H.smax]
          : WFA_NULL;
  int v = offset - k, h = offset;
  bool valid = (v > 0 && v <= plen && h > 0 && h <= tlen);
  int btype = 0;  // 0=M 1=I 2=D

  auto m_read = [&](int s, int kk) -> wfa_off_t {
    // deletion_open / insertion_open / mismatch m-reads: bounds by klo/khi,
    // existence by mramIdx != 0; m_null deliberately NOT checked.
    if (s < 0 || !f_exists(H.flags[s])) return WFA_NULL;
    if (H.klo[s] <= kk && kk <= H.khi[s]) return H.m[(long)s * KS + kk + H.smax];
    return WFA_NULL;
  };
  auto d_read = [&](int s, int kk) -> wfa_off_t {
    if (s < 0 || !f_exists(H.flags[s]) || f_dnull(H.flags[s])) return WFA_NULL;
    if (H.klo[s] <= kk && kk <= H.khi[s]) return H.d[(long)s * KS + kk + H.smax];
    return WFA_NULL;
  };
  auto i_read = [&](int s, int kk) -> wfa_off_t {
    if (s < 0 || !f_exists(H.flags[s]) || f_inull(H.flags[s])) return WFA_NULL;
    if (H.klo[s] <= kk && kk <= H.khi[s]) return H.i[(long)s * KS + kk + H.smax];
    return WFA_NULL;
  };

  while (v > 0 && h > 0 && score > 0) {
    if (!valid) {
      valid = (v > 0 && v <= plen && h > 0 && h <= tlen);
      if (valid) {
        // add trailing gap (ref: wfa_backtracing.c:48-69)
        if (k < ak) { for (int i2 = k; i2 < ak; ++i2) ops[op--] = 'I'; }
        else if (k > ak) { for (int i2 = ak; i2 < k; ++i2) ops[op--] = 'D'; }
      }
    }
    int s_o = score - gap_o - gap_e;
    int s_e = score - gap_e;
    int s_x = score - mismatch;
    // The +1 trace reads add 1 to the RAW stored value even when it is
    // OFFSET_NULL (the reference returns iwavefront[k-1] + 1 etc. with no
    // null check on the value, ref: wfa_backtracing.c:110-166); only an
    // out-of-bounds / missing-component read yields NULL itself.
    auto in_m = [&](int s, int kk) {
      return s >= 0 && f_exists(H.flags[s]) && H.klo[s] <= kk && kk <= H.khi[s];
    };
    auto in_i = [&](int s, int kk) {
      return s >= 0 && f_exists(H.flags[s]) && !f_inull(H.flags[s]) &&
             H.klo[s] <= kk && kk <= H.khi[s];
    };
    wfa_off_t d_from_extend = (btype == 1) ? WFA_NULL : d_read(s_e, k + 1);
    wfa_off_t d_from_open = (btype == 1) ? WFA_NULL : m_read(s_o, k + 1);
    wfa_off_t i_from_extend =
        (btype == 2 || !in_i(s_e, k - 1))
            ? WFA_NULL
            : (wfa_off_t)(H.i[(long)s_e * KS + (k - 1) + H.smax] + 1);
    wfa_off_t i_from_open =
        (btype == 2 || !in_m(s_o, k - 1))
            ? WFA_NULL
            : (wfa_off_t)(H.m[(long)s_o * KS + (k - 1) + H.smax] + 1);
    wfa_off_t sub_from_m =
        (btype != 0 || !in_m(s_x, k))
            ? WFA_NULL
            : (wfa_off_t)(H.m[(long)s_x * KS + k + H.smax] + 1);
    (void)i_read;
    wfa_off_t best_d_src = std::max(d_from_extend, d_from_open);
    wfa_off_t best_i_src = std::max(i_from_extend, i_from_open);
    wfa_off_t best_src = std::max(sub_from_m, std::max(best_i_src, best_d_src));
    if (btype == 0) {
      int num_matches = offset - best_src;
      for (int i2 = 0; i2 < num_matches; ++i2) ops[op--] = 'M';
      offset = best_src;
      v = offset - k; h = offset;
      if (v <= 0 || h <= 0) break;
    }
    if (best_src == d_from_extend) {
      if (valid) ops[op--] = 'D';
      score = s_e; ++k; btype = 2;
    } else if (best_src == d_from_open) {
      if (valid) ops[op--] = 'D';
      score = s_o; ++k; btype = 0;
    } else if (best_src == i_from_extend) {
      if (valid) ops[op--] = 'I';
      score = s_e; --k; --offset; btype = 1;
    } else if (best_src == i_from_open) {
      if (valid) ops[op--] = 'I';
      score = s_o; --k; --offset; btype = 0;
    } else if (best_src == sub_from_m) {
      if (valid) ops[op--] = 'X';
      score = s_x; --offset;
    } else {
      ops[op--] = '?';  // ref aborts: "No link found during backtrace"
      break;
    }
    v = offset - k; h = offset;
  }
  if (score == 0) {
    for (int i2 = 0; i2 < (int)offset; ++i2) ops[op--] = 'M';
  } else {
    while (v > 0) { ops[op--] = 'D'; --v; }
    while (h > 0) { ops[op--] = 'I'; --h; }
  }
  *begin_out = op + 1;
  (void)max_operations;
}

// Full WFA oracle: parse -> forward (dense) -> backtrace, one pair at a time.
// overflow_backtrace: 0 = skip backtrace on score > MAX_SCORE (the HBM/MRAM
// tier, ref: WFA/DPU-MRAM/dpu/wfa.c:399-404).  1 = the WRAM-variant compat
// rendition: the reference's WRAM tier backtraces on overflow through an
// out-of-bounds wavefront read (undefined behavior, ref:
// WFA/DPU-WRAM/dpu/wfa.c:369-376), so no bit-exact target exists — the
// DEFINED rendition here walks from the deepest live computed level.
extern "C" void aim_wfa_align(const uint8_t *patterns, const uint8_t *texts,
                   const int32_t *plens, const int32_t *tlens, long n,
                   int read_size, int mismatch, int gap_o, int gap_e,
                   int max_score, int reduce, int backtrace,
                   int overflow_backtrace, int32_t *scores,
                   char *ops, int32_t *begin_off, int32_t *end_off) {
  const int max_ops = 2 * read_size;
  const int K = 2 * max_score + 1;
  const long S1 = max_score + 1;
  std::vector<wfa_off_t> hm(S1 * K), hi(S1 * K), hd(S1 * K);
  std::vector<int32_t> klo(S1), khi(S1);
  std::vector<uint8_t> flags(S1);
  WfaDense H{max_score, K, hm.data(), hi.data(), hd.data(),
             klo.data(), khi.data(), flags.data()};
  for (long i = 0; i < n; ++i) {
    const uint8_t *pat = patterns + i * read_size;
    const uint8_t *txt = texts + i * read_size;
    int plen = plens[i], tlen = tlens[i];
    char *o = ops + i * max_ops;
    if (backtrace) std::memset(o, 'M', (size_t)max_ops);
    int sc = wfa_forward_dense(pat, txt, plen, tlen, mismatch, gap_o, gap_e,
                               max_score, reduce, H);
    scores[i] = sc;
    int max_operations = plen + tlen;
    int begin = max_operations - 1;
    if (backtrace && sc <= max_score) {
      wfa_backtrace_dense(H, pat, txt, plen, tlen, mismatch, gap_o, gap_e, sc,
                          o, &begin, max_operations);
    } else if (backtrace && overflow_backtrace) {
      int s0 = max_score;
      while (s0 > 0 && (!f_exists(H.flags[s0]) || f_mnull(H.flags[s0])))
        --s0;
      wfa_backtrace_dense(H, pat, txt, plen, tlen, mismatch, gap_o, gap_e,
                          s0, o, &begin, max_operations);
    }
    begin_off[i] = begin;
    end_off[i] = max_operations;
  }
}

// Batch walker over device-produced dense WFA histories.
//
// Strided layout so device-native layouts walk zero-copy:
//   hist element (pair i, score s, k_phys) at
//     hist_*[i*h_pair_stride + s*h_score_stride + k_phys]   (int16 elements)
//   klo/khi/flags element (i, s) at  [i*m_pair_stride + s*m_score_stride].
// The contiguous [n, S+1, K] layout is h_pair_stride=S1*K, h_score_stride=K,
// m_pair_stride=S1, m_score_stride=1.
extern "C" void aim_wfa_backtrace_batch(const int16_t *hist_m, const int16_t *hist_i,
                             const int16_t *hist_d, const int32_t *klo,
                             const int32_t *khi, const uint8_t *flags,
                             const int32_t *scores, const uint8_t *patterns,
                             const uint8_t *texts, const int32_t *plens,
                             const int32_t *tlens, long n, int read_size,
                             int mismatch, int gap_o, int gap_e, int max_score,
                             long h_pair_stride, long h_score_stride,
                             long m_pair_stride, long m_score_stride,
                             char *ops, int32_t *begin_off, int32_t *end_off) {
  const int max_ops = 2 * read_size;
  const int K = 2 * max_score + 1;
  const long S1 = max_score + 1;
  // WfaDense assumes per-pair [S1, K]-contiguous arrays; repack per pair
  // when the score stride differs (cheap: S1*K elements).
  std::vector<wfa_off_t> tm, ti, td;
  std::vector<int32_t> tklo(S1), tkhi(S1);
  std::vector<uint8_t> tfl(S1);
  const bool contiguous = (h_score_stride == K && m_score_stride == 1);
  if (!contiguous) { tm.resize(S1 * K); ti.resize(S1 * K); td.resize(S1 * K); }
  for (long i = 0; i < n; ++i) {
    WfaDense H{max_score, K, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr};
    if (contiguous) {
      H.m = const_cast<wfa_off_t *>(hist_m) + i * h_pair_stride;
      H.i = const_cast<wfa_off_t *>(hist_i) + i * h_pair_stride;
      H.d = const_cast<wfa_off_t *>(hist_d) + i * h_pair_stride;
      H.klo = const_cast<int32_t *>(klo) + i * m_pair_stride;
      H.khi = const_cast<int32_t *>(khi) + i * m_pair_stride;
      H.flags = const_cast<uint8_t *>(flags) + i * m_pair_stride;
    } else {
      for (long s = 0; s < S1; ++s) {
        const long hb = i * h_pair_stride + s * h_score_stride;
        std::memcpy(&tm[s * K], hist_m + hb, K * sizeof(wfa_off_t));
        std::memcpy(&ti[s * K], hist_i + hb, K * sizeof(wfa_off_t));
        std::memcpy(&td[s * K], hist_d + hb, K * sizeof(wfa_off_t));
        const long mb = i * m_pair_stride + s * m_score_stride;
        tklo[s] = klo[mb]; tkhi[s] = khi[mb]; tfl[s] = flags[mb];
      }
      H.m = tm.data(); H.i = ti.data(); H.d = td.data();
      H.klo = tklo.data(); H.khi = tkhi.data(); H.flags = tfl.data();
    }
    int plen = plens[i], tlen = tlens[i];
    char *o = ops + i * max_ops;
    std::memset(o, 'M', (size_t)max_ops);
    int max_operations = plen + tlen;
    int begin = max_operations - 1;
    if (scores[i] <= max_score) {
      wfa_backtrace_dense(H, patterns + i * read_size, texts + i * read_size,
                          plen, tlen, mismatch, gap_o, gap_e, scores[i], o,
                          &begin, max_operations);
    }
    begin_off[i] = begin;
    end_off[i] = max_operations;
  }
}

// ---------------------------------------------------------------------------
// Expansion of device-produced CIGAR runs into reference ops buffers.
//
// The Pallas WFA kernel backtraces on device and emits run-length records:
// runs[i] is an [nrl] int16 lane row, lane 0 = final cursor rc, runs at
// lanes rc+1..nrl-1 in alignment order, value = op<<12 | len with op
// 0='M' 1='X' 2='I' 3='D'.  Expanding them right-to-left-equivalently into
// the 'M'-prefilled ops buffer reproduces exactly what the reference DPU
// backtrace leaves in its operations memory (ref: wfa.c:499-533), so the
// downstream emitter is unchanged.  Pairs with score > max_score keep the
// prefilled single 'M' (overflow, ref: wfa.c:399-404).
// ---------------------------------------------------------------------------

extern "C" void aim_wfa_runs_to_ops(const int16_t *runs, long nrl,
                                    const int32_t *scores,
                                    const int32_t *plens,
                                    const int32_t *tlens, long n,
                                    int max_score, int max_ops, char *ops,
                                    int32_t *begin_off, int32_t *end_off) {
  static const char OPC[4] = {'M', 'X', 'I', 'D'};
  for (long i = 0; i < n; ++i) {
    char *o = ops + i * max_ops;
    std::memset(o, 'M', (size_t)max_ops);
    const int max_operations = plens[i] + tlens[i];
    int begin = max_operations - 1;
    if (scores[i] <= max_score) {
      const int16_t *r = runs + i * nrl;
      // lane 0 = cursor_lo8 | flags << 8 | cursor_hi << 10 (the hi
      // bits are zero for every NRL <= 256 record, so the historical
      // 8-bit layout decodes identically)
      long start = ((r[0] & 0xFF) | (((r[0] >> 10) & 0x1F) << 8)) + 1;
      if (start < 1) start = 1;
      if (start > nrl) start = nrl;
      long total = 0;
      for (long j = start; j < nrl; ++j) total += r[j] & 0xFFF;
      int pos = max_operations - (int)total;
      // Defensive clamps: a malformed record (e.g. a flagged pair whose
      // cursor underflowed) must never write outside this pair's row.
      if (pos < 0) pos = 0;
      if (pos > max_ops) pos = max_ops;
      begin = pos;
      for (long j = start; j < nrl; ++j) {
        int len = r[j] & 0xFFF;
        if (len > max_ops - pos) len = max_ops - pos;
        char c = OPC[(r[j] >> 12) & 3];
        std::memset(o + pos, c, (size_t)len);
        pos += len;
      }
    }
    begin_off[i] = begin;
    end_off[i] = max_operations;
  }
}

// ---------------------------------------------------------------------------
// GenASM oracle — CLEAN bounded-Levenshtein semantics (the reference ships
// GenASM only as an empty submodule; aim-tpu anchors the family to the
// true unit-cost edit distance with the NW walker's D -> I -> diagonal
// priority on a proper 2-D table — deliberately NOT the reference NW
// flat-tape aliasing, which is an artifact of nw.c's layout).  Distances
// above max_score report max_score+1 with the default "M" CIGAR (the
// framework's WFA overflow convention).  Spec: golden/genasm.py.
// ---------------------------------------------------------------------------

extern "C" void aim_genasm_align(const uint8_t *patterns, const uint8_t *texts,
                                 const int32_t *plens, const int32_t *tlens,
                                 long n, int read_size, int max_score,
                                 int backtrace, int32_t *scores, char *ops,
                                 int32_t *begin_off, int32_t *end_off) {
  const long nc = read_size + 1;
  std::vector<int16_t> tape((size_t)nc * nc);
  const int max_ops = 2 * read_size;
  for (long idx = 0; idx < n; ++idx) {
    const uint8_t *pat = patterns + idx * read_size;
    const uint8_t *txt = texts + idx * read_size;
    const int plen = plens[idx], tlen = tlens[idx];
    for (int j = 0; j <= plen; ++j) tape[(size_t)j * nc] = (int16_t)j;
    for (int i = 0; i <= tlen; ++i) tape[i] = (int16_t)i;
    for (int j = 1; j <= plen; ++j) {
      const uint8_t pc = pat[j - 1];
      int16_t *row = tape.data() + (size_t)j * nc;
      const int16_t *up = row - nc;
      for (int i = 1; i <= tlen; ++i) {
        int16_t d = (int16_t)(up[i - 1] + (pc == txt[i - 1] ? 0 : 1));
        int16_t a = (int16_t)(up[i] + 1);      // 'D': consume pattern
        int16_t b = (int16_t)(row[i - 1] + 1); // 'I': consume text
        if (a < d) d = a;
        if (b < d) d = b;
        row[i] = d;
      }
    }
    int dist = tape[(size_t)plen * nc + tlen];
    const int max_operations = plen + tlen;
    char *o = ops + idx * max_ops;
    if (backtrace) std::memset(o, 'M', (size_t)max_ops);
    int begin = max_operations - 1, end = max_operations;
    if (dist > max_score) {
      scores[idx] = max_score + 1;
    } else {
      scores[idx] = dist;
      if (backtrace) {
        int op = end - 1, j = plen, i = tlen;
        while (j > 0 && i > 0) {
          int16_t cur = tape[(size_t)j * nc + i];
          if (cur == tape[(size_t)(j - 1) * nc + i] + 1) {
            o[op--] = 'D'; --j;
          } else if (cur == tape[(size_t)j * nc + i - 1] + 1) {
            o[op--] = 'I'; --i;
          } else {
            o[op--] = (pat[j - 1] == txt[i - 1]) ? 'M' : 'X';
            --j; --i;
          }
        }
        while (i > 0) { o[op--] = 'I'; --i; }
        while (j > 0) { o[op--] = 'D'; --j; }
        begin = op + 1;
      }
    }
    begin_off[idx] = begin;
    end_off[idx] = end;
  }
}

// ---------------------------------------------------------------------------
// Step-record expansion for the Pallas v2 WFA kernel (ops/wfa_pallas2.py).
// records[i]: rows 0..max_score = per-score-level step records emitted by
// the on-device backtrace in DESCENDING score order (gap | match stroke |
// op per level), rows max_score+1 / max_score+2 = final strokes, row
// max_score+3 = score.  The device walk emitted right-to-left, so the
// left-to-right ops order is: final-I, final-D (or final-M), then levels
// ASCENDING with each level reversed to (op, match stroke, gap) — the
// same reconstruction the reference performs in its 2*READ_SIZE buffer
// (ref: WFA/DPU-MRAM/dpu/wfa_backtracing.c:219-375, host.c:332-353).
// Record encoding: bits 0..13 match-stroke len, 14..15 op (0 none,
// 1 X, 2 I, 3 D), 16..26 trailing-gap len, 27 trailing-gap-is-D.
// ---------------------------------------------------------------------------

extern "C" void aim_wfa_steps_to_ops(const int32_t *records, long sr,
                                     const int32_t *plens,
                                     const int32_t *tlens, long n,
                                     int max_score, int max_ops, char *ops,
                                     int32_t *scores_out, int32_t *begin_off,
                                     int32_t *end_off) {
  static const char OPC[4] = {'M', 'X', 'I', 'D'};
  std::vector<char> runs_op;
  std::vector<int> runs_len;
  for (long i = 0; i < n; ++i) {
    char *o = ops + i * max_ops;
    std::memset(o, 'M', (size_t)max_ops);
    const int32_t *r = records + i * sr;
    const int score = r[max_score + 3];
    scores_out[i] = score;
    const int max_operations = plens[i] + tlens[i];
    int begin = max_operations - 1;
    if (score <= max_score) {
      runs_op.clear();
      runs_len.clear();
      int fin2 = r[max_score + 2];  // final I stroke (leftmost)
      if (fin2 & 0x3FFF) {
        runs_op.push_back(OPC[(fin2 >> 14) & 3]);
        runs_len.push_back(fin2 & 0x3FFF);
      }
      int fin1 = r[max_score + 1];  // final D or M stroke
      if (fin1 & 0x3FFF) {
        runs_op.push_back(OPC[(fin1 >> 14) & 3]);
        runs_len.push_back(fin1 & 0x3FFF);
      }
      for (int s = 0; s <= max_score; ++s) {
        int rec = r[s];
        if (!rec) continue;
        int op = (rec >> 14) & 3;
        if (op) {
          runs_op.push_back(OPC[op]);
          runs_len.push_back(1);
        }
        int mlen = rec & 0x3FFF;
        if (mlen) {
          runs_op.push_back('M');
          runs_len.push_back(mlen);
        }
        int glen = (rec >> 16) & 0x7FF;
        if (glen) {
          runs_op.push_back((rec >> 27) & 1 ? 'D' : 'I');
          runs_len.push_back(glen);
        }
      }
      long total = 0;
      for (int len : runs_len) total += len;
      int pos = max_operations - (int)total;
      if (pos < 0) pos = 0;
      if (pos > max_ops) pos = max_ops;
      begin = pos;
      for (size_t j = 0; j < runs_op.size(); ++j) {
        int len = runs_len[j];
        if (len > max_ops - pos) len = max_ops - pos;
        std::memset(o + pos, runs_op[j], (size_t)len);
        pos += len;
      }
    }
    begin_off[i] = begin;
    end_off[i] = max_operations;
  }
}

// ---------------------------------------------------------------------------
// Output emission — byte-identical to the reference host
// (ref: host.c:340 "%d, %d, \n" + edit_cigar_print host.c:69-89).
// Returns bytes written, or -1 on error.
// ---------------------------------------------------------------------------

// Decimal formatter (manual): fprintf per token measured ~1.1 M
// pairs/s/core with CIGARs (PERFNOTES.md §5) — the emit stage needs
// ~20 host cores per chip at that rate.  Bytes are identical to the
// "%d"-based version.
static inline char *fmt_i32(char *p, int32_t v) {
  uint32_t u = (uint32_t)v;
  if (v < 0) {
    *p++ = '-';
    u = 0u - u;
  }
  char tmp[10];
  int k = 0;
  do {
    tmp[k++] = (char)('0' + (u % 10u));
    u /= 10u;
  } while (u);
  while (k) *p++ = tmp[--k];
  return p;
}

extern "C" long aim_emit_output(const char *path, const int32_t *idx,
                     const int32_t *scores, const char *ops,
                     const int32_t *begin_off, const int32_t *end_off, long n,
                     int max_ops, int backtrace) {
  FILE *f = std::fopen(path, "wb");
  if (!f) return -1;
  std::vector<char> iobuf(1 << 22);
  std::setvbuf(f, iobuf.data(), _IOFBF, iobuf.size());
  // per-pair scratch: header (<=34 B) + worst-case CIGAR (max_ops runs
  // of "NNNNNc") + '\n'
  std::vector<char> line(64 + (size_t)max_ops * 12);
  for (long i = 0; i < n; ++i) {
    char *p = line.data();
    p = fmt_i32(p, idx ? idx[i] : (int32_t)i);
    *p++ = ',';
    *p++ = ' ';
    p = fmt_i32(p, scores[i]);
    *p++ = ',';
    *p++ = ' ';
    *p++ = '\n';
    if (backtrace) {
      const char *o = ops + i * max_ops;
      int b = begin_off[i], e = end_off[i];
      char last = o[b];
      int run = 1;
      for (int j = b + 1; j < e; ++j) {
        if (o[j] == last) {
          ++run;
        } else {
          p = fmt_i32(p, run);
          *p++ = last;
          last = o[j];
          run = 1;
        }
      }
      p = fmt_i32(p, run);
      *p++ = last;
      *p++ = '\n';
    }
    std::fwrite(line.data(), 1, (size_t)(p - line.data()), f);
  }
  long sz = std::ftell(f);
  std::fclose(f);
  return sz;
}


// ---------------------------------------------------------------------------
// 2-bit sequence packing for H2D uploads (see ops/wfa_pallas.pack_seqs).
// Returns 1 and fills out_p/out_t ([n, Rp/4] bytes, 4 bases per byte,
// little-endian 2-bit fields) when the COMBINED alphabet has <= 4 nonzero
// symbols and byte 0 never occurs inside a valid region; else returns 0.
// One shared injective recode preserves alignment semantics (the kernels
// only compare pattern bytes against text bytes for equality).
// ---------------------------------------------------------------------------

// SWAR row packer for the canonical DNA alphabet: recode (c >> 1) & 3
// (A->0, C->1, T->2, G->3 — injective over {A,C,G,T}; padding byte 0
// -> 0, like lut[0]).  Codes are opaque to every consumer — kernels
// compare pattern codes with text codes for equality only, and both
// arrays come from this same call — so the assignment may differ from
// the generic LUT path's sorted order.
static inline void pack_row_acgt(const uint8_t *src, uint8_t *dst,
                                 int read_size, int rb) {
  const int full = read_size / 4;  // whole 4-byte groups inside the row
  for (int b = 0; b < full && b < rb; ++b) {
    uint32_t x;
    std::memcpy(&x, src + 4 * b, 4);
    const uint32_t y = (x >> 1) & 0x03030303u;
    dst[b] = (uint8_t)((y | (y >> 6) | (y >> 12) | (y >> 18)) & 0xFFu);
  }
  for (int b = full; b < rb; ++b) {
    uint8_t v = 0;
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * b + q;
      if (j < read_size) v |= (uint8_t)(((src[j] >> 1) & 3) << (2 * q));
    }
    dst[b] = v;
  }
}

extern "C" int aim_pack_seqs(const uint8_t *pats, const uint8_t *txts,
                             const int32_t *plens, const int32_t *tlens,
                             long n, int read_size, int rp,
                             uint8_t *out_p, uint8_t *out_t) {
  // Fast scan: is every valid byte in {A,C,G,T}?  Branch-free
  // accumulate (auto-vectorizes under -O3); rejects interior NULs for
  // free (0 is not in the set).  The canonical datasets always take
  // this path — the generic seen[]/LUT scan below only runs for
  // non-ACGT alphabets.
  uint8_t nonacgt = 0;
  for (long i = 0; i < n; ++i) {
    const uint8_t *p = pats + i * read_size;
    const uint8_t *t = txts + i * read_size;
    const int pl = plens[i], tl = tlens[i];
    for (int j = 0; j < pl; ++j) {
      const uint8_t c = p[j];
      nonacgt |= (uint8_t)(!(c == 'A' || c == 'C' || c == 'G' || c == 'T'));
    }
    for (int j = 0; j < tl; ++j) {
      const uint8_t c = t[j];
      nonacgt |= (uint8_t)(!(c == 'A' || c == 'C' || c == 'G' || c == 'T'));
    }
  }
  const int rb = rp / 4;
  if (!nonacgt) {
    for (long i = 0; i < n; ++i) {
      pack_row_acgt(pats + i * read_size, out_p + i * rb, read_size, rb);
      pack_row_acgt(txts + i * read_size, out_t + i * rb, read_size, rb);
    }
    return 1;
  }

  bool seen[256] = {false};
  for (long i = 0; i < n; ++i) {
    const uint8_t *p = pats + i * read_size;
    const uint8_t *t = txts + i * read_size;
    const int pl = plens[i], tl = tlens[i];
    for (int j = 0; j < pl; ++j) {
      if (!p[j]) return 0;  // interior NUL would alias the padding code
      seen[p[j]] = true;
    }
    for (int j = 0; j < tl; ++j) {
      if (!t[j]) return 0;
      seen[t[j]] = true;
    }
  }
  uint8_t lut[256] = {0};
  int nsym = 0;
  for (int c = 1; c < 256; ++c) {
    if (seen[c]) {
      if (nsym == 4) return 0;
      lut[c] = (uint8_t)nsym++;
    }
  }
  for (long i = 0; i < n; ++i) {
    const uint8_t *p = pats + i * read_size;
    const uint8_t *t = txts + i * read_size;
    uint8_t *op = out_p + i * rb;
    uint8_t *ot = out_t + i * rb;
    for (int b = 0; b < rb; ++b) {
      uint8_t vp = 0, vt = 0;
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * b + q;
        if (j < read_size) {
          vp |= (uint8_t)(lut[p[j]] << (2 * q));
          vt |= (uint8_t)(lut[t[j]] << (2 * q));
        }
      }
      op[b] = vp;
      ot[b] = vt;
    }
  }
  return 1;
}
