// Native cloud reader and writer of the PyTorch port: a copy of
// tpuslam/native/loader.cpp (the JAX package's counterpart of the
// reference's C++/Assimp loading layer, AssimpCloudLoader,
// source/common/loader.cpp:30-66).  Same observable semantics as the
// Python readers in tpuslam_torch/data/loader.py, which it is tested
// against:
//
//  * OBJ: positions from `v` lines, then one output point per face-corner
//    reference in file order (Assimp's per-corner vertex buffer before
//    triangulation).  Faces with fewer than 3 corners are ignored;
//    negative indices are relative to the current vertex count.  A
//    face-free OBJ yields the raw vertex list.
//  * OFF: the raw vertex list (header `OFF [nv nf ne]`), comments and
//    blank lines skipped.
//  * Any parse/IO failure yields 0 points (LoadCloud's empty-cloud
//    contract, common.cpp:16-23).
//  * The writers print `%.9g`, so a written cloud loads back bit for bit.
//
// A plain C ABI, bound with ctypes by tpuslam_torch/native/bindings.py,
// which builds this file with the host C++ compiler at first use.

#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// read entire file; empty on failure
std::string slurp(const char *path) {
  FILE *fh = std::fopen(path, "rb");
  if (!fh) return {};
  std::fseek(fh, 0, SEEK_END);
  long size = std::ftell(fh);
  if (size <= 0) {
    std::fclose(fh);
    return {};
  }
  std::fseek(fh, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  size_t got = std::fread(&buf[0], 1, static_cast<size_t>(size), fh);
  std::fclose(fh);
  buf.resize(got);
  return buf;
}

inline bool is_ws(char c) {
  // Python str.split() whitespace set (the subset that appears in text
  // files): space, tab, CR, LF, vertical tab, form feed
  return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v' ||
         c == '\f';
}

// a line ends at '\n' or at a lone '\r': the Python oracle reads text
// mode with universal newlines, where '\r', '\r\n', and '\n' all break
// lines — splitting on '\n' alone would merge classic-Mac lines and
// silently produce divergent geometry
inline const char *line_end(const char *p, const char *end) {
  while (p < end && *p != '\n' && *p != '\r') ++p;
  return p;
}

// advance past the terminator found by line_end ('\r\n' is ONE break)
inline const char *next_line(const char *eol, const char *end) {
  if (eol < end && *eol == '\r') {
    ++eol;
    if (eol < end && *eol == '\n') ++eol;
    return eol;
  }
  return (eol < end && *eol == '\n') ? eol + 1 : eol;
}

// whitespace-delimited tokens of [p, end) — one LINE's worth
void line_tokens(const char *p, const char *end,
                 std::vector<std::pair<const char *, const char *>> *toks) {
  toks->clear();
  while (p < end) {
    while (p < end && is_ws(*p)) ++p;
    if (p >= end) break;
    const char *start = p;
    while (p < end && !is_ws(*p)) ++p;
    toks->emplace_back(start, p);
  }
}

inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

// digit run with PEP-515 underscores: digit (('_')? digit)* — each
// underscore must sit between two digits, exactly like Python's
// float()/int() literals.  Advances *p past the run; false if the run
// is empty or an underscore is misplaced.
bool scan_digits(const char **p, const char *e) {
  if (*p >= e || !is_digit(**p)) return false;
  ++*p;
  while (*p < e) {
    if (is_digit(**p)) {
      ++*p;
    } else if (**p == '_') {
      if (*p + 1 >= e || !is_digit((*p)[1])) return false;
      *p += 2;
    } else {
      break;
    }
  }
  return true;
}

inline bool ieq(const char *b, const char *e, const char *lit) {
  for (; *lit; ++lit, ++b)
    if (b >= e || (*b | 0x20) != *lit) return false;
  return b == e;
}

// full-token float with Python float(tok) acceptance: decimal grammar
// only (strtof's C99 hex-float extension is rejected), "inf"/
// "infinity"/"nan" case-insensitively (strtof's "nan(...)" payload
// form is rejected), PEP-515 underscores accepted.  The ENTIRE token
// must parse, or the file is rejected (the oracle raises ValueError).
bool parse_float_exact(const char *b, const char *e, float *v) {
  const char *p = b;
  if (p < e && (*p == '+' || *p == '-')) ++p;
  if (ieq(p, e, "inf") || ieq(p, e, "infinity") || ieq(p, e, "nan")) {
    std::string tok(b, e);
    char *after = nullptr;
    *v = std::strtof(tok.c_str(), &after);
    return after == tok.c_str() + tok.size();
  }
  bool int_digits = false, frac_digits = false;
  if (p < e && is_digit(*p)) {
    if (!scan_digits(&p, e)) return false;
    int_digits = true;
  }
  if (p < e && *p == '.') {
    ++p;
    if (p < e && is_digit(*p)) {
      if (!scan_digits(&p, e)) return false;
      frac_digits = true;
    }
  }
  if (!int_digits && !frac_digits) return false;
  if (p < e && (*p == 'e' || *p == 'E')) {
    ++p;
    if (p < e && (*p == '+' || *p == '-')) ++p;
    if (!scan_digits(&p, e)) return false;
  }
  if (p != e) return false;
  std::string tok;
  tok.reserve(static_cast<size_t>(e - b));
  for (const char *q = b; q < e; ++q)
    if (*q != '_') tok.push_back(*q);
  char *after = nullptr;
  *v = std::strtof(tok.c_str(), &after);
  return after == tok.c_str() + tok.size();
}

// full-token integer with Python int(tok) acceptance (base 10,
// PEP-515 underscores).  Values beyond long's range saturate like
// strtol; callers bound-check against vertex counts anyway, and the
// oracle's arbitrary-precision result would fail the same bound.
bool parse_long_exact(const char *b, const char *e, long *v) {
  const char *p = b;
  if (p < e && (*p == '+' || *p == '-')) ++p;
  if (!scan_digits(&p, e) || p != e) return false;
  std::string tok;
  tok.reserve(static_cast<size_t>(e - b));
  for (const char *q = b; q < e; ++q)
    if (*q != '_') tok.push_back(*q);
  errno = 0;
  char *after = nullptr;
  *v = std::strtol(tok.c_str(), &after, 10);
  if (errno == ERANGE)  // saturate safely; bound checks reject later
    *v = (*v > 0) ? (1L << 40) : -(1L << 40);
  return after == tok.c_str() + tok.size();
}

// Parity contract: this parser must be observably identical to the
// Python oracle (tpuslam_torch/data/loader.py::_load_obj_python).  In
// particular a malformed `v`/`f` payload token REJECTS THE WHOLE FILE
// (the oracle's float()/int() raise and load_cloud returns an empty
// cloud) — silently skipping a vertex would shift every later face
// index and return plausible-looking wrong geometry.  Marker detection
// is also oracle-exact: only lines starting with exactly "v " / "f "
// count (no leading whitespace, no tab after the marker).
long load_obj_points(const std::string &text, std::vector<float> *out) {
  std::vector<float> verts;  // xyz triples
  std::vector<long> corners;
  std::vector<std::pair<const char *, const char *>> toks;
  const char *p = text.data();
  const char *end = p + text.size();
  while (p < end) {
    const char *eol = line_end(p, end);
    if (eol - p >= 2 && p[0] == 'v' && p[1] == ' ') {
      line_tokens(p, eol, &toks);
      if (toks.size() < 4) return -1;  // oracle: IndexError => empty
      float xyz[3];
      for (int i = 0; i < 3; ++i)
        if (!parse_float_exact(toks[i + 1].first, toks[i + 1].second,
                               &xyz[i]))
          return -1;  // oracle: ValueError => empty
      verts.push_back(xyz[0]);
      verts.push_back(xyz[1]);
      verts.push_back(xyz[2]);
    } else if (eol - p >= 2 && p[0] == 'f' && p[1] == ' ') {
      line_tokens(p, eol, &toks);
      std::vector<long> face;
      const long nverts = static_cast<long>(verts.size() / 3);
      for (size_t t = 1; t < toks.size(); ++t) {
        // "v", "v/vt", "v/vt/vn", "v//vn": the part before the first
        // '/'; an empty part (e.g. "//5") is skipped like the oracle's
        // `if not s: continue`
        const char *b = toks[t].first;
        const char *e = toks[t].second;
        const char *slash = b;
        while (slash < e && *slash != '/') ++slash;
        if (slash == b) continue;
        long idx;
        if (!parse_long_exact(b, slash, &idx)) return -1;  // int() raises
        face.push_back(idx > 0 ? idx - 1 : nverts + idx);
      }
      if (face.size() >= 3)
        corners.insert(corners.end(), face.begin(), face.end());
    }
    p = next_line(eol, end);
  }
  if (verts.empty()) return 0;
  const long nverts = static_cast<long>(verts.size() / 3);
  if (corners.empty()) {
    *out = std::move(verts);
    return nverts;
  }
  out->reserve(corners.size() * 3);
  for (long c : corners) {
    // the oracle gathers with numpy, whose indexing wraps one extra
    // negative turn: a doubly-relative corner (stored nverts+idx still
    // < 0) resolves to nverts+c when -nverts <= c, IndexError below that
    long row = c < 0 ? c + nverts : c;
    if (row < 0 || row >= nverts) return -1;  // oracle: IndexError => empty
    out->push_back(verts[3 * row]);
    out->push_back(verts[3 * row + 1]);
    out->push_back(verts[3 * row + 2]);
  }
  return static_cast<long>(corners.size());
}

// strip an inline `#` comment: shrink [b, e) to the part before '#'
inline void strip_comment(const char *b, const char **e) {
  const char *q = b;
  while (q < *e && *q != '#') ++q;
  *e = q;
}

// Parity contract: observably identical to the Python oracle
// (tpuslam_torch/data/loader.py::_load_off) — header line stripped then
// checked for the "OFF" prefix; count lines consumed token-by-token as
// full integers; vertex lines need three full-float leading tokens; a
// malformed count or vertex token rejects the WHOLE file (the oracle
// raises), while plain EOF mid-list returns the partial prefix.
long load_off_points(const std::string &text, std::vector<float> *out) {
  std::vector<std::pair<const char *, const char *>> toks;
  const char *p = text.data();
  const char *end = p + text.size();

  // header: first line, stripped, must start with "OFF"; the remainder
  // of that line already carries count tokens ("OFF 8 6 12")
  const char *eol = line_end(p, end);
  const char *h = p;
  const char *he = eol;
  while (h < he && is_ws(*h)) ++h;
  while (he > h && is_ws(he[-1])) --he;
  if (he - h < 3 || std::strncmp(h, "OFF", 3) != 0) return 0;
  std::vector<long> counts;
  line_tokens(h + 3, he, &toks);
  for (auto &t : toks) {
    long v;
    if (!parse_long_exact(t.first, t.second, &v)) return -1;
    counts.push_back(v);
  }
  p = next_line(eol, end);

  // count lines: every token of a consumed line must be an integer
  while (counts.size() < 3) {
    if (p >= end) return 0;  // oracle: EOF here => empty cloud
    eol = line_end(p, end);
    const char *ce = eol;
    strip_comment(p, &ce);
    line_tokens(p, ce, &toks);
    p = next_line(eol, end);
    for (auto &t : toks) {
      long v;
      if (!parse_long_exact(t.first, t.second, &v)) return -1;
      counts.push_back(v);
    }
  }
  const long nv = counts[0];
  if (nv <= 0) return 0;
  // Reserve lazily, bounded by what the remaining text could possibly
  // hold (a vertex row is at least 6 bytes, "0 0 0\n"; +16 covers a
  // final unterminated row), so a corrupt header like
  // `OFF 99999999999 0 0` cannot drive reserve() into a huge transient
  // allocation; the vector simply grows to the rows actually present
  // and EOF yields the partial prefix, exactly like the oracle's
  // bounded preallocation (tpuslam_torch/data/loader.py::_load_off).
  const long row_bound = static_cast<long>(end - p) / 6 + 16;
  out->reserve(static_cast<size_t>(nv < row_bound ? nv : row_bound) * 3);
  long filled = 0;
  while (filled < nv) {
    if (p >= end) break;  // oracle: EOF => partial prefix
    eol = line_end(p, end);
    const char *ce = eol;
    strip_comment(p, &ce);
    line_tokens(p, ce, &toks);
    p = next_line(eol, end);
    if (toks.empty()) continue;  // blank / comment-only line
    if (toks.size() < 3) return -1;  // oracle: IndexError => empty
    for (int i = 0; i < 3; ++i) {
      float v;
      if (!parse_float_exact(toks[i].first, toks[i].second, &v))
        return -1;  // oracle: ValueError => empty
      out->push_back(v);
    }
    ++filled;
  }
  out->resize(static_cast<size_t>(filled) * 3);
  return filled;
}

long emit(std::vector<float> &&pts, long count, float **out) {
  if (count <= 0) {
    *out = nullptr;
    return 0;
  }
  float *buf =
      static_cast<float *>(std::malloc(pts.size() * sizeof(float)));
  if (!buf) {
    *out = nullptr;
    return 0;
  }
  std::memcpy(buf, pts.data(), pts.size() * sizeof(float));
  *out = buf;
  return count;
}

// No exception may cross the C ABI: any allocation failure (bad_alloc on
// a corrupt file) counts as a parse failure and yields 0 points, matching
// the Python fallback which catches MemoryError.
long load_guarded(const char *path,
                  long (*parse)(const std::string &, std::vector<float> *),
                  float **out) {
  try {
    std::string text = slurp(path);
    if (text.empty()) {
      *out = nullptr;
      return 0;
    }
    std::vector<float> pts;
    long n = parse(text, &pts);
    return emit(std::move(pts), n, out);
  } catch (...) {
    *out = nullptr;
    return 0;
  }
}

// ---- writers ------------------------------------------------------
// Format contract shared with the Python fallback
// (tpuslam_torch/data/writer.py): one point per line, coordinates printed
// with %.9g (9 significant decimal digits round-trip any binary32
// exactly), '\n' newlines — native and fallback must produce
// byte-identical files, and load_cloud(save_cloud(x)) == x bit-for-bit
// (asserted in tests/test_torch_front.py).

bool write_rows(FILE *fh, const char *prefix, const float *pts, long n) {
  for (long i = 0; i < n; ++i) {
    if (std::fprintf(fh, "%s%.9g %.9g %.9g\n", prefix,
                     static_cast<double>(pts[3 * i]),
                     static_cast<double>(pts[3 * i + 1]),
                     static_cast<double>(pts[3 * i + 2])) < 0)
      return false;
  }
  return true;
}

long write_guarded(const char *path, const float *pts, long n,
                   const char *header, const char *prefix) {
  if (n < 0 || (n > 0 && !pts)) return 0;
  FILE *fh = std::fopen(path, "wb");
  if (!fh) return 0;
  bool ok = true;
  if (header && std::fprintf(fh, "%s", header) < 0) ok = false;
  if (ok) ok = write_rows(fh, prefix, pts, n);
  if (std::fclose(fh) != 0) ok = false;
  return ok ? 1 : 0;
}

}  // namespace

extern "C" {

long tpuslam_load_obj(const char *path, float **out) {
  return load_guarded(path, load_obj_points, out);
}

long tpuslam_load_off(const char *path, float **out) {
  return load_guarded(path, load_off_points, out);
}

long tpuslam_write_obj(const char *path, const float *pts, long n) {
  return write_guarded(path, pts, n, nullptr, "v ");
}

long tpuslam_write_off(const char *path, const float *pts, long n) {
  char header[64];
  std::snprintf(header, sizeof(header), "OFF\n%ld 0 0\n", n);
  return write_guarded(path, pts, n, header, "");
}

void tpuslam_free(float *p) { std::free(p); }
}
