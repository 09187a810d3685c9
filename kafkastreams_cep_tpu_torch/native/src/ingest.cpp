// Native host-runtime kernels: columnar batch packing + JSON-lines event
// parsing.
//
// The reference's ingest boundary is Kafka Streams handing one deserialized
// record at a time to CEPProcessor.process() (CEPProcessor.java:154-163),
// with serdes (serde/KryoSerDe.java, demo StockEventSerDe.java:50-89) doing
// byte<->object work in the JVM.  Here the ingest boundary feeds a GPU: the
// host groups a micro-batch of records into per-key lanes and scatters them
// into rectangular [K, T] arrays that are then copied to the card.  That
// packing is pointer chasing, so it lives in native code rather than in
// Python loops.  Exposed extern "C" and loaded via ctypes
// (kafkastreams_cep_tpu_torch/native/__init__.py), with NumPy plain versions.
// The C ABI is the JAX package's (kafkastreams_cep_tpu/native/src/ingest.cpp).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC ingest.cpp -o libcepingest.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>

extern "C" {

// ---------------------------------------------------------------------------
// Lane-queue positioning: for each kept record (arrival order), its position
// within its lane's queue this batch.  qlen_out[K] receives final queue
// lengths.  Returns the max queue length (the T to pad to), 0 if empty.
int32_t cep_queue_positions(const int32_t* lanes, const uint8_t* keep,
                            int64_t n, int32_t num_lanes, int32_t* pos_out,
                            int32_t* qlen_out) {
  for (int32_t k = 0; k < num_lanes; ++k) qlen_out[k] = 0;
  int32_t max_len = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!keep[i]) {
      pos_out[i] = -1;
      continue;
    }
    int32_t lane = lanes[i];
    int32_t p = qlen_out[lane]++;
    pos_out[i] = p;
    if (qlen_out[lane] > max_len) max_len = qlen_out[lane];
  }
  return max_len;
}

// Scatter one int32 column into its [K, T] slot grid.
void cep_pack_i32(int32_t* dst, const int32_t* src, const int32_t* lanes,
                  const int32_t* pos, const uint8_t* keep, int64_t n,
                  int64_t T) {
  for (int64_t i = 0; i < n; ++i)
    if (keep[i]) dst[(int64_t)lanes[i] * T + pos[i]] = src[i];
}

// Scatter one float32 column into its [K, T] slot grid.
void cep_pack_f32(float* dst, const float* src, const int32_t* lanes,
                  const int32_t* pos, const uint8_t* keep, int64_t n,
                  int64_t T) {
  for (int64_t i = 0; i < n; ++i)
    if (keep[i]) dst[(int64_t)lanes[i] * T + pos[i]] = src[i];
}

// Scatter one int64 column (arrival ranks) into its [K, T] slot grid.
void cep_pack_i64(int64_t* dst, const int64_t* src, const int32_t* lanes,
                  const int32_t* pos, const uint8_t* keep, int64_t n,
                  int64_t T) {
  for (int64_t i = 0; i < n; ++i)
    if (keep[i]) dst[(int64_t)lanes[i] * T + pos[i]] = src[i];
}

// Mark valid slots in the [K, T] grid.
void cep_pack_valid(uint8_t* dst, const int32_t* lanes, const int32_t* pos,
                    const uint8_t* keep, int64_t n, int64_t T) {
  for (int64_t i = 0; i < n; ++i)
    if (keep[i]) dst[(int64_t)lanes[i] * T + pos[i]] = 1;
}

// ---------------------------------------------------------------------------
// JSON-lines parsing: flat objects with numeric fields and at most one
// string field of interest (the record key), e.g. the demo's
// {"name":"e1","price":100,"volume":1010} (StockEventSerDe.java:50-89).
//
// Restrictions (by design — this is a columnar fast path, not a general
// JSON library): no nested objects/arrays, no escapes inside the key
// string, numbers are doubles.  Lines failing to parse are skipped and
// counted; the caller can fall back to Python json for them.

namespace {

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// Parse a JSON string token at p (pointing at '"'); returns pointer past the
// closing quote, writes [start, len) of the contents. No escape handling —
// a backslash fails the parse (caller falls back).
inline const char* parse_string(const char* p, const char* end,
                                const char** start, int64_t* len) {
  if (p >= end || *p != '"') return nullptr;
  ++p;
  *start = p;
  while (p < end && *p != '"') {
    if (*p == '\\') return nullptr;
    ++p;
  }
  if (p >= end) return nullptr;
  *len = p - *start;
  return p + 1;
}

}  // namespace

// Parse up to max_lines newline-separated JSON objects from buf.
//
//   field_names: num_fields zero-terminated numeric field names, back to back
//   key_field:   zero-terminated name of the string key field ("" = none)
//   num_out:     [max_lines, num_fields] doubles (NaN = field absent)
//   key_out:     [max_lines, key_width] bytes, zero-padded
//   line_ok:     [max_lines] 1 = parsed, 0 = skipped (caller falls back)
//
// Returns the number of lines consumed (parsed or skipped); *n_bad receives
// the number skipped.
int64_t cep_parse_json_lines(const char* buf, int64_t len,
                             const char* field_names, int32_t num_fields,
                             const char* key_field, double* num_out,
                             char* key_out, int64_t key_width,
                             uint8_t* line_ok, int64_t max_lines,
                             int64_t* n_bad) {
  // Decode the field-name table once.
  const char* names[64];
  int64_t name_lens[64];
  if (num_fields > 64) return -1;
  {
    const char* p = field_names;
    for (int32_t f = 0; f < num_fields; ++f) {
      names[f] = p;
      name_lens[f] = (int64_t)strlen(p);
      p += name_lens[f] + 1;
    }
  }
  const int64_t key_len_name = (int64_t)strlen(key_field);

  const char* p = buf;
  const char* end = buf + len;
  int64_t line = 0;
  *n_bad = 0;

  while (p < end && line < max_lines) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    const char* q = skip_ws(p, line_end);

    double* row = num_out + line * num_fields;
    for (int32_t f = 0; f < num_fields; ++f) row[f] = NAN;
    char* krow = key_out + line * key_width;
    if (key_width > 0) memset(krow, 0, key_width);

    bool ok = q < line_end && *q == '{';
    if (ok) {
      ++q;
      for (;;) {
        q = skip_ws(q, line_end);
        if (q < line_end && *q == '}') {
          ++q;
          break;
        }
        const char* fname;
        int64_t fname_len;
        q = parse_string(q, line_end, &fname, &fname_len);
        if (!q) { ok = false; break; }
        q = skip_ws(q, line_end);
        if (q >= line_end || *q != ':') { ok = false; break; }
        q = skip_ws(q + 1, line_end);
        if (q >= line_end) { ok = false; break; }

        if (*q == '"') {  // string value
          const char* vstart;
          int64_t vlen;
          q = parse_string(q, line_end, &vstart, &vlen);
          if (!q) { ok = false; break; }
          if (key_width > 0 && fname_len == key_len_name &&
              memcmp(fname, key_field, fname_len) == 0) {
            if (vlen > key_width) { ok = false; break; }  // key too wide
            memset(krow, 0, key_width);  // duplicated field: last one wins
            memcpy(krow, vstart, vlen);
          }
        } else {  // numeric value (true/false/null fail the grammar check)
          char* numend = nullptr;
          double v = strtod(q, &numend);
          if (numend == q || numend > line_end) { ok = false; break; }
          // The consumed token must match the exact JSON number grammar —
          // strtod alone also accepts inf/nan/hex, leading zeros ("01"),
          // bare trailing dots ("1."), and "1.e3", all of which json.loads
          // (the fallback) rejects.
          const char* c = q;
          if (c < numend && *c == '-') ++c;
          if (c < numend && *c == '0') {
            ++c;  // a leading 0 must be the whole integer part
          } else if (c < numend && *c >= '1' && *c <= '9') {
            while (c < numend && *c >= '0' && *c <= '9') ++c;
          } else {
            ok = false;
            break;
          }
          if (c < numend && *c == '.') {
            ++c;
            if (c >= numend || *c < '0' || *c > '9') { ok = false; break; }
            while (c < numend && *c >= '0' && *c <= '9') ++c;
          }
          if (c < numend && (*c == 'e' || *c == 'E')) {
            ++c;
            if (c < numend && (*c == '+' || *c == '-')) ++c;
            if (c >= numend || *c < '0' || *c > '9') { ok = false; break; }
            while (c < numend && *c >= '0' && *c <= '9') ++c;
          }
          if (c != numend) { ok = false; break; }
          for (int32_t f = 0; f < num_fields; ++f) {
            if (fname_len == name_lens[f] &&
                memcmp(fname, names[f], fname_len) == 0) {
              row[f] = v;
              break;
            }
          }
          q = numend;
        }

        q = skip_ws(q, line_end);
        if (q < line_end && *q == ',') { ++q; continue; }
        if (q < line_end && *q == '}') { ++q; break; }
        ok = false;
        break;
      }
      // Trailing garbage after the closing brace fails the line.
      if (ok && skip_ws(q, line_end) != line_end) ok = false;
      // All requested numeric fields must be present.
      if (ok)
        for (int32_t f = 0; f < num_fields; ++f)
          if (std::isnan(row[f])) { ok = false; break; }
    }

    line_ok[line] = ok ? 1 : 0;
    if (!ok) ++(*n_bad);
    ++line;
    p = (line_end < end) ? line_end + 1 : end;
  }
  return line;
}

// ---------------------------------------------------------------------------
// Version tag so the Python side can verify the loaded library matches the
// source it expects (rebuilds are keyed by source hash; this is a backstop).
int32_t cep_native_abi_version() { return 1; }

}  // extern "C"
