// Native durable record journal — the changelog-segment analog.
//
// The reference inherits durability from Kafka: every state store is
// changelog-backed, and the broker's log segments make replay possible
// after any failure (SURVEY §5; CEPProcessor.java:144-149).  Here the
// supervisor checkpoints state arrays and journals the record batches
// since the last snapshot; this file gives that journal a crash-safe
// on-disk form: an append-only log of CRC32-framed payloads with
// fsync-on-demand, written natively so the per-batch cost is one write
// syscall, not Python byte shuffling.
//
// Frame layout (little-endian):
//   u32 magic = 0x43455031 ("CEP1")  u32 payload_len  u32 crc32(payload)
//   payload bytes
//
// A reader validates frames in order and stops at the first corrupt or
// truncated frame (a torn write from a crash) — everything before it is
// intact, matching a log truncated at the last good record.  The Python
// fallback (native/journal.py) implements the identical format with
// zlib.crc32; files are interchangeable between the two.
//
// This is the port's copy of kafkastreams_cep_tpu/native/src/journal.cpp
// (the same frames and C ABI, so each package reads the other's journals).
// Build: its own shared library, compiled with g++ at first use by
// native/journal.py into kafkastreams_cep_tpu_torch/build/.

#include <cstdint>
#include <cstdio>
#include <cstring>

#if defined(__unix__) || defined(__APPLE__)
#include <unistd.h>
#endif

extern "C" {

static const uint32_t kMagic = 0x43455031u;

// CRC-32 (IEEE 802.3, reflected, init/final 0xFFFFFFFF) — the same
// polynomial and conventions as zlib.crc32, table generated on first use.
static uint32_t crc_table[256];
static int crc_table_ready = 0;

static void crc_init() {
  for (uint32_t n = 0; n < 256; ++n) {
    uint32_t c = n;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : (c >> 1);
    crc_table[n] = c;
  }
  crc_table_ready = 1;
}

uint32_t cep_crc32(const uint8_t* buf, int64_t len) {
  if (!crc_table_ready) crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < len; ++i)
    c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// Append one framed payload to the file (opened/closed per call — batch
// appends are rare enough that open cost is noise, and no handle state
// must survive across the ctypes boundary).  Returns 0 on success.
int32_t cep_journal_append(const char* path, const uint8_t* payload,
                           int64_t len, int32_t sync) {
  if (len < 0 || len > (int64_t)0xFFFFFFFF) return -3;  // u32 frame length
  FILE* f = fopen(path, "ab");
  if (!f) return -1;
  uint32_t header[3] = {kMagic, (uint32_t)len, cep_crc32(payload, len)};
  int ok = fwrite(header, sizeof(header), 1, f) == 1 &&
           (len == 0 || fwrite(payload, (size_t)len, 1, f) == 1);
  if (ok && fflush(f) != 0) ok = 0;
#if defined(__unix__) || defined(__APPLE__)
  if (ok && sync) {
    // fsync: flush the page cache so a machine crash keeps the frame;
    // plain process crashes are covered by fflush alone.
    if (fsync(fileno(f)) != 0) ok = 0;
  }
#endif
  fclose(f);
  return ok ? 0 : -2;
}

// Validate frames in buf; writes each frame's (payload_offset, payload_len)
// into out (pairs of int64), up to max_frames.  Returns the number of valid
// frames; *valid_bytes receives the byte length of the intact prefix.
int64_t cep_journal_scan(const uint8_t* buf, int64_t len, int64_t* out,
                         int64_t max_frames, int64_t* valid_bytes) {
  int64_t pos = 0, n = 0;
  while (n < max_frames && pos + 12 <= len) {
    uint32_t magic, plen, crc;
    memcpy(&magic, buf + pos, 4);
    memcpy(&plen, buf + pos + 4, 4);
    memcpy(&crc, buf + pos + 8, 4);
    if (magic != kMagic) break;
    if (pos + 12 + (int64_t)plen > len) break;  // truncated tail
    if (cep_crc32(buf + pos + 12, plen) != crc) break;  // corrupt
    out[2 * n] = pos + 12;
    out[2 * n + 1] = plen;
    ++n;
    pos += 12 + plen;
  }
  *valid_bytes = pos;
  return n;
}

}  // extern "C"
