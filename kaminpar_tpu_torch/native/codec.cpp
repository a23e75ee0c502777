// Native host runtime: graph codecs + text tokenizer.
//
// The reference implements its memory-frugal graph storage and IO in C++
// (kaminpar-common/graph_compression/varint.h, streamvbyte.h;
// kaminpar-io/metis_parser.cc with the mmap tokenizer util/file_toker.h).
// This file is the TPU framework's native equivalent: bulk varint-gap
// encode/decode of sorted CSR neighborhoods and a one-pass METIS body
// tokenizer, exposed through a C ABI consumed via ctypes
// (kaminpar_tpu/native/__init__.py).  The device compute path stays
// JAX/XLA; this is host-runtime code on the ingest/storage path.
//
// Build: g++ -O3 -march=native -shared -fPIC codec.cpp -o libkmpnative.so

#include <cstdint>
#include <cstring>

extern "C" {

// --------------------------------------------------------------------------
// Varint gap codec.
//
// Per node u with sorted neighborhood v_0 < v_1 < ... the stored stream is
// varint(v_0 + 1), varint(v_1 - v_0), ... (first neighbor biased by +1 so a
// gap of 0 never appears; gaps between distinct sorted neighbors are >= 1).
// Unsigned LEB128, 7 bits per byte.
// --------------------------------------------------------------------------

static inline int varint_size(uint32_t x) {
  int s = 1;
  while (x >= 0x80) {
    x >>= 7;
    ++s;
  }
  return s;
}

static inline uint8_t* varint_write(uint8_t* p, uint32_t x) {
  while (x >= 0x80) {
    *p++ = (uint8_t)(x | 0x80);
    x >>= 7;
  }
  *p++ = (uint8_t)x;
  return p;
}

static inline const uint8_t* varint_read(const uint8_t* p, uint32_t* out) {
  uint32_t x = 0;
  int shift = 0;
  while (true) {
    uint8_t b = *p++;
    x |= (uint32_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  *out = x;
  return p;
}

// Size pass: bytes needed to encode every neighborhood.  offsets[u] receives
// the byte offset of node u's stream; returns the total byte count.
int64_t kmp_encode_gaps_size(int64_t n, const int64_t* xadj,
                             const int32_t* adjncy, int64_t* offsets) {
  int64_t total = 0;
  for (int64_t u = 0; u < n; ++u) {
    offsets[u] = total;
    int64_t lo = xadj[u], hi = xadj[u + 1];
    if (lo < hi) {
      total += varint_size((uint32_t)adjncy[lo] + 1u);
      for (int64_t e = lo + 1; e < hi; ++e)
        total += varint_size((uint32_t)(adjncy[e] - adjncy[e - 1]));
    }
  }
  offsets[n] = total;
  return total;
}

// Write pass into a caller-allocated buffer of kmp_encode_gaps_size bytes.
void kmp_encode_gaps(int64_t n, const int64_t* xadj, const int32_t* adjncy,
                     const int64_t* offsets, uint8_t* out) {
  for (int64_t u = 0; u < n; ++u) {
    uint8_t* p = out + offsets[u];
    int64_t lo = xadj[u], hi = xadj[u + 1];
    if (lo < hi) {
      p = varint_write(p, (uint32_t)adjncy[lo] + 1u);
      for (int64_t e = lo + 1; e < hi; ++e)
        p = varint_write(p, (uint32_t)(adjncy[e] - adjncy[e - 1]));
    }
  }
}

// Decode all neighborhoods back into CSR (xadj must match the original).
void kmp_decode_gaps(int64_t n, const int64_t* xadj, const int64_t* offsets,
                     const uint8_t* bytes, int32_t* adjncy_out) {
  for (int64_t u = 0; u < n; ++u) {
    const uint8_t* p = bytes + offsets[u];
    int64_t lo = xadj[u], hi = xadj[u + 1];
    if (lo < hi) {
      uint32_t first;
      p = varint_read(p, &first);
      adjncy_out[lo] = (int32_t)(first - 1u);
      int32_t prev = adjncy_out[lo];
      for (int64_t e = lo + 1; e < hi; ++e) {
        uint32_t gap;
        p = varint_read(p, &gap);
        prev += (int32_t)gap;
        adjncy_out[e] = prev;
      }
    }
  }
}

// Decode one node's neighborhood; returns its degree.
int64_t kmp_decode_node(int64_t u, const int64_t* xadj, const int64_t* offsets,
                        const uint8_t* bytes, int32_t* out) {
  const uint8_t* p = bytes + offsets[u];
  int64_t deg = xadj[u + 1] - xadj[u];
  if (deg > 0) {
    uint32_t first;
    p = varint_read(p, &first);
    out[0] = (int32_t)(first - 1u);
    for (int64_t i = 1; i < deg; ++i) {
      uint32_t gap;
      p = varint_read(p, &gap);
      out[i] = out[i - 1] + (int32_t)gap;
    }
  }
  return deg;
}

// --------------------------------------------------------------------------
// METIS body tokenizer (one pass over the mmap'd text after the header).
//
// Contract mirrors kaminpar-io/metis_parser.cc semantics: one line per node,
// optional leading node weight, neighbor ids 1-based, optional per-neighbor
// edge weight, '%' comment lines skipped, empty line = isolated node.
// Returns the number of directed edges written, or -(line) on malformed
// input.  xadj must have n+1 slots; adjncy/edge weights sized by the header
// edge count * 2.
// --------------------------------------------------------------------------

int64_t kmp_parse_metis_body(const char* buf, int64_t len, int64_t n,
                             int has_vw, int has_ew, int64_t max_m,
                             int64_t* xadj, int32_t* adjncy, int64_t* vw,
                             int64_t* ew) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t edge = 0;
  int64_t node = 0;

  while (node < n) {
    if (p >= end) {
      // trailing nodes with no line: treat as isolated (tolerant like the
      // reference's parser at EOF)
      xadj[node] = edge;
      if (has_vw) vw[node] = 1;
      ++node;
      continue;
    }
    if (*p == '%') {  // comment line
      while (p < end && *p != '\n') ++p;
      if (p < end) ++p;
      continue;
    }
    xadj[node] = edge;
    bool read_vw = !has_vw;
    int64_t first_tok = 1;
    // parse tokens until newline
    while (p < end && *p != '\n') {
      // skip spaces/tabs/CR
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
      if (p >= end || *p == '\n') break;
      uint64_t val = 0;
      if (*p < '0' || *p > '9') return -(node + 1);
      while (p < end && *p >= '0' && *p <= '9') {
        val = val * 10 + (uint64_t)(*p - '0');
        ++p;
      }
      if (!read_vw) {
        vw[node] = (int64_t)val;
        read_vw = true;
      } else if (first_tok || !has_ew) {
        if (edge >= max_m) return -(node + 1);
        if (val == 0) return -(node + 1);  // ids are 1-based
        adjncy[edge] = (int32_t)(val - 1);
        if (has_ew) {
          first_tok = 0;  // next numeric token is this edge's weight
        } else {
          ++edge;
        }
      } else {
        ew[edge] = (int64_t)val;
        ++edge;
        first_tok = 1;
      }
    }
    if (has_ew && !first_tok) return -(node + 1);  // dangling neighbor
    if (has_vw && !read_vw) vw[node] = 1;  // empty line, weighted graph
    if (p < end) ++p;  // consume newline
    ++node;
  }
  xadj[n] = edge;
  return edge;
}

}  // extern "C"
