// Native host runtime: TeraPart-parity neighborhood codec ("v2").
//
// The reference's compressed neighborhoods combine gap coding with
// interval encoding for runs of consecutive ids and an SIMD StreamVByte
// batch codec (kaminpar-common/graph_compression/
// compressed_neighborhoods.h:52-60, streamvbyte.h, varint.h), plus
// interleaved varint edge weights.  This file is the framework's native
// equivalent, one stream per node:
//
//   varint(num_intervals)
//   per interval: varint(delta_left), varint(len - MIN_INTERVAL)
//     (left endpoints gap-coded against the previous interval's end;
//      first one biased +1)
//   per residual group of 4: one control byte (2 bits per value =
//     byte length 1..4), then the packed value bytes — the StreamVByte
//     wire idea in scalar form (gaps: first residual biased +1, then
//     diffs against the previous residual)
//
// Edge weights ride in a SEPARATE varint stream in EMIT order (interval
// members first, then residuals), so decoded adjacency and weights pair
// 1:1.  The reference's high-degree split exists to parallelize decode
// across threads; bulk decode here is a single native pass, so the split
// is unnecessary — degree skew costs nothing.
//
// C ABI consumed via ctypes (kaminpar_tpu/native/__init__.py).

#include <cstdint>
#include <cstring>

#if defined(__SSSE3__)
#include <tmmintrin.h>
#endif

namespace {

#if defined(__SSSE3__)
// StreamVByte SIMD decode tables (streamvbyte.h parity): for each
// control byte, a pshufb mask scattering the packed 1..4-byte values
// into four u32 lanes, and the group's total payload length.
struct SvbTables {
  alignas(16) uint8_t shuf[256][16];
  uint8_t len[256];
};

inline const SvbTables& svb_tables() {
  static const SvbTables t = [] {
    SvbTables t{};
    for (int c = 0; c < 256; ++c) {
      int pos = 0;
      for (int i = 0; i < 4; ++i) {
        const int l = ((c >> (2 * i)) & 3) + 1;
        for (int b = 0; b < 4; ++b)
          t.shuf[c][4 * i + b] =
              b < l ? (uint8_t)(pos + b) : (uint8_t)0xFF;
        pos += l;
      }
      t.len[c] = (uint8_t)pos;
    }
    return t;
  }();
  return t;
}
#endif

constexpr int64_t MIN_INTERVAL = 3;  // compressed_neighborhoods interval
                                     // length threshold

inline int varint_size64(uint64_t x) {
  int s = 1;
  while (x >= 0x80) {
    x >>= 7;
    ++s;
  }
  return s;
}

inline uint8_t* varint_write64(uint8_t* p, uint64_t x) {
  while (x >= 0x80) {
    *p++ = (uint8_t)(x | 0x80);
    x >>= 7;
  }
  *p++ = (uint8_t)x;
  return p;
}

inline const uint8_t* varint_read64(const uint8_t* p, uint64_t* out) {
  uint64_t x = 0;
  int shift = 0;
  while (true) {
    const uint8_t b = *p++;
    x |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  *out = x;
  return p;
}

inline int svb_len(uint32_t x) {
  return x < (1u << 8) ? 1 : x < (1u << 16) ? 2 : x < (1u << 24) ? 3 : 4;
}

// walk one sorted neighborhood, classifying runs >= MIN_INTERVAL as
// intervals; calls iv(left, len) then res(value) per residual
template <class IvFn, class ResFn>
inline void walk(const int32_t* nb, int64_t deg, IvFn&& iv, ResFn&& res) {
  int64_t i = 0;
  while (i < deg) {
    int64_t j = i + 1;
    while (j < deg && nb[j] == nb[j - 1] + 1) ++j;
    if (j - i >= MIN_INTERVAL)
      iv((uint32_t)nb[i], (uint32_t)(j - i));
    else
      for (int64_t t = i; t < j; ++t) res((uint32_t)nb[t]);
    i = j;
  }
}

}  // namespace

extern "C" {

// sizes pass: fills offsets[n+1] (byte offsets per node), returns total
int64_t kmp_encode_v2_size(int64_t n, const int64_t* xadj,
                           const int32_t* adjncy, int64_t* offsets) {
  int64_t total = 0;
  for (int64_t u = 0; u < n; ++u) {
    offsets[u] = total;
    const int32_t* nb = adjncy + xadj[u];
    const int64_t deg = xadj[u + 1] - xadj[u];
    if (deg == 0) continue;
    int64_t n_iv = 0, sz_iv = 0, n_res = 0, sz_res = 0;
    uint32_t prev_end = 0;  // bias handled below
    bool first_iv = true;
    uint32_t prev_res = 0;
    bool first_res = true;
    walk(
        nb, deg,
        [&](uint32_t left, uint32_t len) {
          const uint32_t delta =
              first_iv ? left + 1 : left - prev_end;
          sz_iv += varint_size64(delta) +
                   varint_size64(len - MIN_INTERVAL);
          prev_end = left + len - 1;
          first_iv = false;
          ++n_iv;
        },
        [&](uint32_t v) {
          const uint32_t gap = first_res ? v + 1 : v - prev_res;
          sz_res += svb_len(gap);
          prev_res = v;
          first_res = false;
          ++n_res;
        });
    total += varint_size64((uint64_t)n_iv) + sz_iv;
    total += (n_res + 3) / 4 + sz_res;  // control bytes + data
  }
  offsets[n] = total;
  return total;
}

void kmp_encode_v2(int64_t n, const int64_t* xadj, const int32_t* adjncy,
                   const int64_t* offsets, uint8_t* out) {
  for (int64_t u = 0; u < n; ++u) {
    uint8_t* p = out + offsets[u];
    const int32_t* nb = adjncy + xadj[u];
    const int64_t deg = xadj[u + 1] - xadj[u];
    if (deg == 0) continue;
    // pass 1: collect interval/residual split
    int64_t n_iv = 0;
    walk(nb, deg, [&](uint32_t, uint32_t) { ++n_iv; }, [&](uint32_t) {});
    p = varint_write64(p, (uint64_t)n_iv);
    uint32_t prev_end = 0;
    bool first_iv = true;
    // residual staging (gaps)
    uint32_t gaps[4];
    int ngap = 0;
    uint32_t prev_res = 0;
    bool first_res = true;
    // control/data write positions: count residuals first
    int64_t n_res = 0;
    walk(nb, deg, [&](uint32_t, uint32_t) {}, [&](uint32_t) { ++n_res; });
    // write intervals
    walk(
        nb, deg,
        [&](uint32_t left, uint32_t len) {
          const uint32_t delta = first_iv ? left + 1 : left - prev_end;
          p = varint_write64(p, delta);
          p = varint_write64(p, len - MIN_INTERVAL);
          prev_end = left + len - 1;
          first_iv = false;
        },
        [&](uint32_t) {});
    // write residuals: control bytes interleaved per group of 4
    uint8_t* ctrl = p;
    uint8_t* data = p + (n_res + 3) / 4;
    auto flush = [&]() {
      if (ngap == 0) return;
      uint8_t c = 0;
      for (int i = 0; i < ngap; ++i) {
        const int len = svb_len(gaps[i]);
        c |= (uint8_t)(len - 1) << (2 * i);
        for (int b = 0; b < len; ++b) {
          *data++ = (uint8_t)(gaps[i] & 0xFF);
          gaps[i] >>= 8;
        }
      }
      *ctrl++ = c;
      ngap = 0;
    };
    walk(
        nb, deg, [&](uint32_t, uint32_t) {},
        [&](uint32_t v) {
          const uint32_t gap = first_res ? v + 1 : v - prev_res;
          prev_res = v;
          first_res = false;
          gaps[ngap++] = gap;
          if (ngap == 4) flush();
        });
    flush();
  }
}

// decode ALL neighborhoods; out must hold xadj[n] entries.  Neighbors
// are emitted interval-members-first (matching the weight stream order).
void kmp_decode_v2(int64_t n, const int64_t* xadj, const int64_t* offsets,
                   const uint8_t* data, int32_t* out) {
  for (int64_t u = 0; u < n; ++u) {
    const uint8_t* p = data + offsets[u];
    const int64_t deg = xadj[u + 1] - xadj[u];
    if (deg == 0) continue;
    int32_t* o = out + xadj[u];
    uint64_t n_iv;
    p = varint_read64(p, &n_iv);
    uint32_t prev_end = 0;
    int64_t emitted = 0;
    for (uint64_t i = 0; i < n_iv; ++i) {
      uint64_t delta, lenm;
      p = varint_read64(p, &delta);
      p = varint_read64(p, &lenm);
      const uint32_t left = (i == 0) ? (uint32_t)delta - 1
                                     : prev_end + (uint32_t)delta;
      const uint32_t len = (uint32_t)lenm + MIN_INTERVAL;
      for (uint32_t t = 0; t < len; ++t) *o++ = (int32_t)(left + t);
      prev_end = left + len - 1;
      emitted += len;
    }
    const int64_t n_res = deg - emitted;
    const uint8_t* ctrl = p;
    const uint8_t* d = p + (n_res + 3) / 4;
    uint32_t prev = 0;
    int64_t i = 0;
#if defined(__SSSE3__)
    if (n_res >= 8) {
      const SvbTables& T = svb_tables();
      // exact payload size from the control stream bounds the 16-byte
      // loads.  The final PARTIAL group must be summed field-by-field:
      // its unused 2-bit controls are zero, which T.len would count as
      // 1 byte each — overshooting the true buffer end by up to 3
      // bytes and letting the last SIMD load read past the allocation.
      const int64_t nfull = n_res / 4;
      int64_t payload = 0;
      for (int64_t g = 0; g < nfull; ++g) payload += T.len[ctrl[g]];
      for (int64_t r = 4 * nfull; r < n_res; ++r)
        payload += ((ctrl[r >> 2] >> (2 * (r & 3))) & 3) + 1;
      const uint8_t* d_end = d + payload;
      // group 0 scalar: the first-residual bias lives there
      for (; i < 4; ++i) {
        const int len = ((ctrl[0] >> (2 * i)) & 3) + 1;
        uint32_t v = 0;
        for (int b = 0; b < len; ++b) v |= (uint32_t)(*d++) << (8 * b);
        prev = (i == 0) ? v - 1 : prev + v;
        *o++ = (int32_t)prev;
      }
      // full groups: one pshufb + two shifted adds (in-register prefix
      // sum of the gaps) per 4 values — the streamvbyte.h decode shape
      __m128i vprev = _mm_set1_epi32((int)prev);
      while (i + 4 <= n_res && d + 16 <= d_end) {
        const uint8_t c = ctrl[i >> 2];
        const __m128i raw = _mm_loadu_si128((const __m128i*)d);
        __m128i gaps = _mm_shuffle_epi8(
            raw, _mm_load_si128((const __m128i*)T.shuf[c]));
        gaps = _mm_add_epi32(gaps, _mm_slli_si128(gaps, 4));
        gaps = _mm_add_epi32(gaps, _mm_slli_si128(gaps, 8));
        const __m128i vals = _mm_add_epi32(gaps, vprev);
        _mm_storeu_si128((__m128i*)o, vals);
        o += 4;
        vprev = _mm_shuffle_epi32(vals, _MM_SHUFFLE(3, 3, 3, 3));
        d += T.len[c];
        i += 4;
      }
      prev = (uint32_t)_mm_cvtsi128_si32(vprev);
    }
#endif
    for (; i < n_res; ++i) {
      const int len = ((ctrl[i >> 2] >> (2 * (i & 3))) & 3) + 1;
      uint32_t v = 0;
      for (int b = 0; b < len; ++b) v |= (uint32_t)(*d++) << (8 * b);
      prev = (i == 0) ? v - 1 : prev + v;
      *o++ = (int32_t)prev;
    }
  }
}

int64_t kmp_decode_v2_node(int64_t u, const int64_t* xadj,
                           const int64_t* offsets, const uint8_t* data,
                           int32_t* out) {
  int64_t x2[2] = {0, xadj[u + 1] - xadj[u]};
  int64_t o2[2] = {0, 0};
  kmp_decode_v2(1, x2, o2, data + offsets[u], out);
  return x2[1];
}

// edge weights in EMIT order, varint per edge
int64_t kmp_encode_v2_weights_size(int64_t n, const int64_t* xadj,
                                   const int32_t* adjncy,
                                   const int64_t* edge_w,
                                   int64_t* woffsets) {
  int64_t total = 0;
  for (int64_t u = 0; u < n; ++u) {
    woffsets[u] = total;
    const int32_t* nb = adjncy + xadj[u];
    const int64_t deg = xadj[u + 1] - xadj[u];
    const int64_t* w = edge_w + xadj[u];
    // emit order: walk twice (intervals, then residuals), tracking the
    // source position of each neighbor
    int64_t pos = 0;
    walk(
        nb, deg,
        [&](uint32_t, uint32_t len) {
          for (uint32_t t = 0; t < len; ++t)
            total += varint_size64((uint64_t)w[pos++]);
        },
        [&](uint32_t) { ++pos; });
    // second pass for residual positions
    pos = 0;
    walk(
        nb, deg,
        [&](uint32_t, uint32_t len) { pos += len; },
        [&](uint32_t) { total += varint_size64((uint64_t)w[pos++]); });
  }
  woffsets[n] = total;
  return total;
}

void kmp_encode_v2_weights(int64_t n, const int64_t* xadj,
                           const int32_t* adjncy, const int64_t* edge_w,
                           const int64_t* woffsets, uint8_t* out) {
  for (int64_t u = 0; u < n; ++u) {
    uint8_t* p = out + woffsets[u];
    const int32_t* nb = adjncy + xadj[u];
    const int64_t deg = xadj[u + 1] - xadj[u];
    const int64_t* w = edge_w + xadj[u];
    int64_t pos = 0;
    walk(
        nb, deg,
        [&](uint32_t, uint32_t len) {
          for (uint32_t t = 0; t < len; ++t)
            p = varint_write64(p, (uint64_t)w[pos++]);
        },
        [&](uint32_t) { ++pos; });
    pos = 0;
    walk(
        nb, deg,
        [&](uint32_t, uint32_t len) { pos += len; },
        [&](uint32_t) { p = varint_write64(p, (uint64_t)w[pos++]); });
  }
}

void kmp_decode_v2_weights(int64_t n, const int64_t* xadj,
                           const int64_t* woffsets, const uint8_t* data,
                           int64_t* out) {
  for (int64_t u = 0; u < n; ++u) {
    const uint8_t* p = data + woffsets[u];
    const int64_t deg = xadj[u + 1] - xadj[u];
    int64_t* o = out + xadj[u];
    for (int64_t i = 0; i < deg; ++i) {
      uint64_t v;
      p = varint_read64(p, &v);
      *o++ = (int64_t)v;
    }
  }
}

}  // extern "C"
