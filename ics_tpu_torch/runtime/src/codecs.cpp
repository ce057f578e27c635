// Copied from ics_tpu/runtime/src/codecs.cpp (unchanged below this note). The port
// builds it at first use: ics_tpu_torch/runtime/_lib.py.
//
// Native codec library for the ICS-TPU host runtime.
//
// Counterpart of the reference's hand-written CPython extension of TIFF
// decoders (ref lib/tifffile.c: py_decodepackbits:550, py_decodelzw:658).
// Plain C ABI (bound from Python via ctypes) instead of the CPython API so
// the library is interpreter-version independent and usable from any host
// tool.  Both decoders are single-pass, branch-light and allocation-free.

#include <cstdint>
#include <cstring>

#define ICS_API __attribute__((visibility("default")))

extern "C" {

// Apple PackBits decompression.  Returns bytes written, or -1 on overflow.
ICS_API long long ics_decode_packbits(const unsigned char* src, long long srclen,
                              unsigned char* dst, long long dstlen) {
  long long i = 0, o = 0;
  while (i < srclen && o < dstlen) {
    const unsigned char h = src[i++];
    if (h < 128) {  // literal run of h+1 bytes
      const long long n = h + 1;
      if (i + n > srclen || o + n > dstlen) {
        const long long take_in = srclen - i;
        const long long take = take_in < dstlen - o ? take_in : dstlen - o;
        std::memcpy(dst + o, src + i, static_cast<size_t>(take));
        return o + take;
      }
      std::memcpy(dst + o, src + i, static_cast<size_t>(n));
      i += n;
      o += n;
    } else if (h > 128) {  // replicate next byte 257-h times
      if (i >= srclen) break;
      long long n = 257 - h;
      if (o + n > dstlen) n = dstlen - o;
      std::memset(dst + o, src[i++], static_cast<size_t>(n));
      o += n;
    }  // h == 128: no-op
  }
  return o;
}

// TIFF-variant LZW: MSB-first bit packing, 9->12 bit codes with the
// "early change" (code width bumps one entry before the table fills).
// Returns bytes written, or -1 on malformed input.
ICS_API long long ics_decode_lzw(const unsigned char* src, long long srclen,
                         unsigned char* dst, long long dstlen) {
  constexpr int kClear = 256, kEoi = 257, kMaxCodes = 4096;
  // Table as (prefix link, final byte, depth); entry strings are
  // materialized by walking links backwards into a scratch buffer.
  static thread_local int prefix[kMaxCodes];
  static thread_local unsigned char final_byte[kMaxCodes];
  static thread_local int depth[kMaxCodes];
  unsigned char scratch[kMaxCodes];

  int next_code = 258;
  int nbits = 9;
  long long bitpos = 0;
  const long long total_bits = srclen * 8;
  long long o = 0;
  int prev = -1;

  auto reset = [&]() {
    next_code = 258;
    nbits = 9;
    prev = -1;
  };
  for (int c = 0; c < 256; ++c) {
    prefix[c] = -1;
    final_byte[c] = static_cast<unsigned char>(c);
    depth[c] = 1;
  }

  auto emit = [&](int code) -> long long {
    // Walk the prefix chain last-byte-first into scratch, keeping only the
    // leading `d` bytes when the output buffer truncates the string.
    int d = depth[code];
    if (o + d > dstlen) d = static_cast<int>(dstlen - o);
    int c = code;
    for (int k = depth[code] - 1; k >= 0; --k) {
      if (k < d) scratch[k] = final_byte[c];
      c = prefix[c];
    }
    std::memcpy(dst + o, scratch, static_cast<size_t>(d));
    o += d;
    return d;
  };

  while (bitpos + nbits <= total_bits && o < dstlen) {
    const long long byte0 = bitpos >> 3;
    uint32_t chunk = 0;
    for (int b = 0; b < 4; ++b) {
      chunk = (chunk << 8) |
              (byte0 + b < srclen ? src[byte0 + b] : 0u);
    }
    const int shift = 32 - static_cast<int>(bitpos & 7) - nbits;
    const int code = (chunk >> shift) & ((1 << nbits) - 1);
    bitpos += nbits;

    if (code == kEoi) break;
    if (code == kClear) {
      reset();
      continue;
    }
    if (prev < 0) {
      if (code >= 256) return -1;
      emit(code);
      prev = code;
      continue;
    }
    if (code < next_code) {
      if (next_code < kMaxCodes) {
        prefix[next_code] = prev;
        // first byte of `code`'s string:
        int c = code;
        while (prefix[c] >= 0) c = prefix[c];
        final_byte[next_code] = final_byte[c];
        depth[next_code] = depth[prev] + 1;
        ++next_code;
      }
      emit(code);
      prev = code;
    } else if (code == next_code && next_code < kMaxCodes) {
      // KwKwK case: new entry = prev + first(prev)
      int c = prev;
      while (prefix[c] >= 0) c = prefix[c];
      prefix[next_code] = prev;
      final_byte[next_code] = final_byte[c];
      depth[next_code] = depth[prev] + 1;
      ++next_code;
      emit(code);
      prev = code;
    } else {
      return -1;  // malformed stream
    }
    // Early change (libtiff convention, validated against its streams):
    // the decoder widens after inserting entry 2^nbits - 1.
    if (next_code + 1 >= (1 << nbits) && nbits < 12) ++nbits;
  }
  return o;
}

// Apple PackBits compression.  Returns bytes written, or -1 on overflow.
ICS_API long long ics_encode_packbits(const unsigned char* src, long long srclen,
                                      unsigned char* dst, long long dstlen) {
  long long i = 0, o = 0;
  while (i < srclen) {
    // find run length at i
    long long run = 1;
    while (i + run < srclen && run < 128 && src[i + run] == src[i]) ++run;
    if (run >= 2) {
      if (o + 2 > dstlen) return -1;
      dst[o++] = static_cast<unsigned char>(257 - run);
      dst[o++] = src[i];
      i += run;
    } else {
      // literal run: until the next >=3 replicate run (2-byte runs are
      // cheaper folded into literals) or 128 bytes
      long long j = i + 1;
      while (j < srclen && j - i < 128) {
        long long r = 1;
        while (j + r < srclen && r < 3 && src[j + r] == src[j]) ++r;
        if (r >= 3) break;
        ++j;
      }
      const long long n = j - i;
      if (o + 1 + n > dstlen) return -1;
      dst[o++] = static_cast<unsigned char>(n - 1);
      std::memcpy(dst + o, src + i, static_cast<size_t>(n));
      o += n;
      i = j;
    }
  }
  return o;
}

// TIFF-variant LZW compression (MSB-first, 9->12 bit, early change),
// the inverse of ics_decode_lzw.  Returns bytes written, or -1 on overflow.
ICS_API long long ics_encode_lzw(const unsigned char* src, long long srclen,
                                 unsigned char* dst, long long dstlen) {
  constexpr int kClear = 256, kEoi = 257;
  constexpr int kHSize = 9001;  // prime > 4096, libtiff-style open hash
  static thread_local int hcode[kHSize];   // table code at slot
  static thread_local int hkey[kHSize];    // (prefix<<8)|byte at slot

  long long o = 0;
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  int nbits = 9;
  int next_code = 258;

  auto put = [&](int code) -> bool {
    bitbuf = (bitbuf << nbits) | static_cast<uint32_t>(code);
    bitcnt += nbits;
    while (bitcnt >= 8) {
      if (o >= dstlen) return false;
      dst[o++] = static_cast<unsigned char>((bitbuf >> (bitcnt - 8)) & 0xff);
      bitcnt -= 8;
    }
    return true;
  };
  auto reset_table = [&]() {
    for (int s = 0; s < kHSize; ++s) hcode[s] = -1;
    next_code = 258;
    nbits = 9;
  };

  reset_table();
  if (!put(kClear)) return -1;
  if (srclen == 0) {
    if (!put(kEoi)) return -1;
  } else {
    int cur = src[0];
    for (long long i = 1; i < srclen; ++i) {
      const int b = src[i];
      const int key = (cur << 8) | b;
      // open-addressing lookup
      int slot = key % kHSize;
      int found = -1;
      while (hcode[slot] != -1) {
        if (hkey[slot] == key) { found = hcode[slot]; break; }
        if (++slot == kHSize) slot = 0;
      }
      if (found >= 0) {
        cur = found;
        continue;
      }
      if (!put(cur)) return -1;
      hkey[slot] = key;
      hcode[slot] = next_code++;
      cur = b;
      // Early change (libtiff convention): the encoder runs one table
      // entry ahead of the decoder, so it widens after inserting entry
      // 2^nbits — the mirror of the decoder's 2^nbits - 1 bump.
      if (next_code >= (1 << nbits) && nbits < 12) ++nbits;
      if (next_code >= 4094) {  // keep one slot below EOI overflow
        if (!put(kClear)) return -1;
        reset_table();
      }
    }
    if (!put(cur)) return -1;
    if (!put(kEoi)) return -1;
  }
  if (bitcnt > 0) {  // flush remaining bits, zero-padded
    if (o >= dstlen) return -1;
    dst[o++] = static_cast<unsigned char>((bitbuf << (8 - bitcnt)) & 0xff);
  }
  return o;
}

}  // extern "C"
