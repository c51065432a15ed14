// One LZMA2 dict-reset segment, decoded into a flat output buffer.
//
// The one segment decoder of the repo: the CUDA kernel (segment_cuda.cu,
// one segment per thread), the CPU XLA FFI handler (segment_cpu.cc) and
// the native host engine (lzma_native.cpp, lrt_lzma2_decode_segment) all
// compile this header, so a fix to the symbol loop lands in every engine
// at once. It has no allocation, no exceptions and no strings: an error is
// a numeric code, and the runtime replays the stream sequentially on the
// host to produce the reference's exact message.
//
// Semantics: one chunk decodes until the output reaches its declared end;
// every input byte read is bounds checked; matches are checked against
// the output written so far, the dictionary limit and the chunk end. An
// LZMA2 chunk must also end its range coder exactly at its packed end:
// the reference reads the next chunk header where the range coder
// stopped, so a chunk that stops early is a different (corrupt) stream,
// and the host replays it.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define LRT_HD __host__ __device__ inline
#else
#define LRT_HD inline
#endif

namespace lrt_seg {

// Error codes (0 = ok). Any nonzero code sends the stream to host replay.
enum : int32_t {
  kOk = 0,
  kErrShort = 1,     // chunk shorter than the 5-byte range-coder init
  kErrEof = 2,       // input exhausted inside a chunk
  kErrDistance = 3,  // distance beyond the output written or the dictionary
  kErrSize = 4,      // a symbol would pass the chunk's declared end
  kErrEos = 5,       // end-of-stream marker inside a sized chunk
  kErrTable = 6,     // chunk table outside the input or output buffer
  kErrEnd = 7,       // range coder stopped before the chunk's packed end
};

// One chunk of a segment. Input offsets are absolute in the segment's
// input buffer, output offsets relative to the segment's output. `Off`
// is uint32_t on the card (the device table's rows are 8 int32 fields,
// laid out as Chunk<uint32_t>) and uint64_t in the host engine. flags:
// kResetState (reset the probabilities, state and reps first) |
// kExactEnd (LZMA2: the range coder must stop at in_end).
template <typename Off>
struct Chunk {
  Off in_start, in_end, out_start, out_end;
  int32_t flags, lc, lp, pb;
};
constexpr int kChunkFields = 8;  // int32 fields of one device table row
static_assert(sizeof(Chunk<uint32_t>) == kChunkFields * sizeof(int32_t),
              "device chunk rows are Chunk<uint32_t>");
enum : int32_t { kResetState = 1, kExactEnd = 2 };

// Probability layout: the fixed-size tables first, then the literal
// tables, so every offset but the literal count is a constant.
constexpr uint32_t kIsMatch = 0;        // 12 states x 16 pos states
constexpr uint32_t kIsRep = 192;        // 12
constexpr uint32_t kIsRepG0 = 204;      // 12
constexpr uint32_t kIsRepG1 = 216;      // 12
constexpr uint32_t kIsRepG2 = 228;      // 12
constexpr uint32_t kIsRep0Long = 240;   // 192
constexpr uint32_t kPosSlot = 432;      // 4 x 64
constexpr uint32_t kSpecPos = 688;      // 115 (reverse trees, slots 4..13)
constexpr uint32_t kAlign = 803;        // 16
constexpr uint32_t kLenCoder = 819;     // 514
constexpr uint32_t kRepLenCoder = 1333; // 514
constexpr uint32_t kLiteral = 1848;     // (0x300 << (lc + lp))
constexpr uint32_t kLenChoice = 0, kLenChoice2 = 1, kLenLow = 2,
                   kLenMid = 2 + 128, kLenHigh = 2 + 256;

LRT_HD uint32_t probs_count(int lclp) { return kLiteral + (0x300u << lclp); }

// Decodes the `n` chunks of one segment from `in` (`in_size` bytes)
// into `out` (`out_cap` bytes writable). `probs` has room for
// probs_count(lc + lp) entries of the segment's largest lc + lp.
// `dict_limit` bounds match distances (raw LZMA); LZMA2 passes the
// largest Off.
template <typename Off>
LRT_HD int32_t decode_segment(const uint8_t* in, Off in_size,
                              const Chunk<Off>* chunks, int n, uint8_t* out,
                              Off out_cap, Off dict_limit, uint16_t* probs) {
  uint32_t state = 0, r0 = 0, r1 = 0, r2 = 0, r3 = 0;
  uint32_t probs_ready = 0;  // entries initialised at the last reset
  for (int ci = 0; ci < n; ci++) {
    const Chunk<Off>& c = chunks[ci];
    Off ipos = c.in_start;
    const Off iend = c.in_end;
    Off opos = c.out_start;
    const Off oend = c.out_end;
    if (iend > in_size || ipos > iend || oend > out_cap || opos > oend)
      return kErrTable;
    if (iend - ipos < 5) return kErrShort;
    const int lc = c.lc, lp = c.lp, pb = c.pb;
    if (lc < 0 || lp < 0 || pb < 0 || lc > 8 || lp > 4 || pb > 4 ||
        lc + lp > 4)
      return kErrTable;
    const uint32_t need = probs_count(lc + lp);
    if ((c.flags & kResetState) || ci == 0) {
      for (uint32_t i = 0; i < need; i++) probs[i] = 0x400;
      probs_ready = need;
      state = 0;
      r0 = r1 = r2 = r3 = 0;
    } else if (need > probs_ready) {
      return kErrTable;  // props grew without a state reset
    }
    uint32_t range = 0xFFFFFFFFu;
    uint32_t code = (uint32_t(in[ipos + 1]) << 24) |
                    (uint32_t(in[ipos + 2]) << 16) |
                    (uint32_t(in[ipos + 3]) << 8) | uint32_t(in[ipos + 4]);
    ipos += 5;
    uint16_t* const P = probs;
    uint16_t* const Plit = probs + kLiteral;
    const uint32_t pbmask = (1u << pb) - 1, lpmask = (1u << lp) - 1;
    // the last byte written, kept in a register: a literal's context
    // would otherwise re-read the output (device memory on the card)
    uint32_t prev = opos ? out[opos - 1] : 0;

#define LRT_NORM()                                  \
  do {                                              \
    if (range < 0x01000000u) {                      \
      if (ipos >= iend) return kErrEof;             \
      range <<= 8;                                  \
      code = (code << 8) | uint32_t(in[ipos++]);    \
    }                                               \
  } while (0)
#define LRT_BIT(probp, bitvar)                      \
  do {                                              \
    uint16_t* pp_ = (probp);                        \
    const uint32_t pv_ = *pp_;                      \
    const uint32_t bound_ = (range >> 11) * pv_;    \
    if (code < bound_) {                            \
      range = bound_;                               \
      *pp_ = uint16_t(pv_ + ((0x800u - pv_) >> 5)); \
      bitvar = 0;                                   \
    } else {                                        \
      code -= bound_;                               \
      range -= bound_;                              \
      *pp_ = uint16_t(pv_ - (pv_ >> 5));            \
      bitvar = 1;                                   \
    }                                               \
    LRT_NORM();                                     \
  } while (0)
#define LRT_TREE(base, nbits, acc)                  \
  do {                                              \
    acc = 1;                                        \
    for (int i_ = 0; i_ < (nbits); i_++) {          \
      uint32_t b_;                                  \
      LRT_BIT(&(base)[acc], b_);                    \
      acc = (acc << 1) | b_;                        \
    }                                               \
    acc -= 1u << (nbits);                           \
  } while (0)

    while (opos < oend) {
      const uint32_t pos_state = opos & pbmask;
      uint32_t bit;
      LRT_BIT(&P[kIsMatch + (state << 4) + pos_state], bit);
      if (!bit) {
        // literal
        uint16_t* const pl =
            Plit + (((opos & lpmask) << lc) + (prev >> (8 - lc))) * 0x300;
        uint32_t sym = 1;
        if (state >= 7) {
          const uint32_t dist = r0 + 1;
          if (dist > dict_limit || dist > opos) return kErrDistance;
          uint32_t match_byte = out[opos - dist];
          do {
            const uint32_t match_bit = (match_byte >> 7) & 1;
            match_byte <<= 1;
            LRT_BIT(&pl[((1 + match_bit) << 8) + sym], bit);
            sym = (sym << 1) | bit;
            if (match_bit != bit) break;
          } while (sym < 0x100);
        }
        while (sym < 0x100) {
          LRT_BIT(&pl[sym], bit);
          sym = (sym << 1) | bit;
        }
        prev = sym & 0xFF;
        out[opos++] = uint8_t(prev);
        state = state < 4 ? 0 : (state < 10 ? state - 3 : state - 6);
        continue;
      }
      uint32_t len;
      LRT_BIT(&P[kIsRep + state], bit);
      if (bit) {
        LRT_BIT(&P[kIsRepG0 + state], bit);
        if (!bit) {
          LRT_BIT(&P[kIsRep0Long + (state << 4) + pos_state], bit);
          if (!bit) {
            // short rep: one byte at rep0
            state = state < 7 ? 9 : 11;
            const uint32_t dist = r0 + 1;
            if (dist > dict_limit || dist > opos) return kErrDistance;
            prev = out[opos - dist];
            out[opos++] = uint8_t(prev);
            continue;
          }
        } else {
          uint32_t dist;
          LRT_BIT(&P[kIsRepG1 + state], bit);
          if (!bit) {
            dist = r1;
          } else {
            LRT_BIT(&P[kIsRepG2 + state], bit);
            if (!bit) {
              dist = r2;
            } else {
              dist = r3;
              r3 = r2;
            }
            r2 = r1;
          }
          r1 = r0;
          r0 = dist;
        }
        uint16_t* const B = P + kRepLenCoder;
        LRT_BIT(&B[kLenChoice], bit);
        if (!bit) {
          LRT_TREE(B + kLenLow + pos_state * 8, 3, len);
        } else {
          LRT_BIT(&B[kLenChoice2], bit);
          if (!bit) {
            LRT_TREE(B + kLenMid + pos_state * 8, 3, len);
            len += 8;
          } else {
            LRT_TREE(B + kLenHigh, 8, len);
            len += 16;
          }
        }
        state = state < 7 ? 8 : 11;
      } else {
        // new distance
        r3 = r2;
        r2 = r1;
        r1 = r0;
        uint16_t* const B = P + kLenCoder;
        LRT_BIT(&B[kLenChoice], bit);
        if (!bit) {
          LRT_TREE(B + kLenLow + pos_state * 8, 3, len);
        } else {
          LRT_BIT(&B[kLenChoice2], bit);
          if (!bit) {
            LRT_TREE(B + kLenMid + pos_state * 8, 3, len);
            len += 8;
          } else {
            LRT_TREE(B + kLenHigh, 8, len);
            len += 16;
          }
        }
        state = state < 7 ? 7 : 10;
        const uint32_t len_state = len > 3 ? 3 : len;
        uint32_t slot;
        LRT_TREE(P + kPosSlot + len_state * 64, 6, slot);
        if (slot < 4) {
          r0 = slot;
        } else {
          const int ndb = int(slot >> 1) - 1;
          uint32_t dist = (2u | (slot & 1)) << ndb;
          if (slot < 14) {
            uint16_t* const sp = P + kSpecPos + (dist - slot);
            uint32_t t = 1;
            for (int i = 0; i < ndb; i++) {
              LRT_BIT(&sp[t], bit);
              t = (t << 1) | bit;
              dist += bit << i;
            }
          } else {
            uint32_t direct = 0;
            for (int i = 0; i < ndb - 4; i++) {
              range >>= 1;
              code -= range;
              const uint32_t mask = 0u - (code >> 31);
              code += range & mask;
              direct = (direct << 1) + (mask + 1);
              LRT_NORM();
            }
            dist += direct << 4;
            uint32_t t = 1;
            for (int i = 0; i < 4; i++) {
              LRT_BIT(&P[kAlign + t], bit);
              t = (t << 1) | bit;
              dist += bit << i;
            }
          }
          if (dist == 0xFFFFFFFFu) return kErrEos;
          r0 = dist;
        }
      }
      len += 2;
      const uint32_t dist = r0 + 1;
      if (dist > dict_limit || dist > opos) return kErrDistance;
      if (len > oend - opos) return kErrSize;
      uint8_t* dst = out + opos;
      const uint8_t* src = dst - dist;
      uint32_t i = 0;
      if (dist >= 8) {
        // no overlap within 8 bytes: issue 8 loads before their stores,
        // so their latencies overlap instead of adding up
        for (; i + 8 <= len; i += 8) {
          uint8_t b[8];
          for (int k = 0; k < 8; k++) b[k] = src[i + k];
          for (int k = 0; k < 8; k++) dst[i + k] = b[k];
          prev = b[7];
        }
      }
      for (; i < len; i++) {
        prev = src[i];
        dst[i] = uint8_t(prev);
      }
      opos += len;
    }
#undef LRT_TREE
#undef LRT_BIT
#undef LRT_NORM
    if ((c.flags & kExactEnd) && ipos != iend) return kErrEnd;
  }
  return kOk;
}

}  // namespace lrt_seg
