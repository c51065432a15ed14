// XLA FFI handler "lrt_segment_decode" for the CPU platform.
//
// Same operands, results and attribute as the CUDA handler
// (segment_cuda.cu); lanes run one after another through the shared
// decode core (lzma_segment.h). It exists so that the CPU tests run the
// device engine's decode logic and its staging through the same
// jax.ffi.ffi_call as the card.

#include <cstring>

#include "lzma_segment.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

ffi::Error SegmentDecodeCpu(ffi::Buffer<ffi::U8> in,
                            ffi::Buffer<ffi::S32> chunks,
                            ffi::Buffer<ffi::S32> lanes,
                            ffi::Buffer<ffi::S32> prefill,
                            ffi::ResultBuffer<ffi::U8> out,
                            ffi::ResultBuffer<ffi::S32> err,
                            ffi::ResultBuffer<ffi::U16> scratch,
                            int32_t nprobs) {
  const int64_t L = lanes.dimensions()[0];
  const int64_t K = chunks.dimensions()[1];
  const int64_t P = prefill.dimensions()[0];
  const uint32_t in_size = uint32_t(in.element_count());
  const uint32_t out_size = uint32_t(out->element_count());
  if (scratch->element_count() < size_t(nprobs))
    return ffi::Error::InvalidArgument("scratch smaller than one lane");
  const uint8_t* src = in.typed_data();
  uint8_t* dst = out->typed_data();
  const int32_t* pf = prefill.typed_data();
  for (int64_t i = 0; i < P; i++) {
    const int32_t s = pf[3 * i], d = pf[3 * i + 1], n = pf[3 * i + 2];
    if (n <= 0) continue;
    if (s < 0 || d < 0 || uint32_t(s) + uint32_t(n) > in_size ||
        uint32_t(d) + uint32_t(n) > out_size)
      return ffi::Error::InvalidArgument("prefill entry out of bounds");
    std::memcpy(dst + d, src + s, size_t(n));
  }
  const int32_t* ln = lanes.typed_data();
  int32_t* e = err->typed_data();
  uint16_t* probs = scratch->typed_data();
  for (int64_t l = 0; l < L; l++) {
    const int32_t n = ln[3 * l], base = ln[3 * l + 1];
    if (n == 0) {
      e[l] = lrt_seg::kOk;
      continue;
    }
    if (base < 0 || uint32_t(base) > out_size) {
      e[l] = lrt_seg::kErrTable;
      continue;
    }
    e[l] = lrt_seg::decode_segment<uint32_t>(
        src, in_size,
        reinterpret_cast<const lrt_seg::Chunk<uint32_t>*>(
            chunks.typed_data() + l * K * lrt_seg::kChunkFields),
        n, dst + base, out_size - uint32_t(base), uint32_t(ln[3 * l + 2]),
        probs);
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(LrtSegmentDecodeCpu, SegmentDecodeCpu,
                              ffi::Ffi::Bind()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U16>>()
                                  .Attr<int32_t>("nprobs"));
