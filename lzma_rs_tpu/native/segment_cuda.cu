// XLA FFI handler "lrt_segment_decode" for CUDA: the device engine.
//
// One LZMA2 dict-reset segment per thread. The serial range-coder loop
// runs in that thread through the shared decode core (lzma_segment.h),
// with real branches; the window is the flat output in device memory,
// so any segment size decodes. Each thread's probability table lives in
// the `scratch` result in device memory.
//
// Threads per block: the smallest power of two that still keeps every
// lane resident at once (SM count x resident blocks per SM). Lanes in
// one warp take different branches (literal vs match) and serialise, so
// fewer threads per warp decode faster as long as no lane waits for a
// second wave; on an H100 this was 1-2 threads per block (PERF.md).
//
// Launch order on the handler's stream: stored (uncompressed) chunks are
// copied into the output first, since later LZMA chunks of the same
// segment read them as history; then the decode kernel. The handler only
// enqueues work: it neither allocates nor synchronises.

#include <cuda_runtime.h>

#include "lzma_segment.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

__global__ void prefill_kernel(const uint8_t* in, const int32_t* prefill,
                               uint8_t* out) {
  const int32_t* p = prefill + 3 * blockIdx.x;
  const int32_t s = p[0], d = p[1], n = p[2];
  for (int32_t i = threadIdx.x; i < n; i += blockDim.x) out[d + i] = in[s + i];
}

__global__ void segment_kernel(const uint8_t* in, uint32_t in_size,
                               const int32_t* chunks, const int32_t* lanes,
                               int64_t L, int64_t K, uint8_t* out,
                               uint32_t out_size, int32_t* err,
                               uint16_t* scratch, int32_t nprobs) {
  const int64_t l = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int32_t n = lanes[3 * l], base = lanes[3 * l + 1];
  if (n == 0) {
    err[l] = lrt_seg::kOk;
    return;
  }
  if (base < 0 || uint32_t(base) > out_size) {
    err[l] = lrt_seg::kErrTable;
    return;
  }
  err[l] = lrt_seg::decode_segment<uint32_t>(
      in, in_size,
      reinterpret_cast<const lrt_seg::Chunk<uint32_t>*>(
          chunks + l * K * lrt_seg::kChunkFields),
      n, out + base, out_size - uint32_t(base), uint32_t(lanes[3 * l + 2]),
      scratch + l * int64_t(nprobs));
}

int threads_per_block(int64_t L) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int block = 1;
  for (; block < 32; block *= 2) {
    int resident = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, segment_kernel,
                                                  block, 0);
    if ((L + block - 1) / block <= int64_t(sms) * resident) break;
  }
  return block;
}

ffi::Error SegmentDecodeCuda(cudaStream_t stream, ffi::Buffer<ffi::U8> in,
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
  if (nprobs <= 0 || scratch->element_count() < size_t(L) * size_t(nprobs))
    return ffi::Error::InvalidArgument("scratch smaller than L x nprobs");
  if (P > 0)
    prefill_kernel<<<unsigned(P), 256, 0, stream>>>(
        in.typed_data(), prefill.typed_data(), out->typed_data());
  if (L > 0) {
    const int block = threads_per_block(L);
    segment_kernel<<<unsigned((L + block - 1) / block), unsigned(block), 0,
                     stream>>>(
        in.typed_data(), uint32_t(in.element_count()), chunks.typed_data(),
        lanes.typed_data(), L, K, out->typed_data(),
        uint32_t(out->element_count()), err->typed_data(),
        scratch->typed_data(), nprobs);
  }
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess)
    return ffi::Error::Internal(std::string("segment decode launch: ") +
                                cudaGetErrorString(rc));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(LrtSegmentDecodeCuda, SegmentDecodeCuda,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U16>>()
                                  .Attr<int32_t>("nprobs"));
