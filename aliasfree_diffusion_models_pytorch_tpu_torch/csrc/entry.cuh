// The C interface every kernel library of this directory exports, and its one definition of the
// error decoder. Each .cu file is one library (utils/kernels.py:SOURCES) and includes this header
// once, so each library exports afdm_cuda_error_string beside its entry point.
//
// An entry point is `extern "C" int afdm_<name>(..., void* stream)`: pointers as void*, integers
// as int or long long, reals as float, and the stream last. utils/kernels.py:Entry declares each
// one's arguments (tests/test_torch_kernel_entry.py holds the two sides to each other), launches
// on the current stream of the tensors' device and raises on a non-zero return, which is a
// cudaError_t, or kTensorMapError + the CUresult of a TMA tensor map that cuTensorMapEncodeTiled
// refused.

#pragma once

#include <cuda_runtime.h>

namespace afdm {

constexpr int kTensorMapError = 100000;  // utils/kernels.py:TENSOR_MAP_ERROR

}  // namespace afdm

extern "C" const char* afdm_cuda_error_string(int err) {
  if (err >= afdm::kTensorMapError) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
