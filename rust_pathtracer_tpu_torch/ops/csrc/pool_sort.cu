// The regen window end's sort (window_end.cu, step 2): a stable radix sort
// of the pool's (key, lane) pairs, on the key's low end_bit bits, by CUB's
// DeviceRadixSort::SortPairs with double buffers: no copy back, and scratch
// for the digit counts only.
//
// A library call: the JAX package's flush is XLA's scatter-add and no
// Pallas kernel, so no hand-written kernel is replaced.  A stable sort has
// one result, so any stable sort gives the same pairs; the CPU tests put
// torch.sort(stable=True) in its place.  Bytes: ceil(end_bit / 8) passes
// of onesweep over 4-byte keys and values, read and written once a pass,
// after one pass that counts the digits.

#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>

extern "C" {

// Scratch bytes of a sort of n_items pairs on end_bit bits, or -1.
long long pool_sort_temp_bytes(long long n_items, int end_bit) {
  if (n_items < 1 || n_items >= (1LL << 31) || end_bit < 1 || end_bit > 32) return -1;
  size_t bytes = 0;
  cub::DoubleBuffer<unsigned> keys(nullptr, nullptr);
  cub::DoubleBuffer<int> vals(nullptr, nullptr);
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(nullptr, bytes, keys, vals,
                                                          (int)n_items, 0, end_bit);
  return err == cudaSuccess ? (long long)bytes : -1;
}

// Sort the pairs (keys[0], vals[0]) on `stream`, with (keys[1], vals[1])
// the other buffers of n_items each and `temp` the scratch of
// pool_sort_temp_bytes.  Writes to *selector which buffer holds the sorted
// pairs (0 or 1; the keys' and the values' are the same).  Returns a CUDA
// error code: nonzero means the sort never ran.
int pool_sort_launch(void* temp, long long temp_bytes, unsigned* keys0, unsigned* keys1,
                     int* vals0, int* vals1, long long n_items, int end_bit, int* selector,
                     void* stream) {
  if (n_items < 1 || n_items >= (1LL << 31) || end_bit < 1 || end_bit > 32 || !temp ||
      !keys0 || !keys1 || !vals0 || !vals1 || !selector)
    return (int)cudaErrorInvalidValue;
  cub::DoubleBuffer<unsigned> keys(keys0, keys1);
  cub::DoubleBuffer<int> vals(vals0, vals1);
  size_t bytes = (size_t)temp_bytes;
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(
      temp, bytes, keys, vals, (int)n_items, 0, end_bit, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  if (keys.selector != vals.selector) return (int)cudaErrorInvalidValue;
  *selector = keys.selector;
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
