// The pointer table of a grouped launch: n pieces of equal width on one
// device (one piece: an unsharded call; every piece a device holds: a
// sharded server's), each piece's K operand pointers passed to the kernel
// as a __grid_constant__ parameter, blockIdx.y the piece.  Nothing is
// copied to the device or allocated.
//
// A launch takes at most kMax = 32 pieces; a device with more takes a
// launch every 32.  The table is the smallest of 1, 4 and 32 pieces that
// holds a launch's pieces, since the parameters travel with every launch,
// and a one-piece table is read at fixed offsets, so that an unsharded
// call costs what separate pointer arguments would.
#pragma once

#include <cuda_runtime.h>

namespace pieces {

constexpr int kMax = 32;

template <int P, int K>
struct Table {
  static constexpr int kPieces = P;
  const void* ptr[P][K];
};

template <int P, int K, class Launch>
cudaError_t launch_table(const void* const* ops, int count, Launch& launch) {
  Table<P, K> t = {};
  for (int i = 0; i < count; ++i)
    for (int k = 0; k < K; ++k) t.ptr[i][k] = ops[(long long)i * K + k];
  launch(t, count);
  return cudaGetLastError();
}

// launch(table, count) for every kMax of the n pieces of ops (a host array
// of n * K pointers, piece by piece), count the table's pieces; returns
// the first launch error.
template <int K, class Launch>
int each(const void* const* ops, int n, Launch launch) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  for (int start = 0; start < n; start += kMax) {
    const int count = n - start < kMax ? n - start : kMax;
    const void* const* at = ops + (long long)start * K;
    const cudaError_t e =
        count == 1   ? launch_table<1, K>(at, count, launch)
        : count <= 4 ? launch_table<4, K>(at, count, launch)
                     : launch_table<kMax, K>(at, count, launch);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// piece blockIdx.y's operand k of a table, as a V*; a one-piece table
// (the unsharded call) at a fixed offset among the parameters
template <class V, class T>
__device__ __forceinline__ V* operand(const T& t, int k) {
  const unsigned y = T::kPieces == 1 ? 0u : blockIdx.y;
  return static_cast<V*>(const_cast<void*>(t.ptr[y][k]));
}

}  // namespace pieces
