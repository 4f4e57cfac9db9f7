// What the kernels' launchers read about the card they run on.
#pragma once
#include <cuda_runtime.h>

namespace {

// Streaming multiprocessors of the current device, read once (132 on an
// H100 SXM, also the answer if the query fails): the launchers size their
// grids against it.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
  }
  return sms;
}

}  // namespace
