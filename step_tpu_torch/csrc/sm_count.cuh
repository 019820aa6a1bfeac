// The number of SMs of the current device, asked once per device; 132 (an
// H100 SXM) if the runtime cannot say. Launchers size their grids by it.
#pragma once

#include <cuda_runtime.h>

namespace step {

inline int sm_count() {
  static int count[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= 64) return 132;
  if (count[device] == 0 &&
      cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 132;
  return count[device];
}

}  // namespace step
