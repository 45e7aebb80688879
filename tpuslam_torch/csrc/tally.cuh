// The launch tally of the kernels that the device-resident ICP and CPD loops
// run (K1, K2, K3, K4's and K5's passes, K5's plan, P's entries): a device
// i32[2] per kernel (kernels/__init__.py::tally), (launches run, launches that
// returned at once as an unselected arm or route).  A replayed CUDA graph runs no
// wrapper, so the loops book its launches from these counts.  A null tally
// records nothing.
#pragma once

#include <cuda_runtime.h>

// one count a launch, from block (0, 0, 0)'s thread (0, 0, 0)
__device__ __forceinline__ void tally_launch(int* tally, bool skipped) {
  if (tally != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0 && threadIdx.x == 0 && threadIdx.y == 0 &&
      threadIdx.z == 0) {
    atomicAdd(tally, 1);
    if (skipped) atomicAdd(tally + 1, 1);
  }
}
