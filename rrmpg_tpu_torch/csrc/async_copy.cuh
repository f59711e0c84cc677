// Asynchronous copies from device memory to shared memory (cp.async,
// sm_80 and later), for kernels that stage the forcing every member of a
// block reads: gr4j_fused.cu (K1/K2, K5), snow_staged.cuh (K8-K11) and
// hbv_fused.cu (K12, K14).
//
// Each copy moves one 4- or 8-byte element, so a series that a slice starts
// at any element needs no alignment beyond its type's.  A block commits one
// group of copies per tile (an empty group where nothing is left to copy),
// so waiting for all groups but the newest is waiting for the tile before.
//
// Everything sits in an anonymous namespace, as in gr4j_step.cuh.

#pragma once

#include <cuda_runtime.h>

namespace {

// One element from device memory to shared memory, asynchronously.
template <typename Real>
__device__ __forceinline__ void copy_async(Real* dst, const Real* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(to),
               "l"(src), "n"(sizeof(Real))
               : "memory");
}

// Close the group of copies this thread issued since the last commit.
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for every group of this thread's copies but the newest.
__device__ __forceinline__ void copy_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

}  // namespace
