// Helpers of the kernels that stage rows with cp.async and run on thread
// block clusters: K1's cluster design (csrc/band_forward.cu), K4
// (csrc/band_spread.cu) and the chases (csrc/chase.cuh).
#pragma once

#include <cstddef>

#include <cuda_runtime.h>

namespace torbi {

// Copy one float from device memory into shared memory, asynchronously
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned address =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(address),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `Pending` committed groups are still in flight
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The two halves of a cluster barrier: arrive releases this thread's
// earlier stores (distributed shared memory included) to the cluster, wait
// acquires every other thread's. Work between them overlaps the barrier.
// Every thread of every CTA of the cluster runs both, in convergent code
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Shared memory a block of this card may opt in to, in bytes
inline cudaError_t optin_smem(size_t* bytes) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *bytes = static_cast<size_t>(optin);
  return err;
}

// The clusters of `cluster` blocks of `kernel` the card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters
template <typename... Params>
cudaError_t max_active_clusters(void (*kernel)(Params...), int cluster,
                                dim3 block, size_t smem, int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = block;
  config.dynamicSmemBytes = smem;
  config.attrs = attribute;
  config.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
}

// Launch `kernel` on `grid` blocks in clusters of `cluster` along x, with
// `smem` bytes of dynamic shared memory; returns a cudaError_t code. A
// cluster of more than 8 (the portable maximum) is allowed explicitly
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int cluster, dim3 grid,
                           dim3 block, size_t smem, cudaStream_t stream,
                           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace torbi
