// Helpers of the kernels that stage rows with cp.async and run on thread
// block clusters: K1's cluster design (csrc/band_forward.cu), K4
// (csrc/band_spread.cu, with the mbarrier exchange below), the spread lab
// (csrc/lab_spread.cu) and the chases (csrc/chase.cuh).
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

// Programmatic dependent launch (Hopper): once every CTA of a grid has run
// grid_launch_dependents (or exited), the grid launched after it on the
// stream as a dependent (launch_cluster's `dependent`) may start, its
// CTAs taking SMs as this grid's retire. grid_dependency_wait blocks until
// the grid this one depends on has completed and its stores are visible.
// Both are no-ops in a grid that has no dependent or was not launched as
// one
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The asynchronous exchange of K4 (csrc/band_spread.cu) and the spread
// lab's probe (csrc/lab_spread.cu): each CTA waits on an mbarrier in its
// own shared memory for the bytes it expects, and the senders' bulk copies
// and async stores complete transactions on the receiver's barrier. No
// cluster barrier runs per frame. Addresses are 32-bit shared-memory
// addresses: shared::cta ones from smem_address, shared::cluster ones (in
// another CTA of the cluster, or this one) from remote_address.
__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of the same offset in CTA `rank`'s memory
__device__ __forceinline__ unsigned remote_address(unsigned address,
                                                   int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(address), "r"(rank));
  return out;
}

// Initialise an mbarrier that completes a phase on `count` arrivals, then
// make the initialisation visible to the cluster (before the cluster
// barrier that precedes any remote operation)
__device__ __forceinline__ void mbarrier_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbarrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on the barrier and expect `bytes` more transaction bytes in its
// current phase. Bytes may complete before this runs: the phase completes
// once both the arrival and every expected byte are in
__device__ __forceinline__ void mbarrier_expect(unsigned bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of the given parity has completed. A wait past
// 2^35 clocks (about 17 s; a frame takes microseconds) traps, so that a
// fault in an exchange ends the launch with an error instead of hanging it
__device__ __forceinline__ void mbarrier_wait(unsigned bar, int parity) {
  unsigned done = 0;
  const long long start = clock64();
  do {
    if (clock64() - start > (1LL << 35)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Make this thread's shared-memory stores visible to bulk copies
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from this
// CTA's shared memory to `dst` (shared::cluster), completing them on the
// barrier `bar` (shared::cluster, in the destination's CTA)
__device__ __forceinline__ void bulk_copy(unsigned dst, unsigned src,
                                          int bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Store one float at `dst` (shared::cluster), completing its 4 bytes on the
// barrier `bar` of the destination's CTA
__device__ __forceinline__ void store_async(unsigned dst, float value,
                                            unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
      " [%0], %1, [%2];\n" ::"r"(dst),
      "r"(__float_as_uint(value)), "r"(bar)
      : "memory");
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
// (cudaOccupancyMaxActiveClusters), into *clusters; a cluster of more than
// 8 is allowed explicitly, as launch_cluster does
template <typename... Params>
cudaError_t max_active_clusters(void (*kernel)(Params...), int cluster,
                                dim3 block, size_t smem, int* clusters) {
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
  config.gridDim = dim3(cluster);
  config.blockDim = block;
  config.dynamicSmemBytes = smem;
  config.attrs = attribute;
  config.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
}

// Launch `kernel` on `grid` blocks in clusters of `cluster` along x, with
// `smem` bytes of dynamic shared memory; returns a cudaError_t code. A
// cluster of more than 8 (the portable maximum) is allowed explicitly.
// With `dependent` set the launch is a programmatic dependent of the
// kernel before it on the stream (grid_launch_dependents above): the
// kernel must run grid_dependency_wait before it exits, so that what
// follows it on the stream still follows the kernel before it
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int cluster, dim3 grid,
                           dim3 block, size_t smem, cudaStream_t stream,
                           int dependent, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attribute[2];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  attribute[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attribute;
  config.numAttrs = dependent ? 2 : 1;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace torbi
