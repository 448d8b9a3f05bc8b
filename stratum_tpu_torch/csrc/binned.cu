// Binned pair-stream bin step for Hopper (sm_90a): per 128-lane bin of one
// leaf, each lane's closest valid triangle of that leaf, folded into its
// ray's answer.
//
// Replaces the TPU kernel stratum_tpu/ops/binned.py::_bin_kernel, reached
// through _binned_trace's pl.pallas_call from pallas_closest_binned and
// pallas_occluded_binned. It computes what that kernel computes, not a
// block-by-block copy of it:
//
//   * A bin is 128 lanes: 128 / g pairs of one leaf, each pair a group of g
//     rays (ops/binned.py::bin_pairs sorts and pads the pairs so a bin never
//     spans two leaves). One CTA of 128 threads runs one bin, one thread per
//     lane, and stages that leaf's [K, 10, 4] f32 Plucker features (40 KB at
//     K = 256) in shared memory. Every lane of a bin shares the leaf by
//     construction: there is no pretest and no early exit. Bins of one leaf
//     are consecutive, so their CTAs find the leaf in L2.
//   * A thread reads its ray's 10 features through the pair's group id
//     (pair_id / pcap * g + lane % g). The reference gathers them into a
//     bin-ordered tensor first; at the deferred shadow wave's pair capacity
//     (5.18 M pairs, 8 rays each) that tensor would take ~2.7 GB.
//   * Exact f32: a, u, v, t are 10-term FMA chains in the order of
//     csrc/block_trace.cu, with the reference accept rule (_mt_classify);
//     t is the exact quotient and slots are int32 (leaf * K + k). The TPU
//     kernel's bf16-split matmul and packed argmin do not exist here.
//   * The resolve is fused: a lane's (t, slot) goes into its ray's 64-bit
//     word by atomicMin((t bits << 32) | slot). Positive f32 bit patterns
//     order like their values, so the minimum is the closest hit with the
//     lower slot on equal t, whatever order the lanes land in.
//   * bin_leaf < 0 (an empty bin) and pair_id < 0 (run padding) give misses:
//     such lanes write nothing.
//
// What bounds it on this card: every lane tests all K triangles of its leaf,
// 40 FMAs plus ~15 compare/select ops each against shared-memory features
// that a warp reads at one address (broadcast). The bound is FP32 issue:
// lanes * K * 80 flop against 67 TFLOP/s. Device memory traffic is small
// (40 B of ray features per lane, one staged leaf per bin, mostly from L2).
// The design keeps the work at exactly that count (no pretest, no carried
// state) and stages each leaf once per 128 lanes; several bins per CTA, TMA
// staging and a higher occupancy than five 40 KB CTAs per SM are left for
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;  // lanes per bin, threads per CTA

__global__ void __launch_bounds__(kLanes)
binned_min_kernel(const int* __restrict__ bin_leaf,    // [num_bins]
                  const int* __restrict__ pair_id,     // [num_bins * 128 / g]
                  const float* __restrict__ rays,      // [num_rays, 10]
                  const float4* __restrict__ feat,     // [L, K, 10] x float4
                  int num_rays, int leaf_size, int g, int pcap,
                  unsigned long long* __restrict__ words)  // [num_rays]
{
  extern __shared__ float4 sfeat[];  // [leaf_size * 10]
  const int leaf = bin_leaf[blockIdx.x];
  if (leaf < 0) return;  // uniform over the CTA: an empty bin

  const int n_feat = leaf_size * 10;
  const float4* src = feat + (size_t)leaf * n_feat;
  for (int i = threadIdx.x; i < n_feat; i += kLanes) sfeat[i] = src[i];
  __syncthreads();  // the only barrier: lanes may leave after it

  const int pid = pair_id[blockIdx.x * (kLanes / g) + threadIdx.x / g];
  if (pid < 0) return;  // run padding
  const int ray = (pid / pcap) * g + threadIdx.x % g;
  if (ray >= num_rays) return;  // the wave's padding to whole groups

  float r[10];
#pragma unroll
  for (int f = 0; f < 10; ++f) r[f] = rays[(size_t)ray * 10 + f];
  float best = __int_as_float(0x7f800000);  // +inf
  int best_k = -1;
  for (int k = 0; k < leaf_size; ++k) {
    const float4* q = sfeat + k * 10;
    float a = 0.f, u = 0.f, v = 0.f, t = 0.f;
#pragma unroll
    for (int f = 0; f < 10; ++f) {
      const float4 w = q[f];
      a = fmaf(r[f], w.x, a);
      u = fmaf(r[f], w.y, u);
      v = fmaf(r[f], w.z, v);
      t = fmaf(r[f], w.w, t);
    }
    const float s = a > 0.f ? 1.f : (a < 0.f ? -1.f : 0.f);
    const float abs_a = a * s, su = u * s, sv = v * s, stn = t * s;
    const bool valid = abs_a > 1e-12f && abs_a < 1e37f && su >= 0.f &&
                       sv >= 0.f && su + sv <= abs_a && stn > 1e-4f * abs_a;
    if (valid) {
      const float tt = stn / abs_a;
      if (tt < best) {  // strict: the lower k keeps an equal t
        best = tt;
        best_k = k;
      }
    }
  }
  if (best_k >= 0) {
    const unsigned long long word =
        ((unsigned long long)__float_as_uint(best) << 32) |
        (unsigned int)(leaf * leaf_size + best_k);
    atomicMin(words + ray, word);
  }
}

}  // namespace

extern "C" cudaError_t binned_min(const int* bin_leaf, const int* pair_id,
                                  const float* rays, const float* feat,
                                  int num_bins, int num_rays, int leaf_size,
                                  int g, int pcap, unsigned long long* words,
                                  void* stream) {
  if (g < 1 || kLanes % g != 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)leaf_size * 10 * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        binned_min_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (num_bins == 0) return cudaSuccess;
  binned_min_kernel<<<num_bins, kLanes, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      bin_leaf, pair_id, rays, reinterpret_cast<const float4*>(feat),
      num_rays, leaf_size, g, pcap, words);
  return cudaGetLastError();
}
