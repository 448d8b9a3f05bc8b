// Block-BVH ray/triangle trace kernel for Hopper (sm_90a): closest hit and
// any-hit (occlusion) in one templated __global__.
//
// Replaces the TPU kernel stratum_tpu/ops/pallas_trace.py::_kernel_gs
// (group-stream mode, GS = 4), reached through pallas_closest (closest,
// every closest wave of the path tracer) and pallas_occluded (any-hit, the
// deferred shadow wave). It computes what that kernel computes, not a
// block-by-block copy of it:
//
//   * A ray block of 2048 lanes shares one front-to-back sorted candidate
//     list of leaf groups (GS consecutive leaves of K triangles), built in
//     torch by ops/block_trace.py::_prepare. Here one CTA of 128 threads
//     runs one 128-lane sub-block, one thread per ray; the 16 CTAs of a ray
//     block read the same list.
//   * For each member leaf every thread runs the slab pretest of the leaf
//     AABB against its own current best t (the formula of
//     _pretest_words_multi). __syncthreads_or skips leaves no ray wants.
//   * The CTA stages the leaf's [K, 10, 4] f32 Plucker features (40 KB at
//     K = 256) in shared memory; each wanting thread evaluates the K
//     triangles in full f32 (a, u, v, t as 10-term FMA chains) and applies
//     the reference accept rule (_mt_classify): |a| > 1e-12, |a| < 1e37,
//     u, v >= 0, u + v <= |a|, t > 1e-4 |a|, then t < best. Ties keep the
//     lower slot. The TPU kernel's bf16-split matmul and packed argmin do
//     not exist here: t is the exact f32 quotient and slots are int32.
//   * Early exit: the CTA stops when the next candidate's entry distance is
//     at or beyond the largest best t of its rays (a shared-memory max
//     reduction per candidate). In occluded mode a blocked ray's bound drops
//     to 0, so a fully blocked CTA exits at the next candidate.
//
// What bounds it on this card: each ray-triangle test is 40 FMAs plus ~15
// compare/select ops against 160 bytes of shared-memory features that all
// threads of a warp read at the same address (broadcast). The leaf loop is
// FP32-FMA and shared-memory-issue bound, not DRAM bound: the atrium's
// 31 MB of leaf features stay resident in the 50 MB L2. Candidate-list
// order (front-to-back) and the per-ray pretest keep the tested triangle
// count low; tensor cores, TMA, warp specialisation and multi-leaf staging
// are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // rays per CTA (one sub-block)
constexpr int kBlockRays = 2048;  // rays per candidate list
constexpr float kTMax = 3.4e38f;  // ops/intersect.py T_MAX

__device__ __forceinline__ float cta_max(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  float m = scratch[0];
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, scratch[w]);
  __syncthreads();
  return m;
}

template <bool OCCLUDED>
__global__ void __launch_bounds__(kThreads)
block_trace_kernel(const float* __restrict__ rays,     // [Np, 10] features
                   const float* __restrict__ t_max,    // [Np]
                   const float* __restrict__ origin,   // [Np, 3]
                   const float* __restrict__ inv_dir,  // [Np, 3]
                   const int* __restrict__ cand,       // [nb, G] group ids
                   const float* __restrict__ centry,   // [nb, G] entries
                   const int* __restrict__ ncand,      // [nb]
                   const float* __restrict__ leaf_lo,  // [L, 3]
                   const float* __restrict__ leaf_hi,  // [L, 3]
                   const float4* __restrict__ feat,    // [L, K, 10] x float4
                   int num_groups, int num_leaves, int leaf_size, int gs,
                   float* __restrict__ t_out,          // [Np] closest
                   int* __restrict__ slot_out,         // [Np] closest
                   uint8_t* __restrict__ blocked_out)  // [Np] occluded
{
  extern __shared__ float4 sfeat[];  // [leaf_size * 10]
  __shared__ float scratch[kThreads / 32];

  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const int blk = (blockIdx.x * kThreads) / kBlockRays;
  float r[10];
#pragma unroll
  for (int f = 0; f < 10; ++f) r[f] = rays[ray * 10 + f];
  const float ox = origin[ray * 3 + 0], oy = origin[ray * 3 + 1],
              oz = origin[ray * 3 + 2];
  const float ix = inv_dir[ray * 3 + 0], iy = inv_dir[ray * 3 + 1],
              iz = inv_dir[ray * 3 + 2];
  const float limit = t_max[ray];
  float best = limit;
  int slot = -1;

  const int nc = ncand[blk];
  const int* cand_b = cand + (size_t)blk * num_groups;
  const float* centry_b = centry + (size_t)blk * num_groups;
  const int n_feat = leaf_size * 10;

  for (int c = 0; c < nc; ++c) {
    if (!(centry_b[c] < cta_max(best, scratch))) break;
    const int g = cand_b[c];
    for (int m = 0; m < gs; ++m) {
      const int leaf = g * gs + m;
      if (leaf >= num_leaves) break;  // uniform: padded group members
      const float t0x = (leaf_lo[leaf * 3 + 0] - ox) * ix;
      const float t1x = (leaf_hi[leaf * 3 + 0] - ox) * ix;
      const float t0y = (leaf_lo[leaf * 3 + 1] - oy) * iy;
      const float t1y = (leaf_hi[leaf * 3 + 1] - oy) * iy;
      const float t0z = (leaf_lo[leaf * 3 + 2] - oz) * iz;
      const float t1z = (leaf_hi[leaf * 3 + 2] - oz) * iz;
      const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fmaxf(fminf(t0z, t1z), 0.0f));
      const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fmaxf(t0z, t1z));
      const bool want = (tn <= tf) && (tn < best);
      if (!__syncthreads_or(want)) continue;

      const float4* src = feat + (size_t)leaf * n_feat;
      for (int i = threadIdx.x; i < n_feat; i += kThreads) sfeat[i] = src[i];
      __syncthreads();

      if (want) {
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
                             sv >= 0.f && su + sv <= abs_a &&
                             stn > 1e-4f * abs_a;
          if (OCCLUDED) {
            if (valid && stn < best * abs_a) {
              best = 0.f;  // any hit ends this ray
              break;
            }
          } else if (valid) {
            const float tt = stn / abs_a;
            const int sid = leaf * leaf_size + k;
            if (tt < best || (tt == best && sid < slot)) {
              best = tt;
              slot = sid;
            }
          }
        }
      }
      __syncthreads();  // sfeat is overwritten by the next leaf
    }
  }

  if (OCCLUDED) {
    blocked_out[ray] = (best <= 0.f && limit > 0.f) ? 1 : 0;
  } else {
    t_out[ray] = slot >= 0 ? best : kTMax;
    slot_out[ray] = slot;
  }
}

template <bool OCCLUDED>
cudaError_t launch(const float* rays, const float* t_max, const float* origin,
                   const float* inv_dir, const int* cand, const float* centry,
                   const int* ncand, const float* leaf_lo,
                   const float* leaf_hi, const float* feat, int num_blocks,
                   int num_groups, int num_leaves, int leaf_size, int gs,
                   float* t_out, int* slot_out, uint8_t* blocked_out,
                   cudaStream_t stream) {
  const size_t smem = (size_t)leaf_size * 10 * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        block_trace_kernel<OCCLUDED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int grid = num_blocks * (kBlockRays / kThreads);
  if (grid == 0) return cudaSuccess;
  block_trace_kernel<OCCLUDED><<<grid, kThreads, smem, stream>>>(
      rays, t_max, origin, inv_dir, cand, centry, ncand, leaf_lo, leaf_hi,
      reinterpret_cast<const float4*>(feat), num_groups, num_leaves,
      leaf_size, gs, t_out, slot_out, blocked_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t block_trace_closest(
    const float* rays, const float* t_max, const float* origin,
    const float* inv_dir, const int* cand, const float* centry,
    const int* ncand, const float* leaf_lo, const float* leaf_hi,
    const float* feat, int num_blocks, int num_groups, int num_leaves,
    int leaf_size, int gs, float* t_out, int* slot_out, void* stream) {
  return launch<false>(rays, t_max, origin, inv_dir, cand, centry, ncand,
                       leaf_lo, leaf_hi, feat, num_blocks, num_groups,
                       num_leaves, leaf_size, gs, t_out, slot_out, nullptr,
                       static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t block_trace_occluded(
    const float* rays, const float* t_max, const float* origin,
    const float* inv_dir, const int* cand, const float* centry,
    const int* ncand, const float* leaf_lo, const float* leaf_hi,
    const float* feat, int num_blocks, int num_groups, int num_leaves,
    int leaf_size, int gs, uint8_t* blocked_out, void* stream) {
  return launch<true>(rays, t_max, origin, inv_dir, cand, centry, ncand,
                      leaf_lo, leaf_hi, feat, num_blocks, num_groups,
                      num_leaves, leaf_size, gs, nullptr, nullptr,
                      blocked_out, static_cast<cudaStream_t>(stream));
}
