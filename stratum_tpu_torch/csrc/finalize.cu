// The closest hit's resolution for Hopper (sm_90a): one launch computes
// stratum_tpu_torch/ops/block_trace.py::finalize_hit for every lane of a
// closest wave: the [N, 88] slot payload row gather, the triangle id and
// the barycentrics from the Moller-Trumbore coefficients of the row against
// the lane's ray features.
//
// It replaces no TPU kernel: the JAX package's finalize_hit
// (stratum_tpu/ops/pallas_trace.py:1877-1902) is jnp, which XLA fuses. The
// torch body it replaces runs ~93 ops a wave (the row gather, the ray
// features' cross product, stack and cat, 30 multiply-adds that each read a
// strided column of the rows and of the features), each a launch over the
// whole wave. That body stays beside the kernel as its plain version; the
// wrapper takes it for CPU tensors only.
//
// Bit for bit with the plain body on the card. Each torch op is one op
// here, in the same order, rounded once:
//   * the ray features [d, o x d, o, 1], the cross product's components
//     as __fsub_rn(__fmul_rn(.), __fmul_rn(.));
//   * a, u_num and v_num each summed from +0 over f = 0..9 as
//     __fadd_rn(acc, __fmul_rn(rf_f, coef)), never contracted into an FMA;
//   * |a| > 1e-12 compared in f32 (torch casts the Python scalar to the
//     tensor's type); 1.0 / a is torch's rdiv, a.reciprocal() * 1.0, the
//     reciprocal an IEEE division (__fdiv_rn); u_num * inv_a, v_num * inv_a;
//   * column 62 to int32 by truncation (static_cast, as torch's .to());
//   * a miss (slot < 0) gathers row 0, as clamp(slot, 0) does, and writes
//     tri -1 and bary (0, 0).
//
// Inputs: the slot payload [rows, 88] f32, contiguous and 16-byte aligned;
// the slot int32 [N], origin and direction f32 [N, 3] by pointer and
// element strides (between lanes, and between a vector's components), so
// views are read as they are. Outputs are contiguous: tri int32 [N], bary
// f32 [N, 2] and the gathered rows f32 [N, 88]. Every slot of a hit must
// name a row of the payload (the tracers' slots do).
//
// What bounds it: bytes. A lane needs its slot (4 B), origin and direction
// (24), its row read (352) and written (352), tri (4) and bary (8): 744 B,
// 1.54 GB a 1920x1080 wave, 0.46 ms at 3.35 TB/s. The arithmetic is ~70
// unfused f32 ops and one division a lane. Design, one thread a lane, 128
// lanes a CTA:
//   1. each thread reads its lane's slot into shared memory;
//   2. the CTA copies its 128 rows with 16-byte loads, consecutive threads
//      on consecutive float4 of a row, and writes each float4 at once to
//      the CTA's block of output rows, which is contiguous: coalesced
//      16-byte stores, no row held in shared memory. Each thread keeps
//      kUnroll loads in flight. The 8 float4 of columns 32..63 (the 30
//      coefficients and the triangle id) are also staged into shared
//      memory, 33 floats a lane, so the lanes of a warp reading one column
//      hit 32 different banks;
//   3. each thread reads its lane's ray and coefficients and writes tri
//      and bary.
// 17 KB of shared memory a CTA; the registers are allowed up to 64 a
// thread (8 CTAs an SM), so that nothing spills. On an H100 a launch at
// that wave takes 0.29-0.37 ms, under the 744 B count: lanes share rows
// (every miss reads row 0) and L2 serves the repeats. Counting each
// distinct row read once (~0.25 ms) it is 1.2-1.45x. chip_smoke.py (phase
// 19) times each launch beside both bounds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // lanes (and threads) a CTA
constexpr int kMinBlocks = 8;   // CTAs an SM the registers must allow: up to 64 a thread
constexpr int kWidth = 88;      // floats a payload row
constexpr int kVec = kWidth / 4;  // float4 a row
constexpr int kStage0 = 8;      // first staged float4: column 32, the first coefficient
constexpr int kStaged = 8;      // staged float4: columns 32..63
constexpr int kPitch = 4 * kStaged + 1;  // staged floats a lane, padded against bank conflicts
constexpr int kTri = 30;        // column 62 among the staged ones
constexpr int kUnroll = 4;      // row loads a thread keeps in flight

struct Rays {
  const int* slot;
  const float* o;
  const float* d;
  long long slot_lane;            // element strides
  long long o_lane, o_comp;
  long long d_lane, d_comp;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__global__ void __launch_bounds__(kThreads, kMinBlocks)
finalize_hit_kernel(const float4* __restrict__ rows, Rays in, long long n, int* __restrict__ tri,
                    float2* __restrict__ bary, float4* __restrict__ out) {
  __shared__ int s_row[kThreads];
  __shared__ float s_coef[kThreads * kPitch];
  const long long base = static_cast<long long>(blockIdx.x) * kThreads;
  const int lanes = static_cast<int>(n - base < kThreads ? n - base : kThreads);
  const int t = threadIdx.x;
  int slot = -1;
  if (t < lanes) {
    slot = in.slot[(base + t) * in.slot_lane];
    s_row[t] = slot > 0 ? slot : 0;
  }
  __syncthreads();

  // the CTA's rows: gathered with 16-byte loads, stored to its contiguous
  // block of output rows, columns 32..63 staged
  float4* dst = out + base * kVec;
  const int total = lanes * kVec;
  for (int k0 = t; k0 < total; k0 += kThreads * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kThreads;
      if (k < total) {
        const int lane = k / kVec;
        v[u] = __ldg(rows + static_cast<long long>(s_row[lane]) * kVec + (k - lane * kVec));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kThreads;
      if (k < total) {
        dst[k] = v[u];
        const int lane = k / kVec, q = k - lane * kVec - kStage0;
        if (q >= 0 && q < kStaged) {
          float* s = s_coef + lane * kPitch + 4 * q;
          s[0] = v[u].x;
          s[1] = v[u].y;
          s[2] = v[u].z;
          s[3] = v[u].w;
        }
      }
    }
  }
  __syncthreads();
  if (t >= lanes) return;

  const long long i = base + t;
  const float* po = in.o + i * in.o_lane;
  const float* pd = in.d + i * in.d_lane;
  const float o0 = po[0], o1 = po[in.o_comp], o2 = po[2 * in.o_comp];
  const float d0 = pd[0], d1 = pd[in.d_comp], d2 = pd[2 * in.d_comp];
  const float rf[10] = {d0, d1, d2,
                        sub(mul(o1, d2), mul(o2, d1)),
                        sub(mul(o2, d0), mul(o0, d2)),
                        sub(mul(o0, d1), mul(o1, d0)),
                        o0, o1, o2, 1.0f};
  const float* c = s_coef + t * kPitch;
  float a = 0.0f, u_num = 0.0f, v_num = 0.0f;
#pragma unroll
  for (int f = 0; f < 10; ++f) {
    a = add(a, mul(rf[f], c[3 * f + 0]));
    u_num = add(u_num, mul(rf[f], c[3 * f + 1]));
    v_num = add(v_num, mul(rf[f], c[3 * f + 2]));
  }
  const float inv_a =
      fabsf(a) > static_cast<float>(1e-12) ? mul(__fdiv_rn(1.0f, a), 1.0f) : 0.0f;
  if (slot >= 0) {
    tri[i] = static_cast<int>(c[kTri]);
    bary[i] = make_float2(mul(u_num, inv_a), mul(v_num, inv_a));
  } else {
    tri[i] = -1;
    bary[i] = make_float2(0.0f, 0.0f);
  }
}

}  // namespace

// finalize_hit for n lanes on `stream`: rows is the slot payload [*, 88]
// (16-byte aligned); slot, origin and direction by pointer and element
// strides; tri [n], bary [n, 2] and out [n, 88] contiguous. Returns the
// launch's error.
extern "C" cudaError_t finalize_hit(const float* rows, const int* slot, long long slot_lane,
                                    const float* o, long long o_lane, long long o_comp,
                                    const float* d, long long d_lane, long long d_comp,
                                    long long n, int* tri, float* bary, float* out,
                                    void* stream) {
  if (n < 0 || !rows || !slot || !o || !d || !tri || !bary || !out ||
      reinterpret_cast<unsigned long long>(rows) % 16 != 0)
    return cudaErrorInvalidValue;
  if ((n + kThreads - 1) / kThreads >= (1ll << 31)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Rays in{slot, o, d, slot_lane, o_lane, o_comp, d_lane, d_comp};
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  finalize_hit_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(rows), in, n, tri, reinterpret_cast<float2*>(bary),
      reinterpret_cast<float4*>(out));
  return cudaGetLastError();
}

// Registers, local (spill) bytes, resident CTAs per SM, the CTA's threads
// and its static shared memory.
extern "C" cudaError_t finalize_hit_info(int* out) {
  cudaFuncAttributes attr;
  int blocks = 0;
  const void* fn = reinterpret_cast<const void*>(finalize_hit_kernel);
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  out[3] = kThreads;
  out[4] = static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}
