// Block-BVH ray/triangle trace kernel for Hopper (sm_90a): closest hit and
// any-hit (occlusion) in one templated __global__.
//
// Replaces the TPU kernel stratum_tpu/ops/pallas_trace.py::_kernel_gs
// (group-stream mode, GS = 4), reached through pallas_closest (closest,
// every closest wave of the path tracer) and pallas_occluded (any-hit, the
// deferred shadow wave); at a group size of 1 it is _kernel / _kernel_occ.
// It computes what that kernel computes, not a block-by-block copy of it.
// The TPU kernel walks a sequential grid over 2048-lane blocks whose
// front-to-back lists XLA builds outside it; here every CTA of 128 rays
// builds its own list and walks it:
//
//   (a) List phase. The CTA stages its rays' origin, inverse direction and
//       bound in shared memory. A thread per group box computes the box's
//       entry distance (the slab formula of ops/packet.py::_block_entries:
//       t_min 1e-4, t_clip = the ray's bound; subtract, multiply, min and
//       max only, so the entries equal the plain version's bit for bit) for
//       each live ray of the CTA and keeps the minimum. The (entry, group)
//       pairs are sorted front to back as packed 64-bit keys
//       (entry bits << 32) | group by a bitonic sort, padded to a power of
//       two: entries are >= 0 or +inf, so the key order is the stable
//       order of ops/block_trace.py::candidate_lists. ncand = the finite
//       keys. A lane with bound 0 (dead, or padding) can never commit and
//       adds no entry; a CTA with no live ray writes misses and returns
//       before the list phase.
//       Two list modes, chosen by size. Up to kMaxKeys keys (4,096 groups:
//       16,384 leaves at gs = 4, 4,096 at gs = 1) the keys live in dynamic
//       shared memory (32 KB at most). Past that each CTA keeps its keys in
//       its own row of a global scratch buffer and runs the same network
//       there, so its list is the same bit for bit; the scratch holds the
//       lists of scratch_ctas CTAs (the wrapper sizes it to 512 MB,
//       ops/block_trace.py LIST_SCRATCH_BYTES) and the host launches the
//       wave in chunks of that many CTAs, one after another on the stream,
//       each reusing the buffer. The walk reads its list from wherever it
//       was sorted.
//   (b) Visits over real triangles. A leaf holds leaf_count[leaf] triangles
//       at the front of its K slots (the padding sits at the tail); only
//       those are staged, in tiles of at most 64 triangles (10 KB),
//       feature-major so that consecutive threads read consecutive words.
//   (c) (ray, triangle) pairs spread over the CTA. Each thread runs the slab
//       pretest of the leaf box for its own ray against its current best t;
//       the wanting rays are compacted with ballot and prefix, and the
//       n_want x count pairs are spread over all 128 threads, ray index
//       fastest. Each pair is the exact f32 test: a, u, v, t as 10-term FMA
//       chains in feature order, the reference accept rule (_mt_classify):
//       |a| > 1e-12, |a| < 1e37, u, v >= 0, u + v <= |a|, t > 1e-4 |a|.
//       Closest: the commit is a shared-memory 64-bit atomicMin of
//       (t bits << 32) | slot (t > 0, so the bits order like the values;
//       equal t keeps the lower slot). Each ray's key starts at
//       (bound bits << 32) | 0, so a hit at exactly the bound stays a miss.
//       Occluded: a hit before the bound sets the ray's bound to 0.
//   (d) Early exit: the CTA stops when the next entry is at or beyond the
//       largest current best t of its rays (read from the shared keys),
//       checked once per candidate group.
//   (e) Exact f32 throughout; no tensor cores and no bf16 split (the c48
//       split of the TPU kernel is an approximation the port does not
//       carry). t is the exact quotient and slots are int32 leaf * K + k.
//
// What bounds it on this card: the pair tests, 40 FFMA plus ~15
// compare/select operations each, against features in shared memory (FP32
// and shared-memory instruction rates); the atrium's 31 MB of leaf
// features stay in the 50 MB L2. The list phase adds G slab tests per live
// ray and a sort of G keys per CTA; in the global list mode each of the
// sort's log2(keys) (log2(keys) + 1) / 2 stages reads and writes the CTA's
// keys in device memory (L2 while a chunk's lists fit there).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;             // rays per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                 // triangles per staged tile
constexpr int kMaxKeys = 4096;            // list keys per CTA in shared memory (32 KB)
constexpr int kMinCtas = 8;               // resident CTAs asked of ptxas
constexpr float kTMax = 3.4e38f;          // ops/intersect.py T_MAX
constexpr float kTMin = 1e-4f;            // ops/block_trace.py T_MIN
constexpr float kNoEntry = 3.0e38f;       // plain lists' entry past ncand
constexpr unsigned long long kInfKey = 0x7f800000ull << 32;  // entry +inf

struct Shared {
  float o[3][kThreads];
  float inv[3][kThreads];
  float bound[kThreads];           // t_clip; occluded: 0 once blocked
  float ray[10][kThreads];         // Plucker features, feature-major
  float4 tri[10][kTile];           // one tile of a leaf, feature-major
  unsigned long long best[kThreads];  // closest: (t bits << 32) | slot
  int list[kThreads];              // live rays, then wanting rays
  int cnt[2][kWarps];              // per-warp counts, double-buffered
  float wmax[2][kWarps];           // per-warp max best, double-buffered
  int ncand;
};

// Indices of the threads whose `pred` holds, in thread order, into list[];
// returns their count (one barrier). list[] is written after the barrier,
// so its readers need another one. `cnt` must not be read by a thread
// still in the previous use of the same buffer: callers alternate two.
// With a `wmax` buffer (alternated like `cnt`), also writes the CTA's max
// of `v` to *vmax.
__device__ __forceinline__ int cta_compact(bool pred, int* list, int* cnt,
                                           float v, float* wmax, float* vmax) {
  const unsigned ballot = __ballot_sync(0xffffffffu, pred);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (wmax != nullptr) {
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if (lane == 0) {
    cnt[warp] = __popc(ballot);
    if (wmax != nullptr) wmax[warp] = v;
  }
  __syncthreads();
  int base = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = cnt[w];
    base += w < warp ? c : 0;
    total += c;
  }
  if (wmax != nullptr) {
    float m = wmax[0];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, wmax[w]);
    *vmax = m;
  }
  if (pred) list[base + __popc(ballot & ((1u << lane) - 1u))] = threadIdx.x;
  return total;
}

template <bool OCCLUDED, bool GLOBAL_LIST>
__global__ void __launch_bounds__(kThreads, kMinCtas)
block_trace_kernel(const float* __restrict__ rays,       // [Np, 10] features
                   const float* __restrict__ t_max,      // [Np]
                   const float* __restrict__ origin,     // [Np, 3]
                   const float* __restrict__ inv_dir,    // [Np, 3]
                   const float* __restrict__ group_lo,   // [G, 3]
                   const float* __restrict__ group_hi,   // [G, 3]
                   const float* __restrict__ leaf_lo,    // [L, 3]
                   const float* __restrict__ leaf_hi,    // [L, 3]
                   const int* __restrict__ leaf_count,   // [L]
                   const float4* __restrict__ feat,      // [L, K, 10] x float4
                   int num_groups, int num_keys, int num_leaves, int leaf_size,
                   int gs,
                   float* __restrict__ t_out,            // [Np] closest
                   int* __restrict__ slot_out,           // [Np] closest
                   uint8_t* __restrict__ blocked_out,    // [Np] occluded
                   int* __restrict__ ncand_out,          // [n_cta] or null
                   float* __restrict__ entry_out,        // [n_cta, G] or null
                   int* __restrict__ cand_out,           // [n_cta, G] or null
                   unsigned long long* list_scratch)     // [CTAs, num_keys] (global mode)
{
  extern __shared__ unsigned long long smem_keys[];  // [num_keys] (shared mode)
  unsigned long long* const keys =
      GLOBAL_LIST ? list_scratch + (size_t)blockIdx.x * num_keys : smem_keys;
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kThreads + tid;

  // ---- stage the CTA's rays ------------------------------------------------
  const float ox = origin[ray * 3 + 0], oy = origin[ray * 3 + 1],
              oz = origin[ray * 3 + 2];
  const float ix = inv_dir[ray * 3 + 0], iy = inv_dir[ray * 3 + 1],
              iz = inv_dir[ray * 3 + 2];
  const float limit = t_max[ray];
  const bool live = limit > 0.f;
  s.o[0][tid] = ox; s.o[1][tid] = oy; s.o[2][tid] = oz;
  s.inv[0][tid] = ix; s.inv[1][tid] = iy; s.inv[2][tid] = iz;
  s.bound[tid] = limit;
#pragma unroll
  for (int f = 0; f < 10; ++f) s.ray[f][tid] = rays[ray * 10 + f];
  // the initial key: a hit at exactly the bound is not below it
  const unsigned long long init =
      live ? (unsigned long long)__float_as_uint(limit) << 32 : 0ull;
  if (!OCCLUDED) s.best[tid] = init;
  if (tid == 0) s.ncand = 0;
  int parity = 0;
  const int n_live = cta_compact(live, s.list, s.cnt[parity], 0.f, nullptr,
                                 nullptr);
  parity ^= 1;

  if (n_live == 0) {  // uniform: every lane dead or padding
    if (OCCLUDED) {
      blocked_out[ray] = 0;
    } else {
      t_out[ray] = kTMax;
      slot_out[ray] = -1;
    }
    if (ncand_out != nullptr && tid == 0) ncand_out[blockIdx.x] = 0;
    if (entry_out != nullptr) {
      for (int i = tid; i < num_groups; i += kThreads) {
        entry_out[(size_t)blockIdx.x * num_groups + i] = kNoEntry;
        cand_out[(size_t)blockIdx.x * num_groups + i] = i;
      }
    }
    return;
  }
  __syncthreads();  // every live ray's index is in s.list

  // ---- (a) list phase: entries, keys, bitonic sort ---------------------------
  for (int i = tid; i < num_keys; i += kThreads) {
    unsigned long long key = ~0ull;  // padding sorts last
    if (i < num_groups) {
      const float lx = group_lo[i * 3 + 0], ly = group_lo[i * 3 + 1],
                  lz = group_lo[i * 3 + 2];
      const float hx = group_hi[i * 3 + 0], hy = group_hi[i * 3 + 1],
                  hz = group_hi[i * 3 + 2];
      float e = __int_as_float(0x7f800000);  // +inf
      for (int j = 0; j < n_live; ++j) {
        const int r = s.list[j];  // the same r across the warp: broadcast
        const float rox = s.o[0][r], roy = s.o[1][r], roz = s.o[2][r];
        const float rix = s.inv[0][r], riy = s.inv[1][r], riz = s.inv[2][r];
        const float t0x = (lx - rox) * rix, t1x = (hx - rox) * rix;
        const float t0y = (ly - roy) * riy, t1y = (hy - roy) * riy;
        const float t0z = (lz - roz) * riz, t1z = (hz - roz) * riz;
        const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                               fminf(t0z, t1z));
        const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                               fmaxf(t0z, t1z));
        if (tn <= tf && tf >= kTMin && tn < s.bound[r]) e = fminf(e, fmaxf(tn, 0.f));
      }
      // clear the sign bit: an entry of -0 sorts as +0
      key = (unsigned long long)(__float_as_uint(e) & 0x7fffffffu) << 32 |
            (unsigned)i;
    }
    keys[i] = key;
  }
  __syncthreads();
  for (int k = 2; k <= num_keys; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < num_keys; i += kThreads) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = keys[i], b = keys[p];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < num_keys; i += kThreads) {
    if (keys[i] < kInfKey && (i + 1 == num_keys || keys[i + 1] >= kInfKey))
      s.ncand = i + 1;
  }
  __syncthreads();
  const int nc = s.ncand;
  if (ncand_out != nullptr && tid == 0) ncand_out[blockIdx.x] = nc;
  if (entry_out != nullptr) {
    for (int i = tid; i < num_groups; i += kThreads) {
      const unsigned long long key = keys[i];
      entry_out[(size_t)blockIdx.x * num_groups + i] =
          key < kInfKey ? __uint_as_float((unsigned)(key >> 32)) : kNoEntry;
      cand_out[(size_t)blockIdx.x * num_groups + i] = (int)(key & 0xffffffffu);
    }
  }

  // ---- walk the list front to back ---------------------------------------------
  volatile unsigned long long* vbest = s.best;
  volatile float* vbound = s.bound;
  bool done = false;
  for (int c = 0; c < nc && !done; ++c) {
    const unsigned long long kc = keys[c];
    const float entry = __uint_as_float((unsigned)(kc >> 32));
    const int g = (int)(kc & 0xffffffffu);
    for (int m = 0; m < gs; ++m) {
      const int leaf = g * gs + m;
      if (leaf >= num_leaves) break;  // uniform: padded group members
      // per-ray slab pretest of the leaf box against the current best
      const float best = OCCLUDED ? vbound[tid]
                                  : __uint_as_float((unsigned)(vbest[tid] >> 32));
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
      float cta_best = 0.f;
      // (d) the early exit rides on the first member's compaction barrier
      const int n_want = cta_compact(want, s.list, s.cnt[parity], best,
                                     m == 0 ? s.wmax[parity] : nullptr,
                                     &cta_best);
      parity ^= 1;
      if (m == 0 && !(entry < cta_best)) {  // uniform
        done = true;
        break;
      }
      if (n_want == 0) continue;  // uniform
      const int n = leaf_count[leaf];
      const float4* src = feat + (size_t)leaf * leaf_size * 10;
      const int dk = kThreads / n_want, dw = kThreads - dk * n_want;
      for (int t0 = 0; t0 < n; t0 += kTile) {
        const int nt = min(kTile, n - t0);
        for (int i = tid; i < nt * 10; i += kThreads)
          s.tri[i % 10][i / 10] = src[(size_t)t0 * 10 + i];
        __syncthreads();  // the tile and the wanting rays are in place
        // (c) pairs p = k * n_want + w, ray index w fastest
        int k = tid / n_want, w = tid - k * n_want;
        int cur = -1;
        float r[10];
        for (int p = tid; p < n_want * nt; p += kThreads) {
          const int rr = s.list[w];
          if (rr != cur) {
            cur = rr;
#pragma unroll
            for (int f = 0; f < 10; ++f) r[f] = s.ray[f][rr];
          }
          float a = 0.f, u = 0.f, v = 0.f, t = 0.f;
#pragma unroll
          for (int f = 0; f < 10; ++f) {
            const float4 q = s.tri[f][k];
            a = fmaf(r[f], q.x, a);
            u = fmaf(r[f], q.y, u);
            v = fmaf(r[f], q.z, v);
            t = fmaf(r[f], q.w, t);
          }
          const float sg = a > 0.f ? 1.f : (a < 0.f ? -1.f : 0.f);
          const float abs_a = a * sg, su = u * sg, sv = v * sg, stn = t * sg;
          const bool valid = abs_a > 1e-12f && abs_a < 1e37f && su >= 0.f &&
                             sv >= 0.f && su + sv <= abs_a &&
                             stn > 1e-4f * abs_a;
          if (OCCLUDED) {
            if (valid && stn < vbound[rr] * abs_a) vbound[rr] = 0.f;
          } else if (valid) {
            const unsigned long long key =
                (unsigned long long)__float_as_uint(stn / abs_a) << 32 |
                (unsigned)(leaf * leaf_size + t0 + k);
            if (key < vbest[rr]) atomicMin(&s.best[rr], key);
          }
          w += dw;
          k += dk;
          if (w >= n_want) {
            w -= n_want;
            ++k;
          }
        }
        __syncthreads();  // commits land; the tile may be overwritten
      }
    }
  }

  if (OCCLUDED) {
    blocked_out[ray] = (vbound[tid] <= 0.f && live) ? 1 : 0;
  } else {
    const unsigned long long key = vbest[tid];
    const bool hit = key < init;
    t_out[ray] = hit ? __uint_as_float((unsigned)(key >> 32)) : kTMax;
    slot_out[ray] = hit ? (int)(key & 0xffffffffu) : -1;
  }
}

int list_keys(int num_groups) {
  int p = 1;
  while (p < num_groups) p <<= 1;
  return p;
}

// A null list_scratch launches the shared-memory list mode in one grid;
// otherwise the global mode, in chunks of scratch_ctas CTAs whose lists
// take turns in list_scratch ([scratch_ctas, list_keys(G)] keys).
template <bool OCCLUDED>
cudaError_t launch(const float* rays, const float* t_max, const float* origin,
                   const float* inv_dir, const float* group_lo,
                   const float* group_hi, const float* leaf_lo,
                   const float* leaf_hi, const int* leaf_count,
                   const float* feat, int num_ctas, int num_groups,
                   int num_leaves, int leaf_size, int gs, float* t_out,
                   int* slot_out, uint8_t* blocked_out, int* ncand_out,
                   float* entry_out, int* cand_out,
                   unsigned long long* list_scratch, int scratch_ctas,
                   cudaStream_t stream) {
  const int num_keys = list_keys(num_groups);
  const bool global = list_scratch != nullptr;
  if ((!global && num_keys > kMaxKeys) || (global && scratch_ctas < 1) || gs < 1 ||
      (entry_out == nullptr) != (cand_out == nullptr))
    return cudaErrorInvalidValue;
  const float4* feat4 = reinterpret_cast<const float4*>(feat);
  if (!global) {
    const size_t smem = (size_t)num_keys * sizeof(unsigned long long);
    cudaError_t e = cudaFuncSetAttribute(
        block_trace_kernel<OCCLUDED, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (num_ctas == 0) return cudaSuccess;
    block_trace_kernel<OCCLUDED, false><<<num_ctas, kThreads, smem, stream>>>(
        rays, t_max, origin, inv_dir, group_lo, group_hi, leaf_lo, leaf_hi,
        leaf_count, feat4, num_groups, num_keys, num_leaves, leaf_size, gs, t_out,
        slot_out, blocked_out, ncand_out, entry_out, cand_out, nullptr);
    return cudaGetLastError();
  }
  for (int c0 = 0; c0 < num_ctas; c0 += scratch_ctas) {
    const int n = num_ctas - c0 < scratch_ctas ? num_ctas - c0 : scratch_ctas;
    const size_t r0 = (size_t)c0 * kThreads;  // the chunk's first ray
    const size_t l0 = (size_t)c0 * num_groups;  // and its first list entry
    block_trace_kernel<OCCLUDED, true><<<n, kThreads, 0, stream>>>(
        rays + r0 * 10, t_max + r0, origin + r0 * 3, inv_dir + r0 * 3, group_lo,
        group_hi, leaf_lo, leaf_hi, leaf_count, feat4, num_groups, num_keys,
        num_leaves, leaf_size, gs, t_out ? t_out + r0 : nullptr,
        slot_out ? slot_out + r0 : nullptr, blocked_out ? blocked_out + r0 : nullptr,
        ncand_out ? ncand_out + c0 : nullptr, entry_out ? entry_out + l0 : nullptr,
        cand_out ? cand_out + l0 : nullptr, list_scratch);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <bool OCCLUDED, bool GLOBAL_LIST>
cudaError_t info(int num_groups, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, block_trace_kernel<OCCLUDED, GLOBAL_LIST>);
  if (e != cudaSuccess) return e;
  const size_t smem =
      GLOBAL_LIST ? 0 : (size_t)list_keys(num_groups) * sizeof(unsigned long long);
  e = cudaFuncSetAttribute(block_trace_kernel<OCCLUDED, GLOBAL_LIST>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, block_trace_kernel<OCCLUDED, GLOBAL_LIST>, kThreads, smem);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  out[4] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // namespace

extern "C" cudaError_t block_trace_closest(
    const float* rays, const float* t_max, const float* origin,
    const float* inv_dir, const float* group_lo, const float* group_hi,
    const float* leaf_lo, const float* leaf_hi, const int* leaf_count,
    const float* feat, int num_ctas, int num_groups, int num_leaves,
    int leaf_size, int gs, float* t_out, int* slot_out, int* ncand_out,
    float* entry_out, int* cand_out, unsigned long long* list_scratch,
    int scratch_ctas, void* stream) {
  return launch<false>(rays, t_max, origin, inv_dir, group_lo, group_hi,
                       leaf_lo, leaf_hi, leaf_count, feat, num_ctas,
                       num_groups, num_leaves, leaf_size, gs, t_out, slot_out,
                       nullptr, ncand_out, entry_out, cand_out, list_scratch,
                       scratch_ctas, static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t block_trace_occluded(
    const float* rays, const float* t_max, const float* origin,
    const float* inv_dir, const float* group_lo, const float* group_hi,
    const float* leaf_lo, const float* leaf_hi, const int* leaf_count,
    const float* feat, int num_ctas, int num_groups, int num_leaves,
    int leaf_size, int gs, uint8_t* blocked_out, int* ncand_out,
    float* entry_out, int* cand_out, unsigned long long* list_scratch,
    int scratch_ctas, void* stream) {
  return launch<true>(rays, t_max, origin, inv_dir, group_lo, group_hi,
                      leaf_lo, leaf_hi, leaf_count, feat, num_ctas, num_groups,
                      num_leaves, leaf_size, gs, nullptr, nullptr, blocked_out,
                      ncand_out, entry_out, cand_out, list_scratch, scratch_ctas,
                      static_cast<cudaStream_t>(stream));
}

// Registers, static and dynamic shared memory, resident CTAs per SM and
// local (spill) bytes of one instantiation at a list of num_groups groups,
// in the shared (global_list = 0) or the global list mode.
extern "C" cudaError_t block_trace_info(int occluded, int global_list, int num_groups,
                                        int* out) {
  if (global_list)
    return occluded ? info<true, true>(num_groups, out) : info<false, true>(num_groups, out);
  return occluded ? info<true, false>(num_groups, out) : info<false, false>(num_groups, out);
}
