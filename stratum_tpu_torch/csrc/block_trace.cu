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
//       bound in shared memory. A group's entry is the minimum over the
//       CTA's live rays of the slab formula of ops/packet.py::_block_entries
//       (t_min 1e-4, t_clip = the ray's bound; subtract, multiply, min and
//       max only, so the entries equal the plain version's bit for bit). The
//       reached (entry, group) pairs are sorted front to back as packed
//       64-bit keys (entry bits << 32) | group by a bitonic sort padded to a
//       power of two: entries are >= 0 or +inf and the padding is ~0, so the
//       key order is the stable order of ops/block_trace.py::candidate_lists
//       and ncand = the finite keys. A lane with bound 0 (dead, or padding)
//       can never commit and adds no entry; a CTA with no live ray writes
//       misses and returns before the list phase. Two list modes:
//       * shared (CULLED = false; up to kMaxKeys keys, 4,096 groups; the
//         wrapper takes it up to 512, ops/block_trace.py AUTO_SHARED_KEYS):
//         a thread per group computes every group's entry and the CTA sorts
//         all G keys (padded) in dynamic shared memory (32 KB at most).
//       * culled (CULLED = true; any group count): a coarse level of
//         super-groups, super_size consecutive groups each (SAH leaves are
//         stored in tree order, so they are spatially coherent), whose boxes
//         are the exact min / max of their members' (ops/block_trace.py::
//         super_boxes; padded members inverted). Pass A: a thread per
//         super-group runs the slab test for the live rays until one
//         reaches it, in tiles of 128 super-groups; the reached ones are
//         compacted with ballot and prefix. Pass B: threads over the members
//         of the reached super-groups compute their entries as the shared
//         mode does and append only the finite keys through a shared-memory
//         counter. The CTA sorts those ncand keys, padded to a power of two,
//         in shared memory (cap_keys of them at most) and walks them from
//         there. The append order varies from run to run; the keys are
//         distinct (the group is in the low bits), so the sorted list does
//         not.
//         The culling is conservative in f32. A member's box lies inside its
//         super-group's box (min / max are exact). For a fixed ray, both
//         roundings of the slab formula are monotone: fl(x - o) does not
//         decrease as x grows, and fl(y * inv) does not decrease in y for
//         inv > 0, does not increase for inv < 0, and is +-0 for inv = 0
//         (the safe inverse of a zero or tiny negative component; +-0
//         compare equal). So on each axis the super-group's
//         [min(t0, t1), max(t0, t1)] contains the member's, hence tn_super
//         <= tn_member and tf_super >= tf_member, and a member that passes
//         tn <= tf, tf >= t_min, tn < t_clip makes its super-group pass
//         them: no reached group is culled. (Finite boxes and origins keep
//         fl(x - o) finite, so no 0 x inf NaN arises.)
//         Overflow: a CTA whose reached keys exceed cap_keys (the counter
//         keeps counting past it) falls back to the full pass: every
//         group's entry, all list_keys(G) keys sorted by the same network in
//         its own row of a global scratch buffer, which the walk then reads.
//         The scratch holds the rows of scratch_ctas CTAs (the wrapper sizes
//         it to 512 MB, ops/block_trace.py LIST_SCRATCH_BYTES) and the host
//         launches a wave in chunks of that many CTAs, one after another on
//         the stream, each reusing the buffer; no host synchronisation
//         decides anything. force_overflow sends every CTA down that path
//         (the global list mode of earlier versions, kept for checks).
//       Under stats the kernel writes each CTA's ncand, its overflow flag
//       and the clock64 cycles of its list phase (from its start, staging
//       included) and of its walk (0 and 0 for a CTA without a live ray),
//       and, for the
//       whole lists, its sorted entries and groups followed by the groups
//       it does not reach in ascending order with entry kNoEntry (the
//       culled mode recomputes those for the stats only).
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
// features stay in the 50 MB L2. The shared list mode adds G slab tests per
// live ray and a sort of G keys per CTA; the culled mode G / super_size
// tests per live ray (fewer: pass A stops at the first ray that reaches)
// plus super_size tests per reached super-group, and a sort of only the
// reached keys.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;             // rays per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                 // triangles per staged tile
constexpr int kMaxKeys = 4096;            // shared mode: list keys per CTA (32 KB)
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
  int sub[kThreads];               // culled mode: reached super-groups of a tile
  int cnt[2][kWarps];              // per-warp counts, double-buffered
  float wmax[2][kWarps];           // per-warp max best, double-buffered
  int ncand;
  int nkeys;                       // culled mode: reached keys appended
  long long clock[2];              // stats: the CTA's start, its list phase's end
};

// The CTA's shared state, at namespace scope so that the helpers below
// address it directly.
__shared__ Shared s;

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

struct Box {
  float lx, ly, lz, hx, hy, hz;
};

__device__ __forceinline__ Box load_box(const float* __restrict__ lo,
                                        const float* __restrict__ hi, int i) {
  return Box{lo[i * 3 + 0], lo[i * 3 + 1], lo[i * 3 + 2],
             hi[i * 3 + 0], hi[i * 3 + 1], hi[i * 3 + 2]};
}

// A box's entry for the CTA: the minimum over its n_live live rays (listed
// in s.list; the same ray across the warp, so a broadcast) of max(tn, 0)
// where the ray enters the box below its bound (and leaves it past t_min),
// +inf if none does. ANY: 0 at the first ray that enters (a reach test).
// The body is the shared mode's inner loop as it stood before the culled
// mode was added, word for word: the same test through a helper returning
// bool compiled slower on the H100.
template <bool ANY>
__device__ __forceinline__ float box_entry(int n_live, const Box& b) {
  const float lx = b.lx, ly = b.ly, lz = b.lz, hx = b.hx, hy = b.hy, hz = b.hz;
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
    if (tn <= tf && tf >= kTMin && tn < s.bound[r]) {
      if (ANY) return 0.f;
      e = fminf(e, fmaxf(tn, 0.f));
    }
  }
  return e;
}

// A list key: the entry's bits (sign cleared: -0 sorts as +0) over the group.
__device__ __forceinline__ unsigned long long list_key(float e, int g) {
  return (unsigned long long)(__float_as_uint(e) & 0x7fffffffu) << 32 | (unsigned)g;
}

// Ascending bitonic sort of n keys (a power of two) by the CTA; ends on a
// barrier.
__device__ __forceinline__ void bitonic_sort(unsigned long long* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += kThreads) {
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
}

template <bool OCCLUDED, bool CULLED>
__global__ void __launch_bounds__(kThreads, kMinCtas)
block_trace_kernel(const float* __restrict__ rays,       // [Np, 10] features
                   const float* __restrict__ t_max,      // [Np]
                   const float* __restrict__ origin,     // [Np, 3]
                   const float* __restrict__ inv_dir,    // [Np, 3]
                   const float* __restrict__ group_lo,   // [G, 3]
                   const float* __restrict__ group_hi,   // [G, 3]
                   const float* __restrict__ super_lo,   // [S, 3] (culled mode)
                   const float* __restrict__ super_hi,   // [S, 3] (culled mode)
                   const float* __restrict__ leaf_lo,    // [L, 3]
                   const float* __restrict__ leaf_hi,    // [L, 3]
                   const int* __restrict__ leaf_count,   // [L]
                   const float4* __restrict__ feat,      // [L, K, 10] x float4
                   int num_groups, int num_keys, int num_super, int super_size,
                   int cap_keys, int force_overflow, int num_leaves, int leaf_size,
                   int gs,
                   float* __restrict__ t_out,            // [Np] closest
                   int* __restrict__ slot_out,           // [Np] closest
                   uint8_t* __restrict__ blocked_out,    // [Np] occluded
                   int* __restrict__ ncand_out,          // [n_cta] or null
                   float* __restrict__ entry_out,        // [n_cta, G] or null
                   int* __restrict__ cand_out,           // [n_cta, G] or null
                   long long* __restrict__ cta_out,      // [n_cta, 3] or null
                   unsigned long long* list_scratch)     // [CTAs, num_keys] (culled)
{
  // shared mode: [num_keys]; culled mode: [cap_keys]
  extern __shared__ unsigned long long smem_keys[];
  const int tid = threadIdx.x;
  // stats: clocks kept in shared memory, not in registers across the walk
  if (cta_out != nullptr && tid == 0) s.clock[0] = clock64();
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
  if (tid == 0) {
    s.ncand = 0;
    s.nkeys = 0;
  }
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
      const size_t row = (size_t)blockIdx.x * num_groups;
      for (int i = tid; i < num_groups; i += kThreads) {
        entry_out[row + i] = kNoEntry;
        cand_out[row + i] = i;
      }
    }
    if (cta_out != nullptr && tid == 0) {  // no list phase, no walk
      cta_out[blockIdx.x * 3 + 0] = 0;
      cta_out[blockIdx.x * 3 + 1] = 0;
      cta_out[blockIdx.x * 3 + 2] = 0;
    }
    return;
  }
  __syncthreads();  // every live ray's index is in s.list

  // ---- (a) list phase ----------------------------------------------------------
  unsigned long long* keys = smem_keys;
  bool overflow = false;
  int nc = 0;
  if (CULLED) {
    overflow = force_overflow != 0;
    if (!overflow) {
      // pass A: super-groups in tiles of kThreads; pass B: their members
      for (int base = 0; base < num_super; base += kThreads) {
        const bool reached =
            base + tid < num_super &&
            box_entry<true>(n_live, load_box(super_lo, super_hi, base + tid)) == 0.f;
        const int n_sub = cta_compact(reached, s.sub, s.cnt[parity], 0.f, nullptr,
                                      nullptr);
        parity ^= 1;
        __syncthreads();  // s.sub in place
        for (int p = tid; p < n_sub * super_size; p += kThreads) {
          const int q = p / super_size;
          const int g = (base + s.sub[q]) * super_size + (p - q * super_size);
          if (g >= num_groups) continue;
          const float e = box_entry<false>(n_live, load_box(group_lo, group_hi, g));
          if (e < __int_as_float(0x7f800000)) {
            const int at = atomicAdd(&s.nkeys, 1);
            if (at < cap_keys) keys[at] = list_key(e, g);
          }
        }
        // the next tile's compaction barrier orders these reads of s.sub
        // before its writes
      }
      __syncthreads();
      nc = s.nkeys;
      overflow = nc > cap_keys;  // uniform
      if (!overflow) {
        int n = 1;
        while (n < nc) n <<= 1;
        for (int i = nc + tid; i < n; i += kThreads) keys[i] = ~0ull;  // sorts last
        __syncthreads();
        bitonic_sort(keys, n);
      }
    }
    if (overflow) keys = list_scratch + (size_t)blockIdx.x * num_keys;
  }
  if (!CULLED || overflow) {
    // every group's entry; all num_keys keys sorted (shared mode: in
    // shared memory; an overflowing CTA: in its scratch row)
    for (int i = tid; i < num_keys; i += kThreads) {
      unsigned long long key = ~0ull;  // padding sorts last
      if (i < num_groups) key = list_key(box_entry<false>(n_live, load_box(group_lo, group_hi, i)), i);
      keys[i] = key;
    }
    __syncthreads();
    bitonic_sort(keys, num_keys);
    for (int i = tid; i < num_keys; i += kThreads) {
      if (keys[i] < kInfKey && (i + 1 == num_keys || keys[i + 1] >= kInfKey))
        s.ncand = i + 1;
    }
    __syncthreads();
    nc = s.ncand;
  }
  if (cta_out != nullptr && tid == 0) s.clock[1] = clock64();
  if (ncand_out != nullptr && tid == 0) ncand_out[blockIdx.x] = nc;
  if (entry_out != nullptr) {
    const size_t row = (size_t)blockIdx.x * num_groups;  // the CTA's stats row
    if (CULLED && !overflow) {
      // the reached groups, sorted; then the others in ascending order
      for (int i = tid; i < nc; i += kThreads) {
        entry_out[row + i] = __uint_as_float((unsigned)(keys[i] >> 32));
        cand_out[row + i] = (int)(keys[i] & 0xffffffffu);
      }
      int done = nc;
      for (int base = 0; base < num_groups; base += kThreads) {
        const int g = base + tid;
        const bool miss = g < num_groups &&
            !(box_entry<false>(n_live, load_box(group_lo, group_hi, g)) <
              __int_as_float(0x7f800000));
        const int n_miss = cta_compact(miss, s.sub, s.cnt[parity], 0.f, nullptr, nullptr);
        parity ^= 1;
        __syncthreads();  // s.sub in place
        if (tid < n_miss) {
          entry_out[row + done + tid] = kNoEntry;
          cand_out[row + done + tid] = base + s.sub[tid];
        }
        done += n_miss;
      }
    } else {
      for (int i = tid; i < num_groups; i += kThreads) {
        const unsigned long long key = keys[i];
        entry_out[row + i] =
            key < kInfKey ? __uint_as_float((unsigned)(key >> 32)) : kNoEntry;
        cand_out[row + i] = (int)(key & 0xffffffffu);
      }
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

  if (cta_out != nullptr && tid == 0) {
    cta_out[blockIdx.x * 3 + 0] = overflow ? 1 : 0;
    cta_out[blockIdx.x * 3 + 1] = s.clock[1] - s.clock[0];
    cta_out[blockIdx.x * 3 + 2] = clock64() - s.clock[1];
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

bool power_of_two(int n) { return n > 0 && (n & (n - 1)) == 0; }

// Dynamic shared memory of a launch: the shared mode's list_keys(G) keys,
// or the culled mode's cap_keys.
size_t list_smem(bool culled, int num_groups, int cap_keys) {
  return (size_t)(culled ? cap_keys : list_keys(num_groups)) * sizeof(unsigned long long);
}

// A null list_scratch launches the shared list mode in one grid; otherwise
// the culled mode, in chunks of scratch_ctas CTAs whose overflow rows take
// turns in list_scratch ([scratch_ctas, list_keys(G)] keys).
template <bool OCCLUDED>
cudaError_t launch(const float* rays, const float* t_max, const float* origin,
                   const float* inv_dir, const float* group_lo,
                   const float* group_hi, const float* super_lo,
                   const float* super_hi, const float* leaf_lo,
                   const float* leaf_hi, const int* leaf_count,
                   const float* feat, int num_ctas, int num_groups, int num_super,
                   int super_size, int cap_keys, int force_overflow,
                   int num_leaves, int leaf_size, int gs, float* t_out,
                   int* slot_out, uint8_t* blocked_out, int* ncand_out,
                   float* entry_out, int* cand_out, long long* cta_out,
                   unsigned long long* list_scratch, int scratch_ctas,
                   cudaStream_t stream) {
  const int num_keys = list_keys(num_groups);
  const bool culled = list_scratch != nullptr;
  if ((!culled && num_keys > kMaxKeys) || gs < 1 ||
      (culled && (scratch_ctas < 1 || super_size < 1 || !power_of_two(cap_keys) ||
                  super_lo == nullptr || super_hi == nullptr ||
                  num_super != (num_groups + super_size - 1) / super_size)) ||
      (entry_out == nullptr) != (cand_out == nullptr))
    return cudaErrorInvalidValue;
  const float4* feat4 = reinterpret_cast<const float4*>(feat);
  const size_t smem = list_smem(culled, num_groups, cap_keys);
  if (!culled) {
    cudaError_t e = cudaFuncSetAttribute(
        block_trace_kernel<OCCLUDED, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (num_ctas == 0) return cudaSuccess;
    block_trace_kernel<OCCLUDED, false><<<num_ctas, kThreads, smem, stream>>>(
        rays, t_max, origin, inv_dir, group_lo, group_hi, nullptr, nullptr, leaf_lo,
        leaf_hi, leaf_count, feat4, num_groups, num_keys, 0, 1, 0, 0, num_leaves,
        leaf_size, gs, t_out, slot_out, blocked_out, ncand_out, entry_out, cand_out,
        cta_out, nullptr);
    return cudaGetLastError();
  }
  cudaError_t e = cudaFuncSetAttribute(block_trace_kernel<OCCLUDED, true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  for (int c0 = 0; c0 < num_ctas; c0 += scratch_ctas) {
    const int n = num_ctas - c0 < scratch_ctas ? num_ctas - c0 : scratch_ctas;
    const size_t r0 = (size_t)c0 * kThreads;  // the chunk's first ray
    const size_t l0 = (size_t)c0 * num_groups;  // and its first list entry
    block_trace_kernel<OCCLUDED, true><<<n, kThreads, smem, stream>>>(
        rays + r0 * 10, t_max + r0, origin + r0 * 3, inv_dir + r0 * 3, group_lo,
        group_hi, super_lo, super_hi, leaf_lo, leaf_hi, leaf_count, feat4, num_groups,
        num_keys, num_super, super_size, cap_keys, force_overflow, num_leaves,
        leaf_size, gs, t_out ? t_out + r0 : nullptr, slot_out ? slot_out + r0 : nullptr,
        blocked_out ? blocked_out + r0 : nullptr, ncand_out ? ncand_out + c0 : nullptr,
        entry_out ? entry_out + l0 : nullptr, cand_out ? cand_out + l0 : nullptr,
        cta_out ? cta_out + (size_t)c0 * 3 : nullptr, list_scratch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <bool OCCLUDED, bool CULLED>
cudaError_t info(int num_groups, int cap_keys, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, block_trace_kernel<OCCLUDED, CULLED>);
  if (e != cudaSuccess) return e;
  const size_t smem = list_smem(CULLED, num_groups, cap_keys);
  e = cudaFuncSetAttribute(block_trace_kernel<OCCLUDED, CULLED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, block_trace_kernel<OCCLUDED, CULLED>, kThreads, smem);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  out[4] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // namespace

// list_scratch null: the shared list mode; else the culled mode (super_lo /
// super_hi: num_super boxes of super_size groups; cap_keys a power of two;
// force_overflow != 0 sends every CTA to its scratch row).
extern "C" cudaError_t block_trace_closest(
    const float* rays, const float* t_max, const float* origin,
    const float* inv_dir, const float* group_lo, const float* group_hi,
    const float* super_lo, const float* super_hi, const float* leaf_lo,
    const float* leaf_hi, const int* leaf_count, const float* feat, int num_ctas,
    int num_groups, int num_super, int super_size, int cap_keys, int force_overflow,
    int num_leaves, int leaf_size, int gs, float* t_out, int* slot_out, int* ncand_out,
    float* entry_out, int* cand_out, long long* cta_out,
    unsigned long long* list_scratch, int scratch_ctas, void* stream) {
  return launch<false>(rays, t_max, origin, inv_dir, group_lo, group_hi, super_lo,
                       super_hi, leaf_lo, leaf_hi, leaf_count, feat, num_ctas,
                       num_groups, num_super, super_size, cap_keys, force_overflow,
                       num_leaves, leaf_size, gs, t_out, slot_out, nullptr, ncand_out,
                       entry_out, cand_out, cta_out, list_scratch, scratch_ctas,
                       static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t block_trace_occluded(
    const float* rays, const float* t_max, const float* origin,
    const float* inv_dir, const float* group_lo, const float* group_hi,
    const float* super_lo, const float* super_hi, const float* leaf_lo,
    const float* leaf_hi, const int* leaf_count, const float* feat, int num_ctas,
    int num_groups, int num_super, int super_size, int cap_keys, int force_overflow,
    int num_leaves, int leaf_size, int gs, uint8_t* blocked_out, int* ncand_out,
    float* entry_out, int* cand_out, long long* cta_out,
    unsigned long long* list_scratch, int scratch_ctas, void* stream) {
  return launch<true>(rays, t_max, origin, inv_dir, group_lo, group_hi, super_lo,
                      super_hi, leaf_lo, leaf_hi, leaf_count, feat, num_ctas, num_groups,
                      num_super, super_size, cap_keys, force_overflow, num_leaves,
                      leaf_size, gs, nullptr, nullptr, blocked_out, ncand_out, entry_out,
                      cand_out, cta_out, list_scratch, scratch_ctas,
                      static_cast<cudaStream_t>(stream));
}

// Registers, static and dynamic shared memory, resident CTAs per SM and
// local (spill) bytes of one instantiation at a list of num_groups groups,
// in the shared (culled = 0) or the culled mode (cap_keys keys in shared
// memory).
extern "C" cudaError_t block_trace_info(int occluded, int culled, int num_groups,
                                        int cap_keys, int* out) {
  if (culled)
    return occluded ? info<true, true>(num_groups, cap_keys, out)
                    : info<false, true>(num_groups, cap_keys, out);
  return occluded ? info<true, false>(num_groups, cap_keys, out)
                  : info<false, false>(num_groups, cap_keys, out);
}
