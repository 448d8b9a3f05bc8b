// Binned pair-stream tracer for Hopper (sm_90a): the emission kernel, which
// gives every group of g rays its passing leaves, and the bin step (K5),
// which runs each bin's lanes against the bin's leaf and folds each lane's
// closest hit into its ray's answer.
//
// binned_emit_kernel replaces the reference's emission, the jnp emit_slice
// of stratum_tpu/ops/binned.py::_binned_trace (a lax.scan over 64-leaf
// chunks inside lax.map; not a Pallas kernel, outside the bin kernel only
// because the TPU grid needs its bins fixed before launch).
// binned_min_kernel (K5) replaces the TPU kernel
// stratum_tpu/ops/binned.py::_bin_kernel, reached through _binned_trace's
// pl.pallas_call from pallas_closest_binned and pallas_occluded_binned. Both
// compute what the reference computes, not a block-by-block copy of it.
//
// Emission (one thread per ray, 128 rays per CTA; g divides 128):
//   * The leaf boxes, and the box of every chunk of 32 consecutive leaves,
//     sit in shared memory, a tile of `tile` leaves at a time, in leaf
//     order. Where every box fits (759 leaves: 18.8 KB; up to ~9,400 leaves
//     at g = 8, pcap = 16) there is one tile of all L leaves; past the
//     227 KB a CTA may use, the wrapper picks tiles of a multiple of 32
//     leaves (ops/binned.py EMIT_TILE), so the chunks and their order are
//     the same and the tiles change no bit. A thread tests its own
//     ray (em="ray") or its group's interval (em="group", whose per-group
//     bounds come from shuffles, and through shared memory for g = 64, 128)
//     against a chunk box first; only a chunk that some ray of the warp (of
//     the CTA at g > 32) passes is tested leaf by leaf. A leaf's box lies
//     inside its chunk's, and the slab formula uses only subtract, multiply,
//     min, max and compares, each monotone under rounding, so a ray that
//     misses a chunk box misses every leaf in it: the skip changes no bit.
//     The skip is decided per chunk, so per tile.
//   * The 32 leaf bits of a chunk form a mask; the group's masks are OR-ed
//     (shuffles, then shared memory for g > 32), and the group's first lane
//     appends the set bits in ascending leaf order while the count is below
//     pcap. The count is raw (uncapped). A CTA writes its groups' slot rows
//     as one contiguous block. Nothing is contracted into an FMA, so count
//     and slots equal ops/binned.py::_emit bit for bit.
//   * Dead lanes (bound 0) pass nothing; warps (CTAs at g > 32) with no live
//     group skip the leaf loop, and a CTA with no live lane writes empty
//     rows before it stages any box (the dead tail of a sorted wave).
//   What bounds it: slab tests, ~27 operations each (FP32 throughput); the
//   rays and boxes are read once (28 B a ray), the slot table written once
//   (each CTA reads every box once per tile, from L2).
//
// Bin step, K5 (128 threads per CTA, a run of kRun consecutive bins):
//   * A run's bins are consecutive, so they share one leaf (bins of a leaf
//     are consecutive); a run that spans leaves takes them one at a time.
//   * Pretest: a lane whose own ray fails the emission's slab test of the
//     leaf box against its bound (dead lanes, lanes whose ray misses the
//     box or enters it beyond the bound) does nothing. The wanting lanes of
//     the run are compacted (ballot and prefix) into a list of ray ids.
//   * The leaf is visited once per kPass wanting lanes (once per run unless
//     more than kPass lanes want it): only its leaf_count real triangles
//     (the padding sits at each leaf's tail), streamed through shared memory
//     in 64-triangle tiles with cp.async double buffering (20 KB), the next
//     tile loading while the current one is tested. The pass's rays are
//     staged feature-major in shared memory first (a pair's g rays are g
//     consecutive rows, so the loads are coalesced); a thread takes lanes
//     t and t + 128 of the pass and holds each one's features in registers
//     while it runs the tile.
//   * Exact f32: a, u, v, t are 10-term FMA chains in the order of
//     csrc/block_trace.cu, with the reference accept rule (_mt_classify); t
//     is the exact quotient and slots are int32 (leaf * K + k). The TPU
//     kernel's bf16-split matmul and packed argmin do not exist here.
//   * The resolve is fused: a lane's (t, slot) goes into its ray's 64-bit
//     word by atomicMin((t bits << 32) | slot). Positive f32 bit patterns
//     order like their values, so the minimum is the closest hit with the
//     lower slot on equal t, whatever order the lanes land in; within a
//     lane the strict compare keeps the lower k.
//   What bounds it: the (ray, triangle) tests of the wanting lanes, 40 FMAs
//   plus ~15 compare/select operations each, against tile features that a
//   warp reads at one address (broadcast): FP32 throughput. Device memory
//   traffic is small (68 B of ray data per lane; the atrium's 31 MB of
//   features stay in the 50 MB L2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;  // lanes per bin; threads per CTA of both kernels
constexpr int kWarps = kLanes / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 32;            // leaves per emission mask and chunk box
constexpr float kBig = 3.0e38f;       // bounds of an empty group interval
constexpr int kGroupVals = 13;        // o_lo, i_lo, o_hi, i_hi (3 each), tb_max
constexpr int kMaxSmem = 227 * 1024;  // shared memory a CTA may use
constexpr int kTile = 64;             // triangles per staged tile
constexpr int kRun = 4;               // bins per K5 CTA (binned_info reports it)
constexpr int kPass = 2 * kLanes;     // wanting lanes per leaf visit (and this)
constexpr int kMinCtas = 6;           // resident K5 CTAs asked of ptxas

// The emission's per-ray slab test (ops/binned.py::_slab_pass).
__device__ __forceinline__ bool slab_pass(float lx, float ly, float lz, float hx,
                                          float hy, float hz, const float* o,
                                          const float* iv, float tb, float t_min) {
  const float t0x = (lx - o[0]) * iv[0], t1x = (hx - o[0]) * iv[0];
  const float t0y = (ly - o[1]) * iv[1], t1y = (hy - o[1]) * iv[1];
  const float t0z = (lz - o[2]) * iv[2], t1z = (hz - o[2]) * iv[2];
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fmaxf(fminf(t0z, t1z), 0.f));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return tn <= tf && tf >= t_min && tn < tb;
}

// Interval of (b - o) * i over o in [ol, oh], i in [il, ih].
__device__ __forceinline__ void interval(float b, float ol, float oh, float il,
                                         float ih, float& mn, float& mx) {
  const float u_lo = b - oh, u_hi = b - ol;
  const float p1 = u_lo * il, p2 = u_lo * ih, p3 = u_hi * il, p4 = u_hi * ih;
  mn = fminf(fminf(p1, p2), fminf(p3, p4));
  mx = fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
}

// The group interval test (ops/binned.py::_pass_group) of one box, whose
// lo and hi sit `stride` floats apart per axis in `box` (hi 3 axes later).
__device__ __forceinline__ bool group_pass(const float* box, int stride,
                                           const float* gv, float t_min) {
  float tn = 0.f, tf = kBig;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float mn0, mx0, mn1, mx1;
    interval(box[a * stride], gv[a], gv[6 + a], gv[3 + a], gv[9 + a], mn0, mx0);
    interval(box[(3 + a) * stride], gv[a], gv[6 + a], gv[3 + a], gv[9 + a], mn1, mx1);
    tn = fmaxf(tn, fminf(mn0, mn1));
    tf = fminf(tf, fmaxf(mx0, mx1));
  }
  return tn <= tf && tf >= t_min && tn < gv[12];
}

__device__ __forceinline__ bool ray_pass(const float* box, int stride, const float* o,
                                         const float* iv, float tb, float t_min) {
  return slab_pass(box[0], box[stride], box[2 * stride], box[3 * stride],
                   box[4 * stride], box[5 * stride], o, iv, tb, t_min);
}

// Dynamic shared memory of an emission CTA that holds `tile` leaf boxes.
size_t emit_smem(int tile, int g, int pcap) {
  const int chunks = (tile + kChunk - 1) / kChunk;
  return (size_t)24 * (tile + chunks) + (size_t)4 * (kLanes / g) * pcap;
}

__global__ void __launch_bounds__(kLanes)
binned_emit_kernel(const float* __restrict__ origin,   // [num_rays, 3]
                   const float* __restrict__ inv_dir,  // [num_rays, 3]
                   const float* __restrict__ t_bound,  // [num_rays]
                   const float* __restrict__ leaf_lo,  // [L, 3]
                   const float* __restrict__ leaf_hi,  // [L, 3]
                   int num_rays, int num_leaves, int tile, int g, int pcap,
                   int group_mode, float t_min,
                   int* __restrict__ count,            // [num_rays / g]
                   int* __restrict__ slots)            // [num_rays / g, pcap]
{
  extern __shared__ float sm[];
  // a tile of T leaves (all L, or a multiple of kChunk) and its CT chunks
  const int L = num_leaves, T = tile, CT = (T + kChunk - 1) / kChunk;
  float* box = sm;                                     // [6][T]: lo x y z, hi x y z
  float* cbox = sm + 6 * T;                            // [6][CT] chunk boxes
  int* sslot = reinterpret_cast<int*>(cbox + 6 * CT);  // [128 / g][pcap]
  __shared__ float sred[kGroupVals][kWarps];
  __shared__ unsigned sor[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gpc = kLanes / g;           // groups per CTA
  const int lig = tid & (g - 1);        // lane in group (g is a power of two)
  const int grp = tid / g;              // group in CTA
  const bool wide = g > 32;             // a group spans warps
  const int seg = min(g, 32);
  const int w0 = grp * (g / 32);        // a wide group's first warp
  const int grp0 = blockIdx.x * gpc;
  const int ngl = min(gpc, num_rays / g - grp0);  // the CTA's groups

  const int ray = blockIdx.x * kLanes + tid;
  const float tb = ray < num_rays ? t_bound[ray] : 0.f;
  const bool alive = tb > 0.f;
  if (!__syncthreads_or(alive)) {  // uniform: no live lane, nothing to emit
    if (lig == 0 && grp < ngl) count[grp0 + grp] = 0;
    for (int i = tid; i < ngl * pcap; i += kLanes) slots[(size_t)grp0 * pcap + i] = -1;
    return;
  }

  for (int i = tid; i < gpc * pcap; i += kLanes) sslot[i] = -1;

  float o[3] = {0.f, 0.f, 0.f}, iv[3] = {0.f, 0.f, 0.f};
  if (ray < num_rays) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[a] = origin[(size_t)ray * 3 + a];
      iv[a] = inv_dir[(size_t)ray * 3 + a];
    }
  }
  // the group's bounds over its live lanes, and its largest bound
  float gv[kGroupVals];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    gv[a] = alive ? o[a] : kBig;
    gv[3 + a] = alive ? iv[a] : kBig;
    gv[6 + a] = alive ? o[a] : -kBig;
    gv[9 + a] = alive ? iv[a] : -kBig;
  }
  gv[12] = tb;
  for (int off = 1; off < seg; off <<= 1) {
#pragma unroll
    for (int k = 0; k < kGroupVals; ++k) {
      const float x = __shfl_xor_sync(kFull, gv[k], off);
      gv[k] = k < 6 ? fminf(gv[k], x) : fmaxf(gv[k], x);
    }
  }
  if (wide) {  // uniform
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kGroupVals; ++k) sred[k][warp] = gv[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kGroupVals; ++k) {
      float v = sred[k][w0];
      for (int w = w0 + 1; w < w0 + g / 32; ++w)
        v = k < 6 ? fminf(v, sred[k][w]) : fmaxf(v, sred[k][w]);
      gv[k] = v;
    }
  }
  const bool glive = gv[12] > 0.f;  // the group has a live lane
  const bool active = wide ? __syncthreads_or(glive) : __any_sync(kFull, glive);
  int cnt = 0;  // kept by the group's first lane
  for (int t0 = 0; t0 < L; t0 += T) {  // the tiles, in leaf order
    const int nl_t = min(T, L - t0), nc = (nl_t + kChunk - 1) / kChunk;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < 3 * nl_t; i += kLanes) {
      const int l = i / 3, a = i - 3 * l;
      box[a * T + l] = leaf_lo[(size_t)t0 * 3 + i];
      box[(3 + a) * T + l] = leaf_hi[(size_t)t0 * 3 + i];
    }
    __syncthreads();  // leaf boxes (and, first time, slot rows) in place
    for (int c = tid; c < nc; c += kLanes) {
      const int l0 = c * kChunk, l1 = min(l0 + kChunk, nl_t);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float mn = box[a * T + l0], mx = box[(3 + a) * T + l0];
        for (int l = l0 + 1; l < l1; ++l) {
          mn = fminf(mn, box[a * T + l]);
          mx = fmaxf(mx, box[(3 + a) * T + l]);
        }
        cbox[a * CT + c] = mn;
        cbox[(3 + a) * CT + c] = mx;
      }
    }
    __syncthreads();  // chunk boxes in place
    if (!active) continue;  // uniform over the warp (the CTA when wide)
    for (int c = 0; c < nc; ++c) {
      bool pc = false;
      if (glive)
        pc = group_mode ? group_pass(cbox + c, CT, gv, t_min)
                        : alive && ray_pass(cbox + c, CT, o, iv, tb, t_min);
      if (!(wide ? __syncthreads_or(pc) : __any_sync(kFull, pc))) continue;
      const int l0 = c * kChunk, nl = min(kChunk, nl_t - l0);
      unsigned m = 0;
      if (pc) {
        if (group_mode) {
          for (int j = lig; j < nl; j += g)
            if (group_pass(box + l0 + j, T, gv, t_min)) m |= 1u << j;
        } else {
          for (int j = 0; j < nl; ++j)
            if (ray_pass(box + l0 + j, T, o, iv, tb, t_min)) m |= 1u << j;
        }
      }
      for (int off = 1; off < seg; off <<= 1) m |= __shfl_xor_sync(kFull, m, off);
      if (wide) {
        if (lane == 0) sor[warp] = m;
        __syncthreads();
        m = 0;
        for (int w = w0; w < w0 + g / 32; ++w) m |= sor[w];
      }
      if (lig == 0) {
        while (m) {
          const int b = __ffs(m) - 1;
          m &= m - 1;
          if (cnt < pcap) sslot[grp * pcap + cnt] = t0 + l0 + b;
          ++cnt;
        }
      }
    }
  }
  __syncthreads();  // slot rows complete
  if (lig == 0 && grp < ngl) count[grp0 + grp] = cnt;
  for (int i = tid; i < ngl * pcap; i += kLanes) slots[(size_t)grp0 * pcap + i] = sslot[i];
}

struct BinShared {
  float4 tile[2][kTile * 10];  // double-buffered tiles, [k][feature]
  float ray[10][kPass];        // the pass's ray features, feature-major
  int list[kRun * kLanes];     // the run's wanting lanes' rays
  int cnt[2][kWarps];          // per-warp counts, double-buffered
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of triangles [t0, t0 + nt) of a leaf into a tile buffer.
__device__ __forceinline__ void load_tile(float4* dst, const float4* leaf, int t0, int nt) {
  for (int i = threadIdx.x; i < nt * 10; i += kLanes)
    cp_async16(dst + i, leaf + (size_t)t0 * 10 + i);
  cp_async_commit();
}

// Appends `value` of the threads whose `pred` holds, in thread order, to
// list[]; returns their count (one barrier). list[] is written after the
// barrier, so its readers need another one. Callers alternate the two `cnt`
// buffers, so a thread still reading one use's counts is never overtaken.
__device__ __forceinline__ int cta_append(bool pred, int value, int* list, int* cnt) {
  const unsigned ballot = __ballot_sync(kFull, pred);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) cnt[warp] = __popc(ballot);
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = cnt[w];
    base += w < warp ? c : 0;
    total += c;
  }
  if (pred) list[base + __popc(ballot & ((1u << lane) - 1u))] = value;
  return total;
}

__global__ void __launch_bounds__(kLanes, kMinCtas)
binned_min_kernel(const int* __restrict__ bin_leaf,    // [num_bins]
                  const int* __restrict__ pair_id,     // [num_bins * 128 / g]
                  const float* __restrict__ rays,      // [num_rays, 10]
                  const float* __restrict__ origin,    // [num_rays, 3]
                  const float* __restrict__ inv_dir,   // [num_rays, 3]
                  const float* __restrict__ t_bound,   // [num_rays]
                  const float* __restrict__ leaf_lo,   // [L, 3]
                  const float* __restrict__ leaf_hi,   // [L, 3]
                  const int* __restrict__ leaf_count,  // [L]
                  const float4* __restrict__ feat,     // [L, K, 10] x float4
                  int num_bins, int num_rays, int leaf_size, int g, int pcap,
                  float t_min,
                  unsigned long long* __restrict__ words)  // [num_rays]
{
  __shared__ BinShared s;
  const int tid = threadIdx.x;
  const int run_end = min((int)blockIdx.x * kRun + kRun, num_bins);
  int parity = 0;
  for (int b0 = blockIdx.x * kRun; b0 < run_end;) {
    const int leaf = bin_leaf[b0];  // uniform
    int b1 = b0 + 1;
    while (b1 < run_end && bin_leaf[b1] == leaf) ++b1;
    const int n = leaf < 0 ? 0 : leaf_count[leaf];
    if (n == 0) {  // an empty bin (or leaf): misses only
      b0 = b1;
      continue;
    }
    const float box[6] = {leaf_lo[leaf * 3 + 0], leaf_lo[leaf * 3 + 1], leaf_lo[leaf * 3 + 2],
                          leaf_hi[leaf * 3 + 0], leaf_hi[leaf * 3 + 1], leaf_hi[leaf * 3 + 2]};
    // pretest every lane of the bins [b0, b1), keep the wanting ones' rays
    int n_want = 0;
    for (int b = b0; b < b1; ++b) {
      const int pid = pair_id[b * (kLanes / g) + tid / g];
      const int ray = pid < 0 ? num_rays : (pid / pcap) * g + tid % g;
      bool want = false;
      if (ray < num_rays) {
        const float o[3] = {origin[(size_t)ray * 3], origin[(size_t)ray * 3 + 1],
                            origin[(size_t)ray * 3 + 2]};
        const float iv[3] = {inv_dir[(size_t)ray * 3], inv_dir[(size_t)ray * 3 + 1],
                             inv_dir[(size_t)ray * 3 + 2]};
        want = ray_pass(box, 1, o, iv, t_bound[ray], t_min);
      }
      n_want += cta_append(want, ray, s.list + n_want, s.cnt[parity]);
      parity ^= 1;
    }
    __syncthreads();  // the list is complete

    const float4* src = feat + (size_t)leaf * leaf_size * 10;
    const int ntiles = (n + kTile - 1) / kTile;
    for (int p0 = 0; p0 < n_want; p0 += kPass) {  // uniform
      const int np = min(kPass, n_want - p0);
      load_tile(s.tile[0], src, 0, min(kTile, n));  // in flight while the rays stage
      for (int i = tid; i < np * 10; i += kLanes) {
        const int e = i / 10, f = i - 10 * e;
        s.ray[f][e] = rays[(size_t)s.list[p0 + e] * 10 + f];
      }
      int my_ray[2];
      float best[2];
      int best_k[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = tid + j * kLanes;
        my_ray[j] = e < np ? s.list[p0 + e] : -1;
        best[j] = __int_as_float(0x7f800000);  // +inf
        best_k[j] = -1;
      }
      for (int it = 0; it < ntiles; ++it) {
        if (it + 1 < ntiles) {
          load_tile(s.tile[(it + 1) & 1], src, (it + 1) * kTile, min(kTile, n - (it + 1) * kTile));
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // tile `it` (and, first time, the rays) in place
        const float4* q = s.tile[it & 1];
        const int t0 = it * kTile, nt = min(kTile, n - t0);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (my_ray[j] < 0) continue;
          float r[10];
#pragma unroll
          for (int f = 0; f < 10; ++f) r[f] = s.ray[f][tid + j * kLanes];
          for (int k = 0; k < nt; ++k) {
            float a = 0.f, u = 0.f, v = 0.f, t = 0.f;
#pragma unroll
            for (int f = 0; f < 10; ++f) {
              const float4 w = q[k * 10 + f];
              a = fmaf(r[f], w.x, a);
              u = fmaf(r[f], w.y, u);
              v = fmaf(r[f], w.z, v);
              t = fmaf(r[f], w.w, t);
            }
            const float sg = a > 0.f ? 1.f : (a < 0.f ? -1.f : 0.f);
            const float abs_a = a * sg, su = u * sg, sv = v * sg, stn = t * sg;
            const bool valid = abs_a > 1e-12f && abs_a < 1e37f && su >= 0.f &&
                               sv >= 0.f && su + sv <= abs_a && stn > 1e-4f * abs_a;
            if (valid) {
              const float tt = stn / abs_a;
              if (tt < best[j]) {  // strict: the lower k keeps an equal t
                best[j] = tt;
                best_k[j] = t0 + k;
              }
            }
          }
        }
        __syncthreads();  // the buffer may be refilled
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (best_k[j] >= 0) {
          const unsigned long long word =
              ((unsigned long long)__float_as_uint(best[j]) << 32) |
              (unsigned int)(leaf * leaf_size + best_k[j]);
          atomicMin(words + my_ray[j], word);
        }
      }
    }
    b0 = b1;
  }
}

}  // namespace

// tile_leaves: leaf boxes a CTA holds at a time; at least num_leaves for
// one tile of all of them, else a multiple of kChunk.
extern "C" cudaError_t binned_emit(const float* origin, const float* inv_dir,
                                   const float* t_bound, const float* leaf_lo,
                                   const float* leaf_hi, int num_rays, int num_leaves,
                                   int tile_leaves, int g, int pcap, int group_mode,
                                   float t_min, int* count, int* slots, void* stream) {
  if (g < 1 || kLanes % g != 0 || pcap < 1 || num_rays % g != 0 || tile_leaves < 1 ||
      (tile_leaves < num_leaves && tile_leaves % kChunk != 0))
    return cudaErrorInvalidValue;
  const int tile = tile_leaves < num_leaves ? tile_leaves : num_leaves;
  const size_t smem = emit_smem(tile, g, pcap);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      binned_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (num_rays == 0) return cudaSuccess;
  binned_emit_kernel<<<(num_rays + kLanes - 1) / kLanes, kLanes, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      origin, inv_dir, t_bound, leaf_lo, leaf_hi, num_rays, num_leaves, tile, g, pcap,
      group_mode, t_min, count, slots);
  return cudaGetLastError();
}

extern "C" cudaError_t binned_min(const int* bin_leaf, const int* pair_id,
                                  const float* rays, const float* origin,
                                  const float* inv_dir, const float* t_bound,
                                  const float* leaf_lo, const float* leaf_hi,
                                  const int* leaf_count, const float* feat,
                                  int num_bins, int num_rays, int leaf_size, int g,
                                  int pcap, float t_min, unsigned long long* words,
                                  void* stream) {
  if (g < 1 || kLanes % g != 0) return cudaErrorInvalidValue;
  if (num_bins == 0) return cudaSuccess;
  binned_min_kernel<<<(num_bins + kRun - 1) / kRun, kLanes, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      bin_leaf, pair_id, rays, origin, inv_dir, t_bound, leaf_lo, leaf_hi, leaf_count,
      reinterpret_cast<const float4*>(feat), num_bins, num_rays, leaf_size, g, pcap,
      t_min, words);
  return cudaGetLastError();
}

// Registers, static and dynamic shared memory, resident CTAs per SM and
// local (spill) bytes of K5 (emit = 0) or of the emission kernel at tiles
// of tile_leaves leaves, g and pcap (emit = 1); then K5's kRun and kPass.
extern "C" cudaError_t binned_info(int emit, int tile_leaves, int g, int pcap, int* out) {
  cudaFuncAttributes attr;
  size_t smem = 0;
  int blocks = 0;
  cudaError_t e;
  if (emit) {
    if (g < 1 || kLanes % g != 0 || pcap < 1) return cudaErrorInvalidValue;
    smem = emit_smem(tile_leaves, g, pcap);
    e = cudaFuncSetAttribute(binned_emit_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, binned_emit_kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, binned_emit_kernel, kLanes, smem);
  } else {
    e = cudaFuncGetAttributes(&attr, binned_min_kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, binned_min_kernel, kLanes, 0);
  }
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  out[4] = (int)attr.localSizeBytes;
  out[5] = kRun;
  out[6] = kPass;
  return cudaSuccess;
}
