// miniBUDE `fasten` energy kernel, written by hand for Hopper (sm_90a): the
// pair constants hoisted out of the interaction loop, a block's poses split
// over protein slices, and a combine in a fixed order.
//
// Replaces the Pallas TPU kernel repro/kernels/minibude/kernel.py::fasten_tiled,
// which lays 128 poses on the lanes and protein atoms on the sublanes and
// evaluates every branch of the energy model as a vector select.
//
// What bounds it on the H100: operations.  bm1 (938 protein atoms, 26 ligand
// atoms, 65536 poses) is 1.6e9 (ligand atom, protein atom, pose)
// interactions, each a distance (three differences, a squared norm, a
// precise sqrtf) and the three terms of the energy, against a deck of ~30 KB
// and 1.8 MB of poses: bytes never matter, issue slots do.
//
// What the design does about it:
//
//   1. The pair constants.  Everything that depends on the (ligand atom,
//      protein atom) pair only, and not on the pose, is computed once per pair
//      (pair_constants below: the IEEE division 1 / radij, the cut-off radii,
//      the charge with type E's sign folded in and CNSTNT multiplied in
//      first, the desolvation factor with its never-true cases folded to 0)
//      into two float4 a pair, by bude_pair_kernel, into a (natlig, natpro)
//      table in device memory that the energy kernel stages: 1.5 us at bm1
//      on an H100.  (Each block computing its own chunk of the table in a
//      prologue measured 2.5% slower there, and was dropped.)
//   2. fasten_kernel.  A block holds 32 * PPWI poses; lane l of every warp
//      holds poses base + i * 32 + l (i < PPWI), so loads of the poses and
//      stores of the energies are coalesced and the tail is masked.  Its
//      `split` warps all hold the same poses: warp w runs protein atoms
//      [w * natpro / split, (w + 1) * natpro / split).  The block computes
//      its poses' transforms once into shared memory; for each ligand atom a
//      warp moves it under its poses (12 FMAs a pose) and stages, with the
//      whole block, its slice's pair constants and protein rows into shared
//      memory (at most kStage rows a block at a time), which it then reads as
//      warp-wide broadcasts.  The interaction loop is left with the per-pose
//      part only: the distance, and each of the three terms as one clamp and
//      one FMA (branch-free, every cut-off of the model kept exactly).
//   3. The combine.  Each warp's per-pose sums go to shared memory and warp 0
//      adds them in warp order and writes 0.5 * etot: no atomics, and two
//      calls give the same bits.
//
// Why the folds and the clamps are exact (tests/test_torch_minibude.py
// checks each claim bit for bit against the reference's formulas):
//   - The charge factor f = (zone1 ? 1 : 1 - distbb * elcdst1) *
//     [distbb < elcdst] is >= 0: elcdst1 = 1 / elcdst is a power of two, so
//     distbb * elcdst1 is exact and below 1 exactly when distbb < elcdst.
//     Rounding is odd-symmetric, so -|chrg_init * f| = (-|chrg_init|) * f bit
//     for bit, and f = saturate(1 - distbb * elcdst1): above 1 in zone 1
//     (distbb < 0), at most 0 from elcdst on.
//   - The desolvation condition distbb < distdslv && phphb != 0 never holds
//     when phphb == 0, nor when distdslv = -FLOAT_MAX (distbb >= -radij):
//     those pairs get a factor of 0.  For distdslv 1 and 5.5, with
//     r = fl(1 / distdslv), distdslv * r >= 1 and pred(distdslv) * r < 1 (the
//     products exact), so the fused 1 - distbb * r is > 0 exactly for
//     distbb < distdslv: (zone1 ? 1 : coeff) * [distbb < distdslv] =
//     saturate(coeff), bit for bit.
//   - The steric term 2 HARDNESS (1 - distij / radij) in zone 1 is
//     -2 HARDNESS / radij * min(distbb, 0): the same zone (distbb < 0), the
//     same value in exact arithmetic, and a rounding of its own (the
//     reference's 1 - distij * r_radij cancels to a few bits near the
//     boundary; this form does not).
//   - CNSTNT multiplies the pair's charge before the factor, where the
//     reference multiplies after it: a rounding choice inside the tolerance.
//
// Offsets are 32-bit: the kernels index the poses up to 6 * nposes and the
// atoms' rows up to 4 * natpro and 4 * natlig as int, and the wrapper
// (kernel.py::check_deck) refuses a deck past that.
//
// Numerics: precise math only (sinf/cosf/sqrtf, IEEE division; the build has
// no --use_fast_math; __saturatef and fminf are clamps).  nvcc's default
// -fmad=true contracts products into FMAs.  A pose's energy is summed per
// slice over its protein atoms, then over ligand atoms, then over slices in
// order, so it differs from the plain version by float32 rounding, inside
// the reference's tolerance (rtol 2e-4, atol 2e-3).  The order depends on
// `split` alone: staging a slice a chunk at a time keeps its atoms' order.
//
// SASS instructions an interaction takes in the innermost loop (_sass.py:
// the loop's instructions over its MUFU.RSQ, one a sqrtf), sm_90a, with the
// H100 host's toolkit: the earlier kernel (a thread's poses against every
// pair, the set-up with its division in the loop) at its default ppwi 1,
// 73.5-76.5 in its three loop versions; this kernel at its default (ppwi 4,
// split 8), 29.0, the sqrtf's range check and its slow-path branch among
// them.  A first form with the earlier selects in place of the clamps took
// more.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr float kHbtypeF = 70.0f;
constexpr float kHbtypeE = 69.0f;
constexpr float kHard2 = 2.0f * 38.0f;  // TWO * HARDNESS
constexpr float kCnstnt = 45.0f;
constexpr float kNpnpdist = 5.5f;
constexpr float kNppdist = 1.0f;
constexpr float kNegFloatMax = -1e30f;
constexpr int kMaxSplit = 8;  // warps a block
constexpr int kStage = 1024;  // pair rows a block stages at a time

// a (n, 4) float32 row; scalar loads, because a caller's tensor need not be
// 16-byte aligned
__device__ __forceinline__ float4 row4(const float* __restrict__ p, int i) {
  return make_float4(p[4 * i], p[4 * i + 1], p[4 * i + 2], p[4 * i + 3]);
}

// The pose-independent constants of the pair (ligand atom with params lq,
// protein atom with params pq), rows (hbtype, radius, hphb, elsc):
//   a = (radij, 1 / radij, elcdst, elcdst1)
//   b = (distdslv, 1 / distdslv, CNSTNT * +-chrg_init, dslv_init or 0)
__device__ __forceinline__ void pair_constants(float4 pq, float4 lq, float4* a,
                                               float4* b) {
  const float radij = pq.y + lq.y;
  const bool both_f = pq.x == kHbtypeF && lq.x == kHbtypeF;
  const bool type_e = pq.x == kHbtypeE || lq.x == kHbtypeE;
  const bool p_ltz = pq.z < 0.0f, p_gtz = pq.z > 0.0f;
  const bool l_ltz = lq.z < 0.0f, l_gtz = lq.z > 0.0f;
  const float p_hphb_s = (p_ltz && l_gtz) ? -pq.z : pq.z;
  const float l_hphb_s = (p_gtz && l_ltz) ? -lq.z : lq.z;
  const float distdslv = p_ltz ? (l_ltz ? kNpnpdist : kNppdist)
                               : (l_ltz ? kNppdist : kNegFloatMax);
  // compile-time reciprocals: the same correctly rounded values as a division
  const float r_distdslv = p_ltz ? (l_ltz ? 1.0f / kNpnpdist : 1.0f / kNppdist)
                                 : (l_ltz ? 1.0f / kNppdist : 1.0f / kNegFloatMax);
  const float chrg_init = lq.w * pq.w;
  const float chrg = (type_e ? -fabsf(chrg_init) : chrg_init) * kCnstnt;
  const float dslv = (pq.z != 0.0f && distdslv != kNegFloatMax)
                         ? p_hphb_s + l_hphb_s : 0.0f;
  *a = make_float4(radij, 1.0f / radij, both_f ? 4.0f : 2.0f,
                   both_f ? 0.25f : 0.5f);
  *b = make_float4(distdslv, r_distdslv, chrg, dslv);
}

// table[2 * (il * natpro + ip) + {0, 1}] = the pair's (a, b)
__global__ void bude_pair_kernel(const float* __restrict__ ppar,
                                 const float* __restrict__ lpar,
                                 float4* __restrict__ table, int natpro,
                                 int natlig) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= static_cast<long long>(natpro) * natlig) return;
  const int il = static_cast<int>(t / natpro);
  const int ip = static_cast<int>(t - static_cast<long long>(il) * natpro);
  pair_constants(row4(ppar, ip), row4(lpar, il), &table[2 * t],
                 &table[2 * t + 1]);
}

template <int PPWI>
__global__ void __launch_bounds__(32 * kMaxSplit)
fasten_kernel(const float* __restrict__ ppos, const float* __restrict__ lpos,
              const float4* __restrict__ table, const float* __restrict__ poses,
              float* __restrict__ out, int natpro, int natlig, int nposes,
              int split, int chunk) {
  constexpr int kPoses = 32 * PPWI;  // a block's poses
  extern __shared__ float4 smem[];
  const int staged = split * chunk;
  float4* s_a = smem;           // [staged] pair constants a
  float4* s_b = s_a + staged;   // [staged] pair constants b
  float4* s_p = s_b + staged;   // [staged] protein xyz
  float* s_m = reinterpret_cast<float*>(s_p + staged);  // [12][kPoses]
  float* s_part = s_m + 12 * kPoses;                    // [split][kPoses]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kPoses;

  // the rows of each pose's (3, 4) transform, once per block
  for (int t = threadIdx.x; t < kPoses; t += blockDim.x) {
    const int ix = base + t;
    const bool valid = ix < nposes;
    const float ax = valid ? poses[ix] : 0.0f;
    const float ay = valid ? poses[nposes + ix] : 0.0f;
    const float az = valid ? poses[2 * nposes + ix] : 0.0f;
    const float sx = sinf(ax), cx = cosf(ax);
    const float sy = sinf(ay), cy = cosf(ay);
    const float sz = sinf(az), cz = cosf(az);
    float* m = s_m + t;
    m[0 * kPoses] = cy * cz;
    m[1 * kPoses] = sx * sy * cz - cx * sz;
    m[2 * kPoses] = cx * sy * cz + sx * sz;
    m[3 * kPoses] = valid ? poses[3 * nposes + ix] : 0.0f;
    m[4 * kPoses] = cy * sz;
    m[5 * kPoses] = sx * sy * sz + cx * cz;
    m[6 * kPoses] = cx * sy * sz - sx * cz;
    m[7 * kPoses] = valid ? poses[4 * nposes + ix] : 0.0f;
    m[8 * kPoses] = -sy;
    m[9 * kPoses] = sx * cy;
    m[10 * kPoses] = cx * cy;
    m[11 * kPoses] = valid ? poses[5 * nposes + ix] : 0.0f;
  }

  // this warp's protein slice; the staged rows of slice w are
  // s_*[w * chunk, (w + 1) * chunk), `chunk` atoms of the slice at a time
  const int lo = static_cast<int>(static_cast<long long>(warp) * natpro / split);
  const int hi =
      static_cast<int>(static_cast<long long>(warp + 1) * natpro / split);
  const int nchunks = ((natpro + split - 1) / split + chunk - 1) / chunk;
  const float4* my_a = s_a + warp * chunk;
  const float4* my_b = s_b + warp * chunk;
  const float4* my_p = s_p + warp * chunk;

  float etot[PPWI];
#pragma unroll
  for (int i = 0; i < PPWI; ++i) etot[i] = 0.0f;
  __syncthreads();

  for (int il = 0; il < natlig; ++il) {
    const float l0 = lpos[4 * il], l1 = lpos[4 * il + 1], l2 = lpos[4 * il + 2];
    float lx[PPWI], ly[PPWI], lz[PPWI], e[PPWI];
#pragma unroll
    for (int i = 0; i < PPWI; ++i) {
      const float* m = s_m + i * 32 + lane;
      lx[i] = m[0] * l0 + m[kPoses] * l1 + m[2 * kPoses] * l2 + m[3 * kPoses];
      ly[i] = m[4 * kPoses] * l0 + m[5 * kPoses] * l1 + m[6 * kPoses] * l2 +
              m[7 * kPoses];
      lz[i] = m[8 * kPoses] * l0 + m[9 * kPoses] * l1 + m[10 * kPoses] * l2 +
              m[11 * kPoses];
      e[i] = 0.0f;
    }
    for (int c = 0; c < nchunks; ++c) {
      __syncthreads();  // the previous chunk is read
      // protein rows do not depend on the ligand atom: with one chunk they
      // are staged once
      const bool rows = nchunks > 1 || il == 0;
      for (int t = threadIdx.x; t < staged; t += blockDim.x) {
        const int w = t / chunk;
        const int ip = static_cast<int>(static_cast<long long>(w) * natpro /
                                        split) + c * chunk + (t - w * chunk);
        if (ip >= static_cast<int>(static_cast<long long>(w + 1) * natpro /
                                   split))
          continue;
        const float4* pair =
            table + 2 * (static_cast<long long>(il) * natpro + ip);
        s_a[t] = pair[0];
        s_b[t] = pair[1];
        if (rows)
          s_p[t] = make_float4(ppos[4 * ip], ppos[4 * ip + 1], ppos[4 * ip + 2],
                               0.0f);
      }
      __syncthreads();

      const int n = min(chunk, hi - lo - c * chunk);
      for (int j = 0; j < n; ++j) {
        const float4 pa = my_a[j];  // (radij, r_radij, elcdst, elcdst1)
        const float4 pb = my_b[j];  // (distdslv, r_distdslv, chrg, dslv)
        const float4 pp = my_p[j];
        const float hard = -kHard2 * pa.y;  // -2 HARDNESS / radij
#pragma unroll
        for (int i = 0; i < PPWI; ++i) {
          const float dx = lx[i] - pp.x;
          const float dy = ly[i] - pp.y;
          const float dz = lz[i] - pp.z;
          const float distbb = sqrtf(dx * dx + dy * dy + dz * dz) - pa.x;
          // steric, zone 1 only: 2 HARDNESS (1 - distij / radij)
          e[i] = fmaf(hard, fminf(distbb, 0.0f), e[i]);
          // charge: 1 in zone 1, then 1 - distbb / elcdst, 0 from elcdst
          e[i] = fmaf(pb.z, __saturatef(fmaf(-distbb, pa.w, 1.0f)), e[i]);
          // desolvation: 1 in zone 1, then 1 - distbb / distdslv, 0 from
          // distdslv
          e[i] = fmaf(pb.w, __saturatef(fmaf(-distbb, pb.y, 1.0f)), e[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PPWI; ++i) etot[i] += e[i];
  }

  // the slices' sums, added by warp 0 in warp order
  if (split > 1) {
    if (warp > 0) {
#pragma unroll
      for (int i = 0; i < PPWI; ++i)
        s_part[warp * kPoses + i * 32 + lane] = etot[i];
    }
    __syncthreads();
    if (warp == 0) {
      for (int w = 1; w < split; ++w) {
#pragma unroll
        for (int i = 0; i < PPWI; ++i)
          etot[i] += s_part[w * kPoses + i * 32 + lane];
      }
    }
  }
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < PPWI; ++i) {
      const int ix = base + i * 32 + lane;
      if (ix < nposes) out[ix] = etot[i] * 0.5f;
    }
  }
}

template <int PPWI>
int launch(const float* ppos, const float* lpos, const float4* table,
           const float* poses, float* out, int natpro, int natlig, int nposes,
           int split, cudaStream_t stream) {
  constexpr int kPoses = 32 * PPWI;
  const int slice = (natpro + split - 1) / split;
  const int chunk = std::max(1, std::min(slice, kStage / split));
  const size_t smem = sizeof(float4) * 3 * split * chunk +
                      sizeof(float) * (12 + split) * kPoses;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fasten_kernel<PPWI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((nposes + kPoses - 1) / kPoses));
  fasten_kernel<PPWI><<<grid, 32 * split, smem, stream>>>(
      ppos, lpos, table, poses, out, natpro, natlig, nposes, split, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or -1 for a
// PPWI without an instantiation, a split outside [1, 8], or a null `table`
// for a deck with pairs.  bude_pair_kernel writes the pair constants into
// `table` (natlig * natpro * 2 float4 of scratch) and the energy kernel
// stages them.  The caller checks shapes, dtype, contiguity and sizes
// (kernel.py::check_deck): (natpro, 4), (natpro, 4), (natlig, 4),
// (natlig, 4) and (6, nposes) float32 inputs and an (nposes,) float32
// output on the current device, nposes >= 1.
extern "C" int fasten_f32(const float* ppos, const float* ppar,
                          const float* lpos, const float* lpar,
                          const float* poses, void* table, float* out,
                          int natpro, int natlig, int nposes, int ppwi,
                          int split, cudaStream_t stream) {
  if (split < 1 || split > kMaxSplit) return -1;
  auto* tab = static_cast<float4*>(table);
  const long long pairs = static_cast<long long>(natpro) * natlig;
  if (pairs > 0) {
    if (tab == nullptr) return -1;
    constexpr int kThreads = 256;
    bude_pair_kernel<<<static_cast<unsigned>((pairs + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(ppar, lpar, tab, natpro, natlig);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (ppwi) {
    case 1:
      return launch<1>(ppos, lpos, tab, poses, out, natpro, natlig, nposes,
                       split, stream);
    case 2:
      return launch<2>(ppos, lpos, tab, poses, out, natpro, natlig, nposes,
                       split, stream);
    case 4:
      return launch<4>(ppos, lpos, tab, poses, out, natpro, natlig, nposes,
                       split, stream);
    case 8:
      return launch<8>(ppos, lpos, tab, poses, out, natpro, natlig, nposes,
                       split, stream);
    case 16:
      return launch<16>(ppos, lpos, tab, poses, out, natpro, natlig, nposes,
                        split, stream);
    default:
      return -1;
  }
}

extern "C" const char* fasten_error_string(int err) {
  if (err == -1)
    return "no kernel instantiated for this ppwi and split, or no pair table";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
