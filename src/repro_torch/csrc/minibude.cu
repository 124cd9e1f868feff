// miniBUDE `fasten` energy kernel, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/minibude/kernel.py::fasten_tiled,
// which lays 128 poses on the lanes and protein atoms on the sublanes and
// evaluates every branch of the energy model as a vector select.
//
// What bounds it on the H100: operations.  Each (ligand atom, protein atom,
// pose) interaction is ~30 floating-point operations, a precise sqrtf and a
// dozen compares and selects, against a few bytes of input per pose: the
// deck is ~30 KB, so bytes never matter.  Per (ligand, protein) pair there is
// also a precise IEEE division (1 / radij) and a few selects shared by all of
// a thread's poses.
//
// What the design does about it: the plain GPU form of the open-source
// miniBUDE kernel.  Each thread holds PPWI poses in registers and computes
// their twelve transform terms once.  The block stages the protein and ligand
// rows (8 floats an atom: 938 atoms = 30 KB at bm1) in shared memory, where
// every warp reads the same row at once (a broadcast).  The loops run ligand
// atoms, then protein atoms, then the thread's poses, so the pair setup is
// paid once per PPWI interactions; one energy per pose accumulates in
// registers and 0.5 * etot is written once.  Poses p of block b are
// b*blockDim*PPWI + i*blockDim + threadIdx (i < PPWI), so loads of the poses
// and stores of the energies are coalesced; the tail past nposes is masked.
//
// Numerics: precise math only (sinf/cosf/sqrtf, IEEE division; the build has
// no --use_fast_math).  The branches follow _fasten_body exactly, including
// -|chrg_e| for type E and r_distdslv = 1 / -1e30 (the three reciprocals are
// compile-time constants, the same correctly rounded values as a division at
// run time).  Each ligand atom's interactions are summed over the protein
// first and then added to the pose's total, in the reference's order; the
// sum runs sequentially over the protein, and nvcc's default -fmad=true
// contracts products into FMAs, so a pose differs from the plain version by
// float32 rounding, inside the reference's tolerance (rtol 2e-4, atol 2e-3).

#include <cuda_runtime.h>

namespace {

constexpr float kHbtypeF = 70.0f;
constexpr float kHbtypeE = 69.0f;
constexpr float kHard2 = 2.0f * 38.0f;  // TWO * HARDNESS
constexpr float kCnstnt = 45.0f;
constexpr float kNpnpdist = 5.5f;
constexpr float kNppdist = 1.0f;
constexpr float kNegFloatMax = -1e30f;

template <int PPWI>
__global__ void fasten_kernel(const float* __restrict__ ppos,
                              const float* __restrict__ ppar,
                              const float* __restrict__ lpos,
                              const float* __restrict__ lpar,
                              const float* __restrict__ poses,
                              float* __restrict__ out, int natpro, int natlig,
                              int nposes) {
  extern __shared__ float4 smem[];
  float4* s_ppos = smem;
  float4* s_ppar = s_ppos + natpro;
  float4* s_lpos = s_ppar + natpro;
  float4* s_lpar = s_lpos + natlig;
  // rows are (natpro, 4) and (natlig, 4) float32; scalar loads, because a
  // caller's tensor need not be 16-byte aligned
  for (int t = threadIdx.x; t < natpro; t += blockDim.x) {
    s_ppos[t] = make_float4(ppos[4 * t], ppos[4 * t + 1], ppos[4 * t + 2],
                            ppos[4 * t + 3]);
    s_ppar[t] = make_float4(ppar[4 * t], ppar[4 * t + 1], ppar[4 * t + 2],
                            ppar[4 * t + 3]);
  }
  for (int t = threadIdx.x; t < natlig; t += blockDim.x) {
    s_lpos[t] = make_float4(lpos[4 * t], lpos[4 * t + 1], lpos[4 * t + 2],
                            lpos[4 * t + 3]);
    s_lpar[t] = make_float4(lpar[4 * t], lpar[4 * t + 1], lpar[4 * t + 2],
                            lpar[4 * t + 3]);
  }
  __syncthreads();

  const int base = blockIdx.x * blockDim.x * PPWI + threadIdx.x;
  float m[PPWI][12];  // rows of the (3, 4) transform of each pose
  float etot[PPWI];
#pragma unroll
  for (int i = 0; i < PPWI; ++i) {
    const int ix = base + i * blockDim.x;
    const bool valid = ix < nposes;
    const float ax = valid ? poses[ix] : 0.0f;
    const float ay = valid ? poses[nposes + ix] : 0.0f;
    const float az = valid ? poses[2 * nposes + ix] : 0.0f;
    const float sx = sinf(ax), cx = cosf(ax);
    const float sy = sinf(ay), cy = cosf(ay);
    const float sz = sinf(az), cz = cosf(az);
    m[i][0] = cy * cz;
    m[i][1] = sx * sy * cz - cx * sz;
    m[i][2] = cx * sy * cz + sx * sz;
    m[i][3] = valid ? poses[3 * nposes + ix] : 0.0f;
    m[i][4] = cy * sz;
    m[i][5] = sx * sy * sz + cx * cz;
    m[i][6] = cx * sy * sz - sx * cz;
    m[i][7] = valid ? poses[4 * nposes + ix] : 0.0f;
    m[i][8] = -sy;
    m[i][9] = sx * cy;
    m[i][10] = cx * cy;
    m[i][11] = valid ? poses[5 * nposes + ix] : 0.0f;
    etot[i] = 0.0f;
  }

  for (int il = 0; il < natlig; ++il) {
    const float4 lp = s_lpos[il];
    const float4 lq = s_lpar[il];  // (hbtype, radius, hphb, elsc)
    const bool lhphb_ltz = lq.z < 0.0f;
    const bool lhphb_gtz = lq.z > 0.0f;
    float lx[PPWI], ly[PPWI], lz[PPWI], e[PPWI];
#pragma unroll
    for (int i = 0; i < PPWI; ++i) {
      lx[i] = m[i][0] * lp.x + m[i][1] * lp.y + m[i][2] * lp.z + m[i][3];
      ly[i] = m[i][4] * lp.x + m[i][5] * lp.y + m[i][6] * lp.z + m[i][7];
      lz[i] = m[i][8] * lp.x + m[i][9] * lp.y + m[i][10] * lp.z + m[i][11];
      e[i] = 0.0f;
    }

    for (int ip = 0; ip < natpro; ++ip) {
      const float4 pp = s_ppos[ip];
      const float4 pq = s_ppar[ip];  // (hbtype, radius, hphb, elsc)
      // pair setup, shared by the thread's poses
      const float radij = pq.y + lq.y;
      const float r_radij = 1.0f / radij;
      const bool both_f = pq.x == kHbtypeF && lq.x == kHbtypeF;
      const float elcdst = both_f ? 4.0f : 2.0f;
      const float elcdst1 = both_f ? 0.25f : 0.5f;
      const bool type_e = pq.x == kHbtypeE || lq.x == kHbtypeE;
      const bool phphb_ltz = pq.z < 0.0f;
      const bool phphb_gtz = pq.z > 0.0f;
      const bool phphb_nz = pq.z != 0.0f;
      const float p_hphb_s = pq.z * ((phphb_ltz && lhphb_gtz) ? -1.0f : 1.0f);
      const float l_hphb_s = lq.z * ((phphb_gtz && lhphb_ltz) ? -1.0f : 1.0f);
      const float distdslv = phphb_ltz ? (lhphb_ltz ? kNpnpdist : kNppdist)
                                       : (lhphb_ltz ? kNppdist : kNegFloatMax);
      const float r_distdslv =
          phphb_ltz ? (lhphb_ltz ? 1.0f / kNpnpdist : 1.0f / kNppdist)
                    : (lhphb_ltz ? 1.0f / kNppdist : 1.0f / kNegFloatMax);
      const float chrg_init = lq.w * pq.w;
      const float dslv_init = p_hphb_s + l_hphb_s;

#pragma unroll
      for (int i = 0; i < PPWI; ++i) {
        const float dx = lx[i] - pp.x;
        const float dy = ly[i] - pp.y;
        const float dz = lz[i] - pp.z;
        const float distij = sqrtf(dx * dx + dy * dy + dz * dz);
        const float distbb = distij - radij;
        const bool zone1 = distbb < 0.0f;

        const float e_steric = (1.0f - distij * r_radij) * (zone1 ? kHard2 : 0.0f);
        float chrg_e = chrg_init * ((zone1 ? 1.0f : (1.0f - distbb * elcdst1)) *
                                    (distbb < elcdst ? 1.0f : 0.0f));
        chrg_e = type_e ? -fabsf(chrg_e) : chrg_e;
        const float e_chrg = chrg_e * kCnstnt;

        const float coeff = 1.0f - distbb * r_distdslv;
        float dslv_e =
            dslv_init * ((distbb < distdslv && phphb_nz) ? 1.0f : 0.0f);
        dslv_e = dslv_e * (zone1 ? 1.0f : coeff);

        e[i] += e_steric + e_chrg + dslv_e;
      }
    }
#pragma unroll
    for (int i = 0; i < PPWI; ++i) etot[i] += e[i];
  }

#pragma unroll
  for (int i = 0; i < PPWI; ++i) {
    const int ix = base + i * blockDim.x;
    if (ix < nposes) out[ix] = etot[i] * 0.5f;
  }
}

template <int PPWI>
int launch(const float* ppos, const float* ppar, const float* lpos,
           const float* lpar, const float* poses, float* out, int natpro,
           int natlig, int nposes, int block, cudaStream_t stream) {
  const size_t smem = sizeof(float4) * 2 * (static_cast<size_t>(natpro) + natlig);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fasten_kernel<PPWI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long per_block = static_cast<long long>(block) * PPWI;
  const dim3 grid(static_cast<unsigned>((nposes + per_block - 1) / per_block));
  fasten_kernel<PPWI><<<grid, block, smem, stream>>>(
      ppos, ppar, lpos, lpar, poses, out, natpro, natlig, nposes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or -1 for a
// PPWI without an instantiation.  The caller checks shapes, dtype and
// contiguity: (natpro, 4), (natpro, 4), (natlig, 4), (natlig, 4) and (6,
// nposes) float32 inputs and an (nposes,) float32 output on the current
// device, nposes >= 1, and the shared rows within the block's limit.
extern "C" int fasten_f32(const float* ppos, const float* ppar,
                          const float* lpos, const float* lpar,
                          const float* poses, float* out, int natpro,
                          int natlig, int nposes, int ppwi, int block,
                          cudaStream_t stream) {
  switch (ppwi) {
    case 1:
      return launch<1>(ppos, ppar, lpos, lpar, poses, out, natpro, natlig,
                       nposes, block, stream);
    case 2:
      return launch<2>(ppos, ppar, lpos, lpar, poses, out, natpro, natlig,
                       nposes, block, stream);
    case 4:
      return launch<4>(ppos, ppar, lpos, lpar, poses, out, natpro, natlig,
                       nposes, block, stream);
    case 8:
      return launch<8>(ppos, ppar, lpos, lpar, poses, out, natpro, natlig,
                       nposes, block, stream);
    default:
      return -1;
  }
}

extern "C" const char* fasten_error_string(int err) {
  if (err == -1) return "no kernel instantiated for this ppwi";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
