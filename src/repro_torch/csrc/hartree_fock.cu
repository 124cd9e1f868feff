// Hartree-Fock two-electron Fock build (gather form), written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/hartree_fock/kernel.py::
// twoel_tiled and ::twoel_slab_tiled.  Both compute
//   F[i,j] = sum_{k, l in [l0, l0+nl)} sum_{g1..g4} c1 c2 c3 c4 D[k,l]
//            * (2 ssss(i,z1; j,z2 | k,z3; l,z4) - ssss(i,z1; k,z2 | j,z3; l,z4)),
// the full build being the slab l0 = 0, nl = N.  One kernel serves both.
//
// What bounds it on the H100: operations.  A quartet term costs two ssss
// integrals, each with two expf, an erff, three sqrtf and about ten IEEE
// divisions, against O(N^2) bytes of input for O(N^4 G^4) terms.
//
// What holds the simple form back is parallelism: N^2 outputs are only 4096
// at N = 64, and a thread per F[i,j] looping over N^2 G^4 terms would fill
// less than a warp per SM.  So a *team* of threads (a warp, or several as a
// tunable) computes one F[i,j]: its lanes stride the flattened enumeration
// idx = kl * G^4 + g of the reference's _quartet_term (k = kl / nl,
// l = l0 + kl % nl, g = ((g3 G + g4) G + g1) G + g2), then reduce in a fixed
// order (a shuffle butterfly in each warp, then the warps' partials in
// order).  There are no atomics: the result is the same bits on every run.
// Positions and the basis sit in shared memory; D[k,l] comes through the
// read-only cache.
//
// Numerics: precise expf/erff/sqrtf and IEEE division (the build has no
// --use_fast_math), in the reference's order of operations; nvcc's default
// -fmad=true contracts products into FMAs.  Each lane accumulates its terms
// in double and the team reduces in double, so the sum of ~10^6 terms adds
// no float32 rounding of its own; F is rounded to float32 once.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sq(float x) { return x * x; }

// F0 Boys function, series-guarded at t -> 0 (ref.boys_f0)
__device__ __forceinline__ float boys_f0(float t) {
  const float t_safe = fmaxf(t, 1e-12f);
  const float big = 0.5f * sqrtf(3.14159265358979323846f / t_safe) *
                    erff(sqrtf(t_safe));
  const float small = 1.0f - t / 3.0f + t * t / 10.0f;
  return t < 1e-6f ? small : big;
}

// ssss integral of one primitive quartet (the reference's _ssss_tile)
__device__ __forceinline__ float ssss(float ax, float ay, float az, float za,
                                      float bx, float by, float bz, float zb,
                                      float cx, float cy, float cz, float zc,
                                      float dx, float dy, float dz, float zd,
                                      float two_pi_pow_2_5) {
  const float p = za + zb;
  const float q = zc + zd;
  const float ab2 = sq(ax - bx) + sq(ay - by) + sq(az - bz);
  const float cd2 = sq(cx - dx) + sq(cy - dy) + sq(cz - dz);
  const float kab = expf(-(za * zb / p) * ab2);
  const float kcd = expf(-(zc * zd / q) * cd2);
  const float px = (za * ax + zb * bx) / p;
  const float py = (za * ay + zb * by) / p;
  const float pz = (za * az + zb * bz) / p;
  const float qx = (zc * cx + zd * dx) / q;
  const float qy = (zc * cy + zd * dy) / q;
  const float qz = (zc * cz + zd * dz) / q;
  const float pq2 = sq(px - qx) + sq(py - qy) + sq(pz - qz);
  const float t = (p * q / (p + q)) * pq2;
  const float pref = two_pi_pow_2_5 / (p * q * sqrtf(p + q));
  return pref * kab * kcd * boys_f0(t);
}

template <int G>
__global__ void twoel_kernel(const float* __restrict__ pos4,
                             const float* __restrict__ dens,
                             const float* __restrict__ zc,
                             float* __restrict__ fock, int n, int l0, int nl,
                             int team, float two_pi_pow_2_5) {
  constexpr int G2 = G * G;
  constexpr int G4 = G2 * G2;
  extern __shared__ float4 smem[];
  float4* s_pos = smem;                                       // (n,) xyz_
  float* s_zc = reinterpret_cast<float*>(s_pos + n);          // (2, G)
  double* s_part = reinterpret_cast<double*>(s_zc + 2 * G + 2);  // per warp

  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    s_pos[t] = make_float4(pos4[4 * t], pos4[4 * t + 1], pos4[4 * t + 2], 0.0f);
  }
  for (int t = threadIdx.x; t < 2 * G; t += blockDim.x) s_zc[t] = zc[t];
  __syncthreads();

  const int lane = threadIdx.x % team;
  const int out = blockIdx.x * (blockDim.x / team) + threadIdx.x / team;
  const bool valid = out < n * n;
  double acc = 0.0;
  if (valid) {
    const int i = out / n;
    const int j = out % n;
    const float4 ri = s_pos[i];
    const float4 rj = s_pos[j];
    const unsigned total = static_cast<unsigned>(n) * nl * G4;
    for (unsigned idx = lane; idx < total; idx += team) {
      const unsigned kl = idx / G4;
      const unsigned g = idx % G4;
      const int k = kl / nl;
      const int l = l0 + static_cast<int>(kl % nl);
      const int g34 = g / G2, g12 = g % G2;
      const int g3 = g34 / G, g4 = g34 % G;
      const int g1 = g12 / G, g2 = g12 % G;
      const float z1 = s_zc[g1], z2 = s_zc[g2], z3 = s_zc[g3], z4 = s_zc[g4];
      const float cc = s_zc[G + g1] * s_zc[G + g2] * s_zc[G + g3] * s_zc[G + g4];
      const float4 rk = s_pos[k];
      const float4 rl = s_pos[l];
      const float dkl = __ldg(dens + static_cast<size_t>(k) * n + l);
      // J: (i j | k l); K: (i k | j l)
      const float jt = ssss(ri.x, ri.y, ri.z, z1, rj.x, rj.y, rj.z, z2, rk.x,
                            rk.y, rk.z, z3, rl.x, rl.y, rl.z, z4,
                            two_pi_pow_2_5);
      const float kt = ssss(ri.x, ri.y, ri.z, z1, rk.x, rk.y, rk.z, z2, rj.x,
                            rj.y, rj.z, z3, rl.x, rl.y, rl.z, z4,
                            two_pi_pow_2_5);
      acc += static_cast<double>(cc * dkl * (2.0f * jt - kt));
    }
  }

  // fixed-order reduction: a butterfly in each warp (a team is a whole
  // number of warps), then the team's warp partials in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) s_part[warp] = acc;
  __syncthreads();
  if (valid && lane == 0) {
    const int first = threadIdx.x / 32;
    double sum = 0.0;
    for (int w = 0; w < team / 32; ++w) sum += s_part[first + w];
    fock[out] = static_cast<float>(sum);
  }
}

template <int G>
int launch(const float* pos4, const float* dens, const float* zc, float* fock,
           int n, int l0, int nl, int team, int block, float two_pi_pow_2_5,
           cudaStream_t stream) {
  // float4 positions, the (2, G) basis padded to 8 bytes, a double per warp
  const size_t smem = sizeof(float4) * n + sizeof(float) * (2 * G + 2) +
                      sizeof(double) * (block / 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        twoel_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_block = block / team;
  const long long outputs = static_cast<long long>(n) * n;
  const dim3 grid(static_cast<unsigned>((outputs + per_block - 1) / per_block));
  twoel_kernel<G><<<grid, block, smem, stream>>>(pos4, dens, zc, fock, n, l0,
                                                 nl, team, two_pi_pow_2_5);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or -1 for a
// G without an instantiation.  The caller checks shapes, dtype and
// contiguity: (n, 4) positions, (n, n) density, a (2, G) basis (exponents,
// then coefficients) and an (n, n) output, all float32 on the current
// device; 0 <= l0, 1 <= nl, l0 + nl <= n; team a multiple of 32 dividing
// block; n * nl * G^4 < 2^31, so the strided 32-bit loop index cannot wrap.
extern "C" int twoel_f32(const float* pos4, const float* dens, const float* zc,
                         float* fock, int n, int ngauss, int l0, int nl,
                         int team, int block, float two_pi_pow_2_5,
                         cudaStream_t stream) {
  switch (ngauss) {
    case 3:
      return launch<3>(pos4, dens, zc, fock, n, l0, nl, team, block,
                       two_pi_pow_2_5, stream);
    case 6:
      return launch<6>(pos4, dens, zc, fock, n, l0, nl, team, block,
                       two_pi_pow_2_5, stream);
    default:
      return -1;
  }
}

extern "C" const char* twoel_error_string(int err) {
  if (err == -1) return "no kernel instantiated for this ngauss";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
