// Hartree-Fock two-electron Fock build, written by hand for Hopper (sm_90a):
// each distinct integral once, from hoisted pair tables, then a gather of F
// in a fixed order.
//
// Replaces the Pallas TPU kernels repro/kernels/hartree_fock/kernel.py::
// twoel_tiled and ::twoel_slab_tiled.  Both compute
//   F[i,j] = sum_{k, l in [l0, l0+nl)} D[k,l] (2 (ij|kl) - (ik|jl)),
// the full build being the slab l0 = 0, nl = N.  One build is three kernels:
//
//   1. pair_table_kernel: for every canonical atom pair (i >= j), in the
//      rank order the caller gives, and every primitive pair g12 = (g1, g2),
//      float4(P, K) with p = z1 + z2, P = (z1 Ri + z2 Rj) / p and
//      K = exp(-z1 z2 / p |Ri - Rj|^2) c1 c2 (the plain version's
//      _pair_tables); and for every (g12, g34), float2(pq / (p + q),
//      2 pi^2.5 / (p q sqrt(p + q))).
//   2. eri_kernel: every distinct contracted integral (ij|kl) once.  The
//      caller ranks the pairs so that the S pairs holding an index of the
//      slab come first; the integrals the slab needs are then the
//      unordered rank pairs {u, v} with v < S, enumerated as u >= v: a
//      trapezoid of bra-pair x ket-pair tiles (32 x 32), the tiles with
//      ub >= vb and vb < ceil(S / 32).  A block stages its ket pairs' table
//      rows in shared memory; a thread holds 2 x 2 quartets in registers
//      and sums each one's G^4 primitive terms
//        pref K_ij K_kl F0(rho |P - Q|^2)
//      in float32, in the order g12 outer, g34 inner: only the Boys
//      function (one sqrtf, one erff, one IEEE division) is left in the
//      loop.  Each integral goes to every one of its <= 8 images (a, b, c,
//      d) whose last index d lies in the slab, in a scratch E of shape
//      (N, N, N, nl): every slot gets exactly one value, and images that
//      coincide get the same value from the same thread.
//   3. fock_gather_kernel: F[i,j] = sum_{k, l'} D[k, l0 + l'] (2 E[i,j,k,l']
//      - E[i,k,j,l']), a team of threads (whole warps) per F[i,j] striding
//      k * nl + l', reading E along l'; each lane sums in double, and the
//      team reduces in a fixed order (a shuffle butterfly in each warp, then
//      the warps' partials in order).
//
// No float atomics: repeats give the same bits.  What bounds it on the H100:
// operations, ~2.8e9 primitive terms at N = 128 STO-3G and at N = 64
// STO-6G, each with an erff, a sqrtf and a division; E (4 N^3 nl bytes) is
// written once, scattered, and read twice, coalesced.
//
// Numerics: precise expf/erff/sqrtf and IEEE division (the build has no
// --use_fast_math); nvcc's default -fmad=true contracts products into FMAs.
// F0(t) = 0.5 sqrt(pi / t) erf(sqrt t) is computed as
// (sqrt(pi) / 2) erf(s) / s with s = sqrt(t), and its series below 1e-6.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // every kernel's block
constexpr int kTile = 32;      // pairs along each side of an integral tile
constexpr float kHalfSqrtPi = 0.886226925452758f;

__device__ __forceinline__ float sq(float x) { return x * x; }

// F0 Boys function, series-guarded at t -> 0 (ref.boys_f0)
__device__ __forceinline__ float boys_f0(float t) {
  const float s = sqrtf(fmaxf(t, 1e-12f));
  const float big = kHalfSqrtPi * erff(s) / s;
  const float small = 1.0f - t * (1.0f / 3.0f) + t * t * 0.1f;
  return t < 1e-6f ? small : big;
}

// one primitive term of (ij|kl): bra (P, K_ij), ket (Q, K_kl), (rho, pref)
__device__ __forceinline__ float term(float4 bra, float4 ket, float2 pq) {
  const float pq2 = sq(bra.x - ket.x) + sq(bra.y - ket.y) + sq(bra.z - ket.z);
  return pq.y * bra.w * ket.w * boys_f0(pq.x * pq2);
}

__global__ void __launch_bounds__(kThreads)
pair_table_kernel(const float* __restrict__ pos4, const float* __restrict__ zc,
                  const int* __restrict__ pairs, float4* __restrict__ table,
                  float2* __restrict__ pp, int m, int g, float two_pi_pow_2_5) {
  const int g2 = g * g;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < g2 * g2) {
    const int g12 = t / g2, g34 = t % g2;
    const float p = zc[g12 / g] + zc[g12 % g];
    const float q = zc[g34 / g] + zc[g34 % g];
    pp[t] = make_float2(p * q / (p + q), two_pi_pow_2_5 / (p * q * sqrtf(p + q)));
  }
  if (t < m * g2) {
    const int pair = pairs[t / g2];
    const int i = pair >> 16, j = pair & 0xffff;
    const int g1 = (t % g2) / g, gb = (t % g2) % g;
    const float z1 = zc[g1], z2 = zc[gb];
    const float p = z1 + z2;
    const float xi = pos4[4 * i], yi = pos4[4 * i + 1], zi = pos4[4 * i + 2];
    const float xj = pos4[4 * j], yj = pos4[4 * j + 1], zj = pos4[4 * j + 2];
    const float d2 = sq(xi - xj) + sq(yi - yj) + sq(zi - zj);
    const float k = expf(-(z1 * z2 / p) * d2) * (zc[g + g1] * zc[g + gb]);
    table[t] = make_float4((z1 * xi + z2 * xj) / p, (z1 * yi + z2 * yj) / p,
                           (z1 * zi + z2 * zj) / p, k);
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
eri_kernel(const float4* __restrict__ table, const float2* __restrict__ pp,
           const int* __restrict__ pairs, float* __restrict__ eri, int n,
           int m, int s, int l0, int nl) {
  constexpr int G2 = G * G;
  constexpr int T = kTile;
  constexpr int R = T / 16;  // quartets a thread holds along each side
  const int ub = blockIdx.x, vb = blockIdx.y;
  if (ub < vb) return;  // below the diagonal: the transposed tile has it
  extern __shared__ float4 smem[];
  float4* s_ket = smem;                                        // (G2, T)
  float2* s_pp = reinterpret_cast<float2*>(s_ket + G2 * T);    // (G2, G2)
  for (int t = threadIdx.x; t < T * G2; t += kThreads) {
    const int v = min(vb * T + t / G2, s - 1);  // the ragged edge: clamped
    s_ket[(t % G2) * T + t / G2] = table[static_cast<size_t>(v) * G2 + t % G2];
  }
  for (int t = threadIdx.x; t < G2 * G2; t += kThreads) s_pp[t] = pp[t];
  __syncthreads();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int urow[R];
#pragma unroll
  for (int a = 0; a < R; ++a) urow[a] = min(ub * T + ty + 16 * a, m - 1);
  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) acc[a][b] = 0.0f;

  for (int g12 = 0; g12 < G2; ++g12) {
    float4 bra[R];
#pragma unroll
    for (int a = 0; a < R; ++a)
      bra[a] = __ldg(table + static_cast<size_t>(urow[a]) * G2 + g12);
#pragma unroll 3
    for (int g34 = 0; g34 < G2; ++g34) {
      const float2 q = s_pp[g12 * G2 + g34];
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const float4 ket = s_ket[g34 * T + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < R; ++a) acc[a][b] += term(bra[a], ket, q);
      }
    }
  }

  // every image (a, b, c, d) of (ij|kl) whose last index d is in the slab
  const size_t nn = n, nlz = nl;
  auto put = [&](int a, int b, int c, int d, float x) {
    eri[((a * nn + b) * nn + c) * nlz + (d - l0)] = x;
  };
  auto in_slab = [&](int d) {
    return static_cast<unsigned>(d - l0) < static_cast<unsigned>(nl);
  };
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int u = ub * T + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const int v = vb * T + tx + 16 * b;
      if (u >= m || v >= s || u < v) continue;
      const int bra_pair = pairs[u], ket_pair = pairs[v];
      const int i = bra_pair >> 16, j = bra_pair & 0xffff;
      const int k = ket_pair >> 16, l = ket_pair & 0xffff;
      const float x = acc[a][b];
      if (in_slab(l)) { put(i, j, k, l, x); put(j, i, k, l, x); }
      if (in_slab(k)) { put(i, j, l, k, x); put(j, i, l, k, x); }
      if (in_slab(j)) { put(k, l, i, j, x); put(l, k, i, j, x); }
      if (in_slab(i)) { put(k, l, j, i, x); put(l, k, j, i, x); }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fock_gather_kernel(const float* __restrict__ eri, const float* __restrict__ dens,
                   float* __restrict__ fock, int n, int l0, int nl, int team) {
  __shared__ double s_part[kThreads / 32];
  const int lane = threadIdx.x % team;
  const int out = blockIdx.x * (kThreads / team) + threadIdx.x / team;
  const bool valid = out < n * n;
  double acc = 0.0;
  if (valid) {
    const int i = out / n, j = out % n;
    const size_t plane = static_cast<size_t>(n) * nl;  // E[i, b, :, :]
    const float* e_ij = eri + (static_cast<size_t>(i) * n + j) * plane;
    const float* e_i_j = eri + static_cast<size_t>(i) * n * plane +
                         static_cast<size_t>(j) * nl;  // E[i, k, j, :]
    const int total = n * nl;
    for (int idx = lane; idx < total; idx += team) {
      const int k = idx / nl, l = idx - k * nl;
      const float jt = e_ij[idx];
      const float kt = e_i_j[k * plane + l];
      const float d = __ldg(dens + static_cast<size_t>(k) * n + l0 + l);
      acc += static_cast<double>(d) *
             (2.0 * static_cast<double>(jt) - static_cast<double>(kt));
    }
  }
  // fixed-order reduction: a butterfly in each warp (a team is a whole
  // number of warps), then the team's warp partials in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (threadIdx.x % 32 == 0) s_part[threadIdx.x / 32] = acc;
  __syncthreads();
  if (valid && lane == 0) {
    const int first = threadIdx.x / 32;
    double sum = 0.0;
    for (int w = 0; w < team / 32; ++w) sum += s_part[first + w];
    fock[out] = static_cast<float>(sum);
  }
}

template <int G>
cudaError_t launch_eri(const float4* table, const float2* pp, const int* pairs,
                       float* eri, int n, int m, int s, int l0, int nl,
                       int ubs, int vbs, cudaStream_t stream) {
  const size_t smem =
      sizeof(float4) * G * G * kTile + sizeof(float2) * G * G * G * G;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        eri_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  eri_kernel<G><<<dim3(ubs, vbs), kThreads, smem, stream>>>(
      table, pp, pairs, eri, n, m, s, l0, nl);
  return cudaGetLastError();
}

}  // namespace

// One build on `stream`, three launches; returns the first nonzero
// cudaGetLastError() (0 on success), or -1 for an ngauss without an
// instantiation.  The caller checks shapes, dtype and contiguity, all on
// the current device: (n, 4) float32 positions, (n, n) density, a (2, G)
// basis (exponents, then coefficients), `pairs` the m = n (n + 1) / 2
// canonical pairs (i << 16 | j, i >= j) in rank order with the s pairs
// holding an index in [l0, l0 + nl) first; scratch `table` (m G^2 float4),
// `pp` (G^4 float2) and `eri` (n^3 nl floats); `ubs` = ceil(m / 32) and
// `vbs` = ceil(s / 32) tiles; team a multiple of 32 dividing 256.
extern "C" int twoel_f32(const float* pos4, const float* dens, const float* zc,
                         const int* pairs, void* table, void* pp, float* eri,
                         float* fock, int n, int ngauss, int l0, int nl, int m,
                         int s, int ubs, int vbs, int team,
                         float two_pi_pow_2_5, cudaStream_t stream) {
  if (ngauss != 3 && ngauss != 6) return -1;
  auto* tab = static_cast<float4*>(table);
  auto* pq = static_cast<float2*>(pp);
  const int g2 = ngauss * ngauss;
  const int work = m * g2 > g2 * g2 ? m * g2 : g2 * g2;
  pair_table_kernel<<<(work + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      pos4, zc, pairs, tab, pq, m, ngauss, two_pi_pow_2_5);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ngauss == 3 ? launch_eri<3>(tab, pq, pairs, eri, n, m, s, l0, nl, ubs,
                                    vbs, stream)
                    : launch_eri<6>(tab, pq, pairs, eri, n, m, s, l0, nl, ubs,
                                    vbs, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = kThreads / team;
  const int blocks = (n * n + per_block - 1) / per_block;
  fock_gather_kernel<<<blocks, kThreads, 0, stream>>>(eri, dens, fock, n, l0,
                                                      nl, team);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* twoel_error_string(int err) {
  if (err == -1) return "no kernel instantiated for this ngauss";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
