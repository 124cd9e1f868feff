// Seven-point Laplacian stencil, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/stencil7/kernel.py::laplacian_3d,
// which brings the z and y halos into VMEM through five BlockSpecs over the
// same input.  That trick is not carried over.
//
// What bounds it on the H100: bytes.  A cell costs 10 flops against 8 bytes
// (one float read, one written), about 1.25 flop/byte, far below the card's
// float32 ridge, so the floor is 2 * nz*ny*nx * 4 bytes over the HBM rate.
//
// What the design does about it: the plain GPU form.  A 2-D thread block
// tiles (x, y); each thread marches along z through a chunk of `zchunk`
// planes and keeps u[z-1], u[z], u[z+1] of its own column in registers, so
// each plane of the chunk is read from device memory once.  The x and y
// neighbours are the same plane's cells loaded by neighbouring threads, and
// L1/L2 serve them.  Consecutive threads take consecutive x, so every warp
// reads and writes whole 128-byte rows.  A chunk re-reads the two planes
// around it: 2/zchunk extra reads.
//
// Numerics: the sum keeps the reference's order,
//   u*invhxyz2 + (x- + x+)*invhx2 + (y- + y+)*invhy2 + (z- + z+)*invhz2,
// and nvcc's default -fmad=true contracts the three trailing products into
// FMAs.  Each FMA skips one rounding of a product, so a cell differs from the
// unfused plain version by a few ulp of its partial sums: under 1e-6 for
// unit-variance inputs, inside the reference's stencil7 tolerance
// (rtol 1e-5, atol 1e-5).
//
// Every cell is written, 0 on the six boundary faces: the caller allocates
// the output with torch.empty.  Offsets are 64-bit: at L = 1024 the byte
// offsets pass 2^31.  Coefficients are runtime floats.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void stencil7_kernel(const float* __restrict__ u,
                                float* __restrict__ f, int nz, int ny, int nx,
                                int zchunk, float invhx2, float invhy2,
                                float invhz2, float invhxyz2) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const int z0 = blockIdx.z * zchunk;
  const int z1 = min(z0 + zchunk, nz);
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  int64_t i = z0 * plane + static_cast<int64_t>(y) * nx + x;

  if (x == 0 || x == nx - 1 || y == 0 || y == ny - 1) {
    for (int z = z0; z < z1; ++z, i += plane) f[i] = 0.0f;
    return;
  }
  float below = z0 > 0 ? u[i - plane] : 0.0f;
  float here = u[i];
  for (int z = z0; z < z1; ++z, i += plane) {
    const float above = z + 1 < nz ? u[i + plane] : 0.0f;
    float r = 0.0f;
    if (z > 0 && z < nz - 1) {
      r = here * invhxyz2 + (u[i - 1] + u[i + 1]) * invhx2 +
          (u[i - nx] + u[i + nx]) * invhy2 + (below + above) * invhz2;
    }
    f[i] = r;
    below = here;
    here = above;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The caller
// checks shapes, dtype and contiguity: u and f are contiguous (nz, ny, nx)
// float32 volumes on the current device.
extern "C" int stencil7_f32(const float* u, float* f, int nz, int ny, int nx,
                            float invhx2, float invhy2, float invhz2,
                            float invhxyz2, int block_x, int block_y,
                            int zchunk, cudaStream_t stream) {
  const dim3 block(block_x, block_y);
  const dim3 grid((nx + block_x - 1) / block_x, (ny + block_y - 1) / block_y,
                  (nz + zchunk - 1) / zchunk);
  stencil7_kernel<<<grid, block, 0, stream>>>(u, f, nz, ny, nx, zchunk, invhx2,
                                              invhy2, invhz2, invhxyz2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stencil7_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
