// Row-tiled per-pair min-image `within` stencil for NVIDIA Hopper (sm_90a).
//
// Replaces: molar_tpu/ops/neighbor_pallas.py:_kernel (the Pallas TPU kernel
// behind within_mask_pallas). Same contract: orthorhombic box, full PBC; for
// every source slot of the x-minor cell planes ((cy*nz + cz)*nx + cx), is any
// target of the 27 neighbouring cells (y, z and x each +-1, modulo the grid)
// within the cutoff? Each pair's image is resolved on the spot, per axis
// d - L*round(d/L) with d = target - source, and the test is
// ((dx^2 + dy^2) + dz^2) + penalty <= c2 (inclusive). Target pad slots carry a
// penalty of 1e12 (0 for a real target); source pad slots a validity of 0.
//
// What bounds it on the card: the per-pair image math (a division, a rint, a
// multiply and a subtract per axis, ~21 FLOPs a pair against the ghost
// kernel's 9) and reading target planes: a source cell's neighbourhood is 27
// cells x tgt_cap slots x 16 bytes (x, y, z, penalty), 14 KB at tgt_cap 32,
// and the whole target grid (4 MB at the 100k-atom headline, 20^3 cells x
// 32 slots x 16 B) stays resident in the 50 MB L2.
//
// What the design does about it (first, simple version; it does not copy
// the TPU kernel's row blocks and rolls):
//  * one block per source cell, one thread per source slot (strided when
//    cap > blockDim), the source point held in registers;
//  * the 27 neighbour cells are reached by periodic index wrap, so there are
//    no rolled copies; on an axis of 1 or 2 cells two offsets reach the same
//    cell, which only repeats a test (the TPU kernel's rolls alias the same
//    way) and cannot change a boolean OR;
//  * every thread of a block reads the SAME target addresses (one broadcast
//    transaction per warp);
//  * a cell's slots fill in rank order from slot 0, so the first slot with a
//    pad penalty ends the cell: an empty neighbour cell costs one load;
//  * a thread stops at its first hit; source pad slots do no work.
//
// Rounding: the division, rint (half to even, as torch.round / jnp.round),
// the products and the sums use _rn intrinsics in the plain torch twin's
// order, so no FMA contraction moves a tie at the cutoff (the build also
// passes --fmad=false).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Pad target slots carry a penalty of 1e12; real targets carry 0.
constexpr float kPadPenaltyMin = 1e11f;

__device__ __forceinline__ float min_image(float d, float len) {
  return __fsub_rn(d, __fmul_rn(len, rintf(__fdiv_rn(d, len))));
}

__global__ void within_rows_kernel(
    const float* __restrict__ sx, const float* __restrict__ sy,
    const float* __restrict__ sz, const float* __restrict__ sval,
    const float* __restrict__ tx, const float* __restrict__ ty,
    const float* __restrict__ tz, const float* __restrict__ tpen,
    const float* __restrict__ lengths, uint8_t* __restrict__ hit, int nx,
    int ny, int nz, int cap, int tcap, float c2) {
  const int cell = blockIdx.x;  // (cy*nz + cz)*nx + cx
  const int cx = cell % nx;
  const int row = cell / nx;
  const int cz = row % nz;
  const int cy = row / nz;
  const float lx = lengths[0];
  const float ly = lengths[1];
  const float lz = lengths[2];
  for (int s = threadIdx.x; s < cap; s += blockDim.x) {
    const long long si = static_cast<long long>(cell) * cap + s;
    bool found = false;
    if (sval[si] > 0.0f) {
      const float px = sx[si];
      const float py = sy[si];
      const float pz = sz[si];
      for (int dy = -1; dy <= 1 && !found; ++dy) {
        const int yy = (cy + dy + ny) % ny;
        for (int dz = -1; dz <= 1 && !found; ++dz) {
          const int zz = (cz + dz + nz) % nz;
          const long long nrow = static_cast<long long>(yy) * nz + zz;
          for (int dx = -1; dx <= 1 && !found; ++dx) {
            const int xx = (cx + dx + nx) % nx;
            const long long base = (nrow * nx + xx) * tcap;
            for (int t = 0; t < tcap; ++t) {
              const float pen = __ldg(tpen + base + t);
              if (pen >= kPadPenaltyMin) break;  // rest of the cell is padding
              const float ddx = min_image(__fsub_rn(__ldg(tx + base + t), px), lx);
              const float ddy = min_image(__fsub_rn(__ldg(ty + base + t), py), ly);
              const float ddz = min_image(__fsub_rn(__ldg(tz + base + t), pz), lz);
              const float d2 = __fadd_rn(
                  __fadd_rn(__fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)),
                            __fmul_rn(ddz, ddz)),
                  pen);
              if (d2 <= c2) {
                found = true;
                break;
              }
            }
          }
        }
      }
    }
    hit[si] = found ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Enqueues the stencil on `stream`; returns cudaGetLastError() (0 = ok).
// Pointers are device pointers of contiguous f32 planes:
//   sx/sy/sz/sval (ny*nz, nx, cap), tx/ty/tz/tpen (ny*nz, nx, tcap),
//   lengths (3,) = the box diagonal, hit (ny*nz, nx, cap) bytes (0/1).
int within_rows_launch(const float* sx, const float* sy, const float* sz,
                       const float* sval, const float* tx, const float* ty,
                       const float* tz, const float* tpen,
                       const float* lengths, uint8_t* hit, int nx, int ny,
                       int nz, int cap, int tcap, float c2, void* stream) {
  const int n_cells = nx * ny * nz;
  int threads = (cap + 31) / 32 * 32;
  if (threads > 256) threads = 256;
  within_rows_kernel<<<n_cells, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      sx, sy, sz, sval, tx, ty, tz, tpen, lengths, hit, nx, ny, nz, cap, tcap,
      c2);
  return static_cast<int>(cudaGetLastError());
}

const char* within_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
