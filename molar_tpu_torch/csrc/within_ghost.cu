// Ghost-slab `within` stencil for NVIDIA Hopper (sm_90a).
//
// Replaces: molar_tpu/ops/neighbor_pallas.py:_ghost_kernel (the Pallas TPU
// kernel behind within_ghost_pallas). Same contract: for every source slot of
// the cell-blocked source planes, is any target of the 3x3x3 neighbouring
// cells of the ghost-padded target planes within the cutoff (d^2 <= c2,
// inclusive)? Periodic images are pre-shifted into the ghost border cells and
// pad slots hold sentinels (sources -1e17, targets +1e17), so there are no
// gathers, no per-pair image math and no validity planes.
//
// What bounds it on the card: not FLOPs (9 per pair: 3 sub, 3 mul, 2 add,
// 1 compare) but reading target planes. A source cell's neighbourhood is 27
// cells x tgt_cap slots x 12 bytes (x, y, z) — 10 KB at tgt_cap 32 — against
// cap x 9 FLOPs per target slot read, and the whole ghost grid (4 MB at the
// 100k-atom headline, 22^3 cells x 32 slots) stays resident in the 50 MB L2.
// So the kernel is bound by L1/L2 load issue and latency, and by how many
// target slots it visits at all.
//
// What the design does about it (first, simple version):
//  * one block per source cell, one thread per source slot (strided when
//    cap > blockDim), the source point held in registers;
//  * every thread of a block reads the SAME target addresses, so each load
//    is one broadcast transaction per warp;
//  * a cell's slots fill in rank order from slot 0, so the first target pad
//    slot ends the cell: an empty neighbour cell costs one load, and most
//    cells of a sparse target selection (the headline's 5k-atom protein in a
//    100k-atom box) are empty;
//  * a thread stops at its first hit; source pad slots do no work.
// The TPU kernel's 128-lane z-windows, int32 per-quad occupancy mask and its
// tgt_cap % 32 / nz <= 121 limits are not needed here.
//
// Rounding: d^2 is computed with _rn intrinsics in the plain torch twin's
// order ((dx*dx + dy*dy) + dz*dz, d = target - source) so no FMA contraction
// changes a tie at the cutoff (the build also passes --fmad=false).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Pad slots hold +1e17 in the target planes (a ghost copy shifts it by one
// box length, which f32 absorbs) and -1e17 in the source planes. Real
// coordinates are wrapped into the box, many orders below these thresholds.
constexpr float kTargetPadMin = 1e16f;
constexpr float kSourcePadMax = -1e16f;

__global__ void within_ghost_kernel(
    const float* __restrict__ sx, const float* __restrict__ sy,
    const float* __restrict__ sz, const float* __restrict__ gx,
    const float* __restrict__ gy, const float* __restrict__ gz,
    uint8_t* __restrict__ hit, int nx, int ny, int nz, int cap, int tcap,
    float c2) {
  const int cell = blockIdx.x;
  const int cz = cell % nz;
  const int cy = (cell / nz) % ny;
  const int cx = cell / (ny * nz);
  for (int s = threadIdx.x; s < cap; s += blockDim.x) {
    const long long si = static_cast<long long>(cell) * cap + s;
    const float px = sx[si];
    const float py = sy[si];
    const float pz = sz[si];
    bool found = false;
    if (px > kSourcePadMax) {
      // Padded index (cx + a) is the neighbour at offset a - 1.
      for (int a = 0; a < 3 && !found; ++a) {
        for (int b = 0; b < 3 && !found; ++b) {
          const long long row =
              (static_cast<long long>(cx + a) * (ny + 2) + (cy + b)) * (nz + 2) + cz;
          for (int c = 0; c < 3 && !found; ++c) {
            const long long base = (row + c) * tcap;
            for (int t = 0; t < tcap; ++t) {
              const float qx = __ldg(gx + base + t);
              if (qx >= kTargetPadMin) break;  // rest of the cell is padding
              const float dx = __fsub_rn(qx, px);
              const float dy = __fsub_rn(__ldg(gy + base + t), py);
              const float dz = __fsub_rn(__ldg(gz + base + t), pz);
              const float d2 = __fadd_rn(
                  __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                  __fmul_rn(dz, dz));
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
//   sx/sy/sz (nx*ny*nz, cap), gx/gy/gz (nx+2, ny+2, nz+2, tcap),
//   hit (nx*ny*nz, cap) bytes (0/1).
int within_ghost_launch(const float* sx, const float* sy, const float* sz,
                        const float* gx, const float* gy, const float* gz,
                        uint8_t* hit, int nx, int ny, int nz, int cap,
                        int tcap, float c2, void* stream) {
  const int n_cells = nx * ny * nz;
  int threads = (cap + 31) / 32 * 32;
  if (threads > 256) threads = 256;
  within_ghost_kernel<<<n_cells, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      sx, sy, sz, gx, gy, gz, hit, nx, ny, nz, cap, tcap, c2);
  return static_cast<int>(cudaGetLastError());
}

const char* within_ghost_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
