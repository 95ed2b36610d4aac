// Counting-sort cell binning of a window of frames, for NVIDIA Hopper (sm_90a).
//
// Replaces: the plane build of molar_tpu/ops/neighbor_pallas.py:within_ghost_pallas
// (wrap into the unit cell, cell ids, then _blocked_planes' argsort +
// rank-in-run + scatter into fixed-capacity cell planes), which the JAX
// package runs in XLA around the Pallas kernel because Mosaic cannot sort or
// scatter inside a kernel.
//
// Contract, for every frame f of the window and every point of the source
// list (src_idx, or every atom when it is null) and of the target list
// (tgt_idx): wrap the point into the unit cell, take its lab coordinate and
// its cell of the (nx, ny, nz) grid, and put a 16-byte record
// (x, y, z, position in its list as int bits) into the next free slot of its
// cell: src_rec[f][cell][slot] (cap slots) or tgt_rec[f][cell][slot]
// (tcap slots). counts[f][0][cell] / counts[f][1][cell] end as the number
// of sources / targets of the cell; a cell over its capacity raises
// overflow[f], and the records are then undefined (the JAX package's
// overflow contract); so does an index outside [0, n_atoms). The slot
// order inside a cell depends on the run; every consumer ORs over a cell's
// members, so results do not.
//
// What bounds it on the card: bytes. Each point reads 12 bytes of
// coordinates (plus 8 of index) and writes one 16-byte record; its
// arithmetic (two 3x3 applies, a floor, three cell ids) is ~40 FLOPs. One
// atomicAdd per point on a per-cell counter takes the place of the sort;
// cells hold ~12 points at the headline's density, so the atomics seldom
// collide.
//
// Rounding: the fractional coordinate, its wrap, the lab coordinate and the
// cell id repeat the torch twin's operations (ops/neighbor_ghost.py:
// _apply3, _wrap_frac, _cell3) one rounded operation at a time, with _rn
// intrinsics and --fmad=false, so every record and every cell id is bitwise
// the twin's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// (m0*x + m1*y) + m2*z, each operation rounded on its own.
__device__ __forceinline__ float apply_row(const float* m, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m[0], x), __fmul_rn(m[1], y)), __fmul_rn(m[2], z));
}

// int32(f * n) clamped to [0, n - 1]; f is in [0, 1] (f - floor(f) can round to 1).
__device__ __forceinline__ int cell_of(float f, int n) {
  const int c = static_cast<int>(__fmul_rn(f, static_cast<float>(n)));
  return min(max(c, 0), n - 1);
}

__global__ void cell_bin_kernel(const float* __restrict__ coords,
                                const int64_t* __restrict__ src_idx,
                                const int64_t* __restrict__ tgt_idx,
                                const float* __restrict__ boxes,
                                const float* __restrict__ invs,
                                float4* __restrict__ src_rec, float4* __restrict__ tgt_rec,
                                int* __restrict__ counts, uint8_t* __restrict__ overflow,
                                int n_atoms, int n_src, int n_tgt, int nx, int ny, int nz,
                                int cap, int tcap) {
  const int f = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_src + n_tgt) return;
  const bool is_src = p < n_src;
  const int i = is_src ? p : p - n_src;
  const int64_t* idx = is_src ? src_idx : tgt_idx;
  const int64_t atom = idx ? idx[i] : i;
  if (atom < 0 || atom >= n_atoms) {  // never read outside the frame
    overflow[f] = 1;
    return;
  }
  const float* c = coords + (static_cast<int64_t>(f) * n_atoms + atom) * 3;
  const float x = c[0], y = c[1], z = c[2];
  const float* inv = invs + f * 9;
  const float* box = boxes + f * 9;

  float fx = apply_row(inv, x, y, z);
  float fy = apply_row(inv + 3, x, y, z);
  float fz = apply_row(inv + 6, x, y, z);
  fx = __fsub_rn(fx, floorf(fx));
  fy = __fsub_rn(fy, floorf(fy));
  fz = __fsub_rn(fz, floorf(fz));
  const float4 rec = make_float4(apply_row(box, fx, fy, fz), apply_row(box + 3, fx, fy, fz),
                                 apply_row(box + 6, fx, fy, fz), __int_as_float(i));
  const int n_cells = nx * ny * nz;
  const int cell = (cell_of(fx, nx) * ny + cell_of(fy, ny)) * nz + cell_of(fz, nz);

  const int k = is_src ? cap : tcap;
  const int slot = atomicAdd(counts + (static_cast<int64_t>(f) * 2 + (is_src ? 0 : 1)) * n_cells
                                 + cell, 1);
  if (slot < k) {
    (is_src ? src_rec : tgt_rec)[(static_cast<int64_t>(f) * n_cells + cell) * k + slot] = rec;
  } else {
    overflow[f] = 1;
  }
}

}  // namespace

extern "C" {

// Enqueues the binning of n_frames frames on `stream`; returns
// cudaGetLastError() (0 = ok). Device pointers, all contiguous:
//   coords (n_frames, n_atoms, 3) f32; src_idx (n_src,) i64 or null (every
//   atom, n_src == n_atoms); tgt_idx (n_tgt,) i64; boxes, invs
//   (n_frames, 3, 3) f32 (box columns are the box vectors);
//   src_rec (n_frames, nx*ny*nz, cap, 4) f32; tgt_rec (n_frames, nx*ny*nz,
//   tcap, 4) f32; counts (n_frames, 2, nx*ny*nz) i32 and overflow
//   (n_frames,) bytes, both zeroed by the caller.
int cell_bin_launch(const float* coords, const int64_t* src_idx, const int64_t* tgt_idx,
                    const float* boxes, const float* invs, float* src_rec, float* tgt_rec,
                    int* counts, uint8_t* overflow, int n_frames, int n_atoms, int n_src,
                    int n_tgt, int nx, int ny, int nz, int cap, int tcap, void* stream) {
  constexpr int kThreads = 256;
  const dim3 grid((n_src + n_tgt + kThreads - 1) / kThreads, n_frames);
  cell_bin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coords, src_idx, tgt_idx, boxes, invs, reinterpret_cast<float4*>(src_rec),
      reinterpret_cast<float4*>(tgt_rec), counts, overflow, n_atoms, n_src, n_tgt, nx, ny, nz,
      cap, tcap);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
