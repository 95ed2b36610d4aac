// Ghost-slab `within` stencil for NVIDIA Hopper (sm_90a), over a window of frames.
//
// Replaces: molar_tpu/ops/neighbor_pallas.py:_ghost_kernel (the Pallas TPU
// kernel behind within_ghost_pallas), together with the ghost planes, the
// occupancy bitmask and the unsort around it. Input: the cell records of
// csrc/cell_bin.cu (sources and targets of every frame binned into
// fixed-capacity cells, with per-cell counts). Output: for every frame and
// every source, is any target of the 3x3x3 neighbouring cells within the
// cutoff (d^2 <= c2, inclusive) under the periodic images? The mask is
// written through each source record's list position, so no unsort follows.
//
// Periodic images: the TPU kernel reads pre-shifted copies of the targets
// from ghost border cells. Here no ghost grid exists: a neighbour index past
// the edge of a periodic axis wraps, and its targets are shifted as they are
// staged, axis by axis (x, then y, then z) by the box column of that axis,
// the same operations the ghost planes apply (ops/neighbor.py:_ghost_planes:
// p[0] = p[nx] - box[d][0] is __fsub_rn(q, box[d][0]) here). On an axis of 1
// or 2 cells two offsets reach one cell with different shifts; both are
// visited, as both ghost cells are. A non-periodic axis has no neighbour past
// its edge.
//
// What bounds it on the card: bytes and latency, not FLOPs (9 per pair: 3
// sub, 3 mul, 2 add, 1 compare). At the headline (100k atoms, a 5k-atom
// target ball, 20^3 cells) 86 % of the source cells have no target in their
// neighbourhood. The design:
//  * one block per (source cell, frame), all frames of the window in one
//    launch; a block reads its cell's source count and its 27 neighbours'
//    target counts first and exits when either is zero, so empty
//    neighbourhoods cost 28 loads;
//  * a live block stages its neighbourhood's targets, shifted into their
//    images, in shared memory (chunks of kChunk records, any tgt_cap), and
//    every thread then reads the same shared address (a broadcast);
//  * one thread per source slot, the source in registers, stopping at its
//    first hit; only slots below the cell's count are read.
//
// Rounding: d^2 is computed with _rn intrinsics in the plain twins' order
// ((dx*dx + dy*dy) + dz*dz, d = target - source) and the image shifts with
// __fadd_rn / __fsub_rn, so no FMA contraction moves a tie at the cutoff
// (the build also passes --fmad=false).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Staged target records per pass: 16 KB of shared memory.
constexpr int kChunk = 1024;

struct Neighbourhood {
  int cell[27];   // neighbour cell id
  int shift[27];  // image shift per axis, packed as (sx+1) + 3*(sy+1) + 9*(sz+1)
  int start[28];  // prefix sums of the neighbours' target counts
};

// Stages targets [t0, t0 + n) of the neighbourhood, each shifted into its image.
__device__ __forceinline__ void stage(float4* staged, const Neighbourhood& nb,
                                      const float4* __restrict__ tgt, const float* box,
                                      int tcap, int t0, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int t = t0 + k;
    int o = 0;
    while (t >= nb.start[o + 1]) ++o;
    float4 q = tgt[static_cast<int64_t>(nb.cell[o]) * tcap + (t - nb.start[o])];
    int sh = nb.shift[o];
    for (int a = 0; a < 3; ++a, sh /= 3) {
      const int s = sh % 3 - 1;
      if (s > 0) {
        q.x = __fadd_rn(q.x, box[a]);
        q.y = __fadd_rn(q.y, box[3 + a]);
        q.z = __fadd_rn(q.z, box[6 + a]);
      } else if (s < 0) {
        q.x = __fsub_rn(q.x, box[a]);
        q.y = __fsub_rn(q.y, box[3 + a]);
        q.z = __fsub_rn(q.z, box[6 + a]);
      }
    }
    staged[k] = q;
  }
}

__global__ void within_ghost_kernel(const float4* __restrict__ src_rec,
                                    const float4* __restrict__ tgt_rec,
                                    const int* __restrict__ counts,
                                    const float* __restrict__ boxes,
                                    uint8_t* __restrict__ mask, int n_src, int nx, int ny,
                                    int nz, int cap, int tcap, int pbc_x, int pbc_y, int pbc_z,
                                    float c2) {
  __shared__ float4 staged[kChunk];
  __shared__ Neighbourhood nb;
  const int cell = blockIdx.x;
  const int f = blockIdx.y;
  const int n_cells = nx * ny * nz;
  const int* src_count = counts + static_cast<int64_t>(f) * 2 * n_cells;
  const int* tgt_count = src_count + n_cells;
  const int ns = min(src_count[cell], cap);
  if (ns == 0) return;

  if (threadIdx.x < 27) {
    const int o = threadIdx.x;
    const int n[3] = {nx, ny, nz};
    const int per[3] = {pbc_x, pbc_y, pbc_z};
    int c[3] = {cell / (ny * nz) + o / 9 - 1, (cell / nz) % ny + (o / 3) % 3 - 1,
                cell % nz + o % 3 - 1};
    bool ok = true;
    int shift = 0;
    for (int a = 2; a >= 0; --a) {
      int s = 0;
      if (c[a] < 0) {
        s = -1;
        c[a] += n[a];
      } else if (c[a] >= n[a]) {
        s = 1;
        c[a] -= n[a];
      }
      ok = ok && (s == 0 || per[a]);
      shift = shift * 3 + s + 1;
    }
    nb.cell[o] = (c[0] * ny + c[1]) * nz + c[2];
    nb.shift[o] = shift;
    nb.start[o + 1] = ok ? min(tgt_count[nb.cell[o]], tcap) : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    nb.start[0] = 0;
    for (int o = 0; o < 27; ++o) nb.start[o + 1] += nb.start[o];
  }
  __syncthreads();
  const int total = nb.start[27];
  if (total == 0) return;

  const float* box = boxes + f * 9;
  const float4* tgt = tgt_rec + static_cast<int64_t>(f) * n_cells * tcap;
  const float4* src = src_rec + (static_cast<int64_t>(f) * n_cells + cell) * cap;
  uint8_t* out = mask + static_cast<int64_t>(f) * n_src;
  const bool once = total <= kChunk;
  if (once) {
    stage(staged, nb, tgt, box, tcap, 0, total);
    __syncthreads();
  }
  for (int s0 = 0; s0 < ns; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    const bool active = s < ns;
    const float4 p = active ? src[s] : make_float4(0.f, 0.f, 0.f, 0.f);
    bool found = !active;
    for (int t0 = 0; t0 < total; t0 += kChunk) {
      const int n = min(kChunk, total - t0);
      if (!once) {
        __syncthreads();
        stage(staged, nb, tgt, box, tcap, t0, n);
        __syncthreads();
      }
      for (int k = 0; k < n && !found; ++k) {
        const float4 q = staged[k];
        const float dx = __fsub_rn(q.x, p.x);
        const float dy = __fsub_rn(q.y, p.y);
        const float dz = __fsub_rn(q.z, p.z);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        found = d2 <= c2;
      }
    }
    const unsigned pos = static_cast<unsigned>(__float_as_int(p.w));
    if (active && found && pos < static_cast<unsigned>(n_src)) out[pos] = 1;
  }
}

}  // namespace

extern "C" {

// Enqueues the stencil of n_frames frames on `stream`; returns
// cudaGetLastError() (0 = ok). Device pointers, all contiguous:
//   src_rec (n_frames, nx*ny*nz, cap, 4) f32, tgt_rec (n_frames, nx*ny*nz,
//   tcap, 4) f32 and counts (n_frames, 2, nx*ny*nz) i32 as cell_bin_launch
//   leaves them; boxes (n_frames, 3, 3) f32 (columns are the box vectors);
//   mask (n_frames, n_src) bytes, zeroed by the caller (only hits are
//   written; a record whose list position is outside [0, n_src) writes
//   nothing).
int within_ghost_launch(const float* src_rec, const float* tgt_rec, const int* counts,
                        const float* boxes, uint8_t* mask, int n_frames, int n_src, int nx,
                        int ny, int nz, int cap, int tcap, int pbc_x, int pbc_y, int pbc_z,
                        float c2, void* stream) {
  int threads = (cap + 31) / 32 * 32;
  if (threads > 256) threads = 256;
  const dim3 grid(nx * ny * nz, n_frames);
  within_ghost_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(src_rec), reinterpret_cast<const float4*>(tgt_rec),
      counts, boxes, mask, n_src, nx, ny, nz, cap, tcap, pbc_x, pbc_y, pbc_z, c2);
  return static_cast<int>(cudaGetLastError());
}

const char* within_ghost_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
