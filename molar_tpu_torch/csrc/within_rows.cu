// Per-pair min-image `within` stencil for NVIDIA Hopper (sm_90a), over a window of frames.
//
// Replaces: molar_tpu/ops/neighbor_pallas.py:_kernel (the Pallas TPU kernel
// behind within_mask_pallas), together with the x-minor row planes and the
// unsort around it. Same contract: orthorhombic box, full PBC; has a source
// any target of its 27 neighbouring cells (each axis +-1, modulo the grid)
// within the cutoff, each pair's image resolved on the spot, per axis
// d - L*round(d/L) with d = target - source (round half to even), tested as
// ((dx^2 + dy^2) + dz^2) <= c2 (inclusive)? Input: the cell records of
// csrc/cell_bin.cu (sources and targets of every frame binned into
// fixed-capacity cells, with per-cell counts). Output: masks (frames, n_src),
// written through each source record's list position, so no unsort follows.
// The TPU kernel's row blocks, its nine row maps, its rolls and its pad
// penalties are not carried over: counts bound the slots, so no slot needs a
// penalty (the penalty of a real target was 0, and x + 0.0f is exact for the
// finite d^2 here, so dropping it moves no tie).
//
// What bounds it on the card: operations and latency, not bytes. A pair costs
// 15 FLOPs (3 sub for d, 3 sub and 3 min for the image, 3 mul and 2 add for
// d^2, 1 compare; ops/neighbor_rows.py:FLOPS_PER_PAIR), none of which may
// fuse into an FMA, and the headline window (16 frames, 100k atoms, a 5k-atom
// target ball, 20^3 cells) has 46.7 M candidate pairs but needs only ~9 MB of
// counts and records; 86 % of its source cells have no target in their
// neighbourhood, and a live cell has 12-24 sources against up to ~320
// targets, found through a chain of dependent loads (counts, then records).
// The design:
//  * one block per tile of up to 32 consecutive cells of a frame (the wrapper
//    picks the tile), all frames in one launch. The block's first warp reads
//    one cell's source count and its 27 neighbours' target counts per lane
//    and votes; a tile with no live cell leaves at once, so the window pays
//    a few thousand blocks, not 128,000 (a tile of 1 is the block-per-cell
//    form, kept for comparison);
//  * after the vote every warp works alone, with no block barrier: it takes
//    the tile's next live cell from a shared counter, so a tile's live cells
//    spread over the block's warps whatever their number;
//  * a warp keeps the cell's neighbour list in registers, a neighbour a lane
//    (the cell's own first, so that a source that is itself a target hits in
//    its first step), with a shuffle scan for the neighbours' places among
//    the targets; each lane copies its neighbour's 16-byte records UNSHIFTED
//    into the warp's slice of shared memory with cp.async (passes of kChunk
//    records, so any tgt_cap works). On an axis of 1 or 2 cells two or three
//    offsets reach one cell; with no shift applied they give identical tests,
//    so the cell is staged once;
//  * sources are read 32 at a time, one a lane, and tested kTogether at a
//    time: the warp's 32 lanes take 32 consecutive staged targets, each
//    against kTogether sources (independent chains that hide each other's
//    latency), one warp-wide OR a step, stopping when all have a hit.
//
// The image without a division: records are wrapped into the cell, every
// coordinate in [0, L], so |d| <= L and round(d/L) is -1, 0 or 1. The f32
// quotient d/L rounds above 0.5 exactly when |d| > L/2 (L/2 is exact; the
// next float above it, divided by L, lies more than half a spacing above
// 0.5), and a quotient of exactly 0.5 rounds to 0 (half to even). So the
// image d - L*round(d/L) is d when |d| <= L/2 and d -+ L otherwise, where
// the subtraction is exact (Sterbenz: L/2 <= |d| <= 2L), as is L - |d|: its
// magnitude is min(|d|, L - |d|) bit for bit (at |d| = L/2 both are L/2),
// and only its square is used. tests/test_torch_rows_window.py holds that
// rule against d - L*torch.round(d / L) at and around 0, +-L/2 and +-L.
//
// Rounding: d, the image and d^2 use _rn intrinsics in the plain twins' order
// ((dx*dx + dy*dy) + dz*dz, d = target - source), so no FMA contraction moves
// a tie at the cutoff (the build also passes --fmad=false).

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 32;  // one lane of the first warp per cell
// Staged target records per warp and pass: 6 KB of shared memory (27 cells
// of 12, the headline's interior neighbourhood, fit in one pass).
constexpr int kChunk = 384;
constexpr int kTogether = 4;  // sources a warp tests against each staged target
constexpr unsigned kFullWarp = 0xffffffffu;

// c in [-1, n] wrapped into [0, n).
__device__ __forceinline__ int wrap(int c, int n) { return c < 0 ? c + n : (c >= n ? c - n : c); }

// Is `off` the first of the offsets -1, 0, 1 to reach its cell on an axis of
// n cells? On 1 cell all three reach one cell, on 2 cells -1 and 1 do.
__device__ __forceinline__ bool first_to_reach(int off, int n) {
  return n > 2 || off == 0 || (n == 2 && off < 0);
}

// |d - L*round(d/L)| for |d| <= L (see the note above).
__device__ __forceinline__ float min_image_abs(float d, float len) {
  return fminf(fabsf(d), __fsub_rn(len, fabsf(d)));
}

__global__ void __launch_bounds__(kThreads)
within_rows_kernel(const float4* __restrict__ src_rec, const float4* __restrict__ tgt_rec,
                   const int* __restrict__ counts, const float* __restrict__ boxes,
                   uint8_t* __restrict__ mask, int n_src, int nx, int ny, int nz, int cap,
                   int tcap, int tile, float c2) {
  __shared__ float4 staged_of[kWarps][kChunk];
  __shared__ unsigned live_cells;
  __shared__ int cells_taken;
  const int f = blockIdx.y;
  const int n_cells = nx * ny * nz;
  const int first = blockIdx.x * tile;
  const int* src_count = counts + static_cast<int64_t>(f) * 2 * n_cells;
  const int* tgt_count = src_count + n_cells;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Which cells of the tile have a source and a target in reach?
  if (warp == 0) {
    const int cell = first + lane;
    int near = 0;
    if (lane < tile && cell < n_cells && src_count[cell] > 0) {
      const int cx = cell / (ny * nz), cy = (cell / nz) % ny, cz = cell % nz;
      for (int o = 0; o < 27; ++o) {
        near |= tgt_count[(wrap(cx + o / 9 - 1, nx) * ny + wrap(cy + (o / 3) % 3 - 1, ny)) * nz +
                          wrap(cz + o % 3 - 1, nz)];
      }
    }
    const unsigned live = __ballot_sync(kFullWarp, near > 0);
    if (lane == 0) {
      live_cells = live;
      cells_taken = 0;
    }
  }
  __syncthreads();
  const unsigned live = live_cells;
  if (live == 0) return;

  // From here on every warp works alone: it takes the tile's next live cell
  // until none is left.
  const int n_live = __popc(live);
  float4* staged = staged_of[warp];
  const float lx = boxes[f * 9], ly = boxes[f * 9 + 4], lz = boxes[f * 9 + 8];
  const float4* tgt = tgt_rec + static_cast<int64_t>(f) * n_cells * tcap;
  uint8_t* out = mask + static_cast<int64_t>(f) * n_src;
  for (;;) {
    int taken = 0;
    if (lane == 0) taken = atomicAdd(&cells_taken, 1);
    taken = __shfl_sync(kFullWarp, taken, 0);
    if (taken >= n_live) return;
    const int cell = first + __fns(live, 0, taken + 1);

    // The neighbour cells, one a lane: the cell's own first, then the rest;
    // an offset that reaches a cell another offset reaches too (axes of 1
    // or 2 cells) counts no targets. [begin, end) are a neighbour's places
    // among the neighbourhood's targets.
    int id = 0, count = 0;
    if (lane < 27) {
      const int o = (lane + 13) % 27;
      const int ox = o / 9 - 1, oy = (o / 3) % 3 - 1, oz = o % 3 - 1;
      id = (wrap(cell / (ny * nz) + ox, nx) * ny + wrap((cell / nz) % ny + oy, ny)) * nz +
           wrap(cell % nz + oz, nz);
      if (first_to_reach(ox, nx) && first_to_reach(oy, ny) && first_to_reach(oz, nz)) {
        count = min(tgt_count[id], tcap);
      }
    }
    int end = count;
    for (int step = 1; step < 32; step <<= 1) {
      const int below = __shfl_up_sync(kFullWarp, end, step);
      if (lane >= step) end += below;
    }
    const int begin = end - count;
    const int total = __shfl_sync(kFullWarp, end, 31);
    const int ns = min(src_count[cell], cap);
    const float4* src = src_rec + (static_cast<int64_t>(f) * n_cells + cell) * cap;

    int staged_from = -1;  // the pass now in shared memory
    for (int g = 0; g < ns; g += 32) {  // 32 sources at a time, one a lane
      const bool mine = g + lane < ns;
      const float4 p = mine ? src[g + lane] : make_float4(0.f, 0.f, 0.f, 0.f);
      bool found = false;
      unsigned open = __ballot_sync(kFullWarp, mine);  // sources without a hit yet
      for (int t0 = 0; t0 < total && open; t0 += kChunk) {
        const int n = min(kChunk, total - t0);
        if (staged_from != t0) {
          __syncwarp();  // the last pass has been read
          const float4* from = tgt + static_cast<int64_t>(id) * tcap - begin;
          for (int t = max(begin, t0); t < min(end, t0 + n); ++t) {
            __pipeline_memcpy_async(staged + (t - t0), from + t, sizeof(float4));
          }
          __pipeline_commit();
          __pipeline_wait_prior(0);
          __syncwarp();
          staged_from = t0;
        }
        for (unsigned todo = open; todo;) {
          // kTogether sources a step: their tests are independent, so they
          // hide each other's latency (a missing one repeats the last).
          int j[kTogether], last = 0;
          float px[kTogether], py[kTogether], pz[kTogether];
          unsigned wanted = 0;
#pragma unroll
          for (int u = 0; u < kTogether; ++u) {
            if (todo) {
              last = __ffs(todo) - 1;
              todo &= todo - 1;
              wanted |= 1u << u;
            }
            j[u] = last;
            px[u] = __shfl_sync(kFullWarp, p.x, j[u]);
            py[u] = __shfl_sync(kFullWarp, p.y, j[u]);
            pz[u] = __shfl_sync(kFullWarp, p.z, j[u]);
          }
          unsigned got = 0;
          for (int k0 = 0; k0 < n && got != wanted; k0 += 32) {
            unsigned hit = 0;
            if (k0 + lane < n) {
              const float4 q = staged[k0 + lane];
#pragma unroll
              for (int u = 0; u < kTogether; ++u) {
                const float dx = min_image_abs(__fsub_rn(q.x, px[u]), lx);
                const float dy = min_image_abs(__fsub_rn(q.y, py[u]), ly);
                const float dz = min_image_abs(__fsub_rn(q.z, pz[u]), lz);
                const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                           __fmul_rn(dz, dz));
                hit |= static_cast<unsigned>(d2 <= c2) << u;
              }
            }
            got |= __reduce_or_sync(kFullWarp, hit) & wanted;
          }
#pragma unroll
          for (int u = 0; u < kTogether; ++u) {
            if (got >> u & 1) {
              open &= ~(1u << j[u]);
              found = found || lane == j[u];
            }
          }
        }
      }
      const unsigned pos = static_cast<unsigned>(__float_as_int(p.w));
      if (found && pos < static_cast<unsigned>(n_src)) out[pos] = 1;
    }
  }
}

}  // namespace

extern "C" {

// Enqueues the stencil of n_frames frames on `stream`; returns
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for a tile outside
// [1, 32]. Device pointers, all contiguous:
//   src_rec (n_frames, nx*ny*nz, cap, 4) f32, tgt_rec (n_frames, nx*ny*nz,
//   tcap, 4) f32 and counts (n_frames, 2, nx*ny*nz) i32 as cell_bin_launch
//   leaves them; boxes (n_frames, 3, 3) f32, diagonal (the box lengths);
//   mask (n_frames, n_src) bytes, zeroed by the caller (only hits are
//   written; a record whose list position is outside [0, n_src) writes
//   nothing). tile: consecutive cells a block looks after.
int within_rows_launch(const float* src_rec, const float* tgt_rec, const int* counts,
                       const float* boxes, uint8_t* mask, int n_frames, int n_src, int nx,
                       int ny, int nz, int cap, int tcap, int tile, float c2, void* stream) {
  if (tile < 1 || tile > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nx * ny * nz + tile - 1) / tile, n_frames);
  within_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(src_rec), reinterpret_cast<const float4*>(tgt_rec),
      counts, boxes, mask, n_src, nx, ny, nz, cap, tcap, tile, c2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
