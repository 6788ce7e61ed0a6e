// Kernel B5: per-env active texel tables. Copies each visible cell's run
// of 8-row blocks of the aligned global table `tex_full` into its slot of
// the env's table; every other row stays zero.
//
// Replaces tpu_doom/ops/raster_pallas.py:gather_cells_pallas (kernel
// _gather_cells_kernel). meta (B, C, 3) int32 holds, per env and cell,
// [source block, slot block, block count] in 8-row block units (the walk
// builds it; invisible cells have count 0). The TPU kernel loops over
// cells in order because Mosaic needs 8-aligned dynamic offsets and one
// grid step per env; the 8-row units stay (they are the walk's contract)
// but the cells run in parallel here.
//
// Why parallel cells are safe: an env's slots are the exclusive prefix
// sum of its visible cells' own block counts, and the walk clamps each
// count so every write ends at or below row `act`
// (tpu_doom_torch/render/portal.py, `_active_set`). So no two cells of
// an env write the same row, and the order of the copies does not
// matter. A block whose source or destination would fall outside its
// buffer is skipped (never the case for the walk's meta); the plain
// version gather_cells_ref applies the same rule.
//
// Bound: bytes. On :texstress: with portal_global_segs_max=1024 the
// output is 256 envs x (9216 + 8) rows x 256 B = 604 MB per frame,
// zeroed by the wrapper, then filled with the visible cells' rows.
//
// Design: one block of 128 threads per (cell, env). An 8-row block is
// 8 x 128 int16 = 2048 B = 128 x 16 B, so each thread moves one int4 of
// each block: 16-byte loads and stores, consecutive threads on
// consecutive addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // int4 per 8-row block
constexpr int kBlockRows = 8;
constexpr int kRowInt4 = 128 * 2 / 16;  // 16

__global__ void gather_cells_kernel(const int32_t* __restrict__ meta,
                                    const int4* __restrict__ tex,
                                    int4* __restrict__ out, int C,
                                    int tex_blocks, int out_blocks,
                                    int out_rows) {
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int32_t* m = meta + ((size_t)b * C + c) * 3;
  const int g = m[0], s = m[1], n = m[2];
  int4* ob = out + (size_t)b * out_rows * kRowInt4;
  for (int i = 0; i < n; ++i) {
    const int src = g + i, dst = s + i;
    if (src < 0 || src >= tex_blocks || dst < 0 || dst >= out_blocks) continue;
    ob[(size_t)dst * kBlockRows * kRowInt4 + threadIdx.x] =
        __ldg(tex + (size_t)src * kBlockRows * kRowInt4 + threadIdx.x);
  }
}

}  // namespace

// tex: (tex_rows, 128) int16; out: (B, out_rows, 128) int16, zeroed.
extern "C" int tdt_gather_cells(const void* meta, const void* tex, void* out,
                                int B, int C, int tex_rows, int out_rows,
                                void* stream) {
  dim3 grid(C, B);
  gather_cells_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)meta, (const int4*)tex, (int4*)out, C,
      tex_rows / kBlockRows, out_rows / kBlockRows, out_rows);
  return (int)cudaGetLastError();
}
