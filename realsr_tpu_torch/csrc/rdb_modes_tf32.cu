// The trunk's alternative modes with float32 operands, for Hopper (sm_90a):
// K3, the chained layout, and K5, the K-packed schedule, on float32 K1's
// machinery (rdb_wgmma.cuh::LayoutF32: float32 planes, the split 3xTF32
// product; rdb_tf32.cu's header).
//
// Replaces, in realsr_tpu/ops/rdb_kernel.py, where their operands are float32
// at Precision.HIGHEST (the JAX package's float32 Pallas engine runs both;
// its paired carry, K4, is mixed-only and has no float32 form):
//   K3 _rdb_kernel(chained=True) (rdb_apply_chained): chained_kernel on
//      LayoutF32, patch sides 10, 9, 8 (float32 K1's, tf32_geometry);
//   K5 the sched="packed" branch of _make_rdb_compute (rdb_apply with
//      SCHED="packed"): packed_kernel on LayoutF32, patch sides 8 and 7
//      (packed_tf32_geometry).
// Python side: realsr_tpu_torch/ops/rdb_kernel.py (rdb_apply_chained,
// rdb_apply_packed, rdb_trunk_chained, rdb_trunk(sched="packed")). The
// kernels' designs are in rdb_modes.cuh. Bound: operations, three tf32
// products per MAC at 495 TFLOP/s (an RDB at 8 x 148^2: 0.509 ms).
//
// A source of its own, so that nvcc builds it beside rdb_modes_wgmma.cu (the
// first build's long pole) rather than after it.

#include "groups.cuh"
#include "rdb_modes.cuh"

namespace {

template <int NF, int GC>
int chained_tile(const CUtensorMap& map, const ChainedParams& p, int B, int tile, cudaStream_t s) {
  switch (tile) {
    case 10: return launch_chained<10, float, NF, GC, LayoutF32<10, NF, GC>>(map, p, B, s);
    case 9: return launch_chained<9, float, NF, GC, LayoutF32<9, NF, GC>>(map, p, B, s);
    case 8: return launch_chained<8, float, NF, GC, LayoutF32<8, NF, GC>>(map, p, B, s);
    default: return int(cudaErrorInvalidValue);
  }
}

template <int NF, int GC>
int packed_tile(const CUtensorMap& map, const Params& p, int B, int tile, cudaStream_t s) {
  switch (tile) {
    case 8: return launch_packed<8, float, NF, GC, LayoutF32<8, NF, GC>>(map, p, B, s);
    case 7: return launch_packed<7, float, NF, GC, LayoutF32<7, NF, GC>>(map, p, B, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// K3 with float32 state and operands: one RDB on the chained layout
// [B, rows, cols, nf] (the image at row and column 5, zeros elsewhere;
// rows >= H + 10, cols >= W + 10). x: the state, also the window's tensor;
// out: its image becomes the RDB of x's, with 0.2 y + u where *flag == 1
// (u may be out, not x); w: K1's float32 weights ("wt": per k8 step the
// tf32 hi slice, then the lo slice); tile: the patch side (10, 9 or 8); nf,
// gc = 64, 32 or 32, 16. Returns the cudaError_t of the launch.
int rdb_chained_tf32_launch(const void* x, const void* w, const void* bias, const void* u, const void* flag,
                            void* out, int B, int H, int W, int rows, int cols, int nf, int gc, int tile,
                            void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || flag == nullptr || rows < H + 2 * kHalo || cols < W + 2 * kHalo)
    return int(cudaErrorInvalidValue);
  CUtensorMap map;
  const int err = window_map(x, B, rows, cols, nf, tile, &map, 4);
  if (err) return err;
  const ChainedParams p{x, u, out, nullptr, static_cast<const int*>(flag), w, static_cast<const float*>(bias),
                        H, W, 0, rows, cols};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef GROUP_NF64
  if (nf == 64 && gc == 32) return chained_tile<64, 32>(map, p, B, tile, s);
#endif
#ifdef GROUP_NF32
  if (nf == 32 && gc == 16) return chained_tile<32, 16>(map, p, B, tile, s);
#endif
  return int(cudaErrorInvalidValue);
}

// K5 with float32 state and operands: one RDB in the K-packed schedule over
// B tiles. x: the [B, H, W, nf] state, also the window's tensor; u: the RRDB
// entry state or null; w: the five packed rectangles' k8 steps, each as its
// tf32 hi slice then its lo slice ("wt" of pack_rdb_params(sched="packed"));
// tile: the patch side (8 or 7). Returns the cudaError_t of the launch.
int rdb_packed_tf32_launch(const void* x, const void* w, const void* bias, const void* u, void* out, int B, int H,
                           int W, int nf, int gc, int tile, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1) return int(cudaErrorInvalidValue);
  CUtensorMap map;
  const int err = window_map(x, B, H, W, nf, tile, &map, 4);
  if (err) return err;
  const Params p{x, u, out, nullptr, w, static_cast<const float*>(bias), H, W, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef GROUP_NF64
  if (nf == 64 && gc == 32) return packed_tile<64, 32>(map, p, B, tile, s);
#endif
#ifdef GROUP_NF32
  if (nf == 32 && gc == 16) return packed_tile<32, 16>(map, p, B, tile, s);
#endif
  return int(cudaErrorInvalidValue);
}

const char* rdb_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
