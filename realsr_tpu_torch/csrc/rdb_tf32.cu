// Fused residual dense block (RDB) for Hopper (sm_90a) with float32
// operands: K1 and K2 of the float32 mode, on wgmma with a split TF32 product.
//
// Replaces, in realsr_tpu/ops/rdb_kernel.py, _rdb_kernel (rdb_apply) and
// _rdb_resident_kernel (rdb_apply_resident) where their operands are float32
// and their products run at Precision.HIGHEST (realsr_tpu/engine.py maps
// float32 storage to float32 operands): one launch computes one RDB over a
// batch of NHWC tiles, with the RRDB residual folded into its epilogue when
// given `u`; the trunk is 69 launches (ops/rdb_kernel.py::rdb_trunk). The
// arithmetic is rdb_wgmma.cu's with every operand (x, c1..c4, weights) and
// every sum in float32.
//
// Precision: on a TPU, HIGHEST is a multi-pass bf16 product that reaches
// float32 accuracy. Here each float32 operand is split into tf32 hi + lo
// and every product is A_lo B_hi + A_hi B_lo + A_hi B_hi (3xTF32), summed in
// f32. The weights split once on the host, both parts rounded to nearest
// (ops/rdb_kernel.py::tf32_split; "wt": per k8 step the hi slice, then the
// lo slice); the activations split in registers after their load, hi by
// truncation and lo = the exact rest, truncated by the tensor cores
// (hopper.cuh::split_tf32, two instructions). Each product then keeps all
// but ~2^-20 of its value (the activation's split ~2^-20, the dropped
// lo x lo term < 2^-21), far below the float32 sums' own order effects:
// against cuDNN in float32 the kernel stays at ~7e-6 of the output's scale,
// as with round-to-nearest on both sides. The split does not depend on
// PyTorch's TF32 flags (models/rrdbnet.py::tf32), which govern cuDNN's
// convolutions only.
//
// Bound: operations. An RDB is 239,616 MACs per pixel at nf = 64, gc = 32;
// three tf32 products of each at 495 TFLOP/s (dense tf32) take 0.509 ms at
// 8 x 148^2 (the float32 CUDA-core bound is 1.25 ms).
//
// Design: rdb_wgmma.cu's (rdb_wgmma.cuh: two consumer warpgroups running the
// stages as wgmma GEMMs on 64-pixel tiles with register A by ldmatrix, a
// producer warpgroup feeding a weight ring by cp.async.bulk and the window
// by TMA) on LayoutF32:
// - The window and c1..c4 stay in shared memory in f32, twice the bf16
//   bytes, which caps the patch side: at nf = 64 the planes take 220,160 B at
//   T = 10 (two 4 KB ring slots fit beside them) and 195,328 B at T = 9 (two
//   12 KB slots). The halo then costs ~2.0-2.2x the RDB's MACs against K1's
//   1.50x at T = 17. ops/rdb_kernel.py::tf32_geometry picks the side.
// - tf32 wgmma takes K-major operands only. A k8 step of f32 channels is 32
//   bytes of a pixel, as a k16 step of bf16 is, so ldmatrix.x4 on the b16
//   view of the pixel-major f32 planes gives the m16k8 tf32 fragment of each
//   warp; a k8 slice of B has the bytes of a bf16 k16 slice (b_desc).
// - No operand plane: TMA loads the f32 state's window directly, as two
//   32-channel boxes with TMA's 128B swizzle (nf = 64) into the two
//   sub-planes of the window (hopper.cuh::chunk_offset_f32).
// - A's hi and lo double its registers; each stage's chunk length keeps
//   accumulators + A within kAccA (LayoutF32::kc), else ptxas spills and
//   serializes the wgmmas.

#include "groups.cuh"
#include "rdb_wgmma.cuh"

namespace {

// Grid: (T x T patches of one tile, B).
template <int T, int NF, int GC>
__global__ void __launch_bounds__(kThreads, 1)
    rdb_tf32_kernel(const __grid_constant__ CUtensorMap window, const Params p) {
  using L = LayoutF32<T, NF, GC>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  run_block<T, L>(
      smem_raw, p.patches_x, p.H, p.W,
      [&](const Block& k) {
        produce<T, NF, float>(&window, k, p.H, p.W, [&](size_t o, int n) { prefetch_state<float, NF>(p, o, n); },
                              [&] { ring_stages<T, NF, GC, L>(p.w, k); });
      },
      [&](Consumer& c, const Patch& t, int wg) {
        scatter_stages<T, NF, GC, L>(c, t, wg, p.bias, out_epi<T, float, NF>(t, p));
      });
}

template <int T, int NF, int GC>
int launch(const CUtensorMap& map, const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = LayoutF32<T, NF, GC>::bytes;
  static_assert(smem <= kSmemBlock, "shared memory of one block");
  return launch_grid<T>(rdb_tf32_kernel<T, NF, GC>, smem, map, p, B, stream);
}

template <int NF, int GC>
int launch_tile(const CUtensorMap& map, const Params& p, int B, int tile, cudaStream_t s) {
  switch (tile) {
    case 10: return launch<10, NF, GC>(map, p, B, s);
    case 9: return launch<9, NF, GC>(map, p, B, s);
    case 8: return launch<8, NF, GC>(map, p, B, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// One RDB over B tiles (K1/K2) with float32 state and operands. x: the
// [B, H, W, nf] state, also the window's tensor; u: the RRDB entry state or
// null; out: the new state; w: the tf32 hi/lo k8 slices in wgmma order
// ("wt"); tile: the patch side (10, 9 or 8). nf, gc = 64, 32 or 32, 16.
// Returns the cudaError_t of the launch.
int rdb_tf32_launch(const void* x, const void* w, const void* bias, const void* u, void* out, int B, int H, int W,
                    int nf, int gc, int tile, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1) return int(cudaErrorInvalidValue);
  CUtensorMap map;
  const int err = window_map(x, B, H, W, nf, tile, &map, 4);
  if (err) return err;
  const Params p{x, u, out, nullptr, w, static_cast<const float*>(bias), H, W, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef GROUP_NF64
  if (nf == 64 && gc == 32) return launch_tile<64, 32>(map, p, B, tile, s);
#endif
#ifdef GROUP_NF32
  if (nf == 32 && gc == 16) return launch_tile<32, 16>(map, p, B, tile, s);
#endif
  return int(cudaErrorInvalidValue);
}

const char* rdb_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
