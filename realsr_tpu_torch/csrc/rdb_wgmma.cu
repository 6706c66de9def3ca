// Fused residual dense block (RDB) for Hopper (sm_90a) on wgmma: K1 and K2.
//
// Replaces, in realsr_tpu/ops/rdb_kernel.py, _rdb_kernel (one RDB per call,
// rdb_apply) and _rdb_resident_kernel (the trunk with the RRDB residual
// folded in, rdb_apply_resident): one launch computes one RDB over a batch of
// NHWC tiles and, given `u` (the RRDB entry state), folds the RRDB residual
// into its epilogue, so the 69-RDB trunk is 69 launches
// (ops/rdb_kernel.py::rdb_trunk). Per tile, with every conv zero-padded at
// the tile border:
//   c_i = lrelu_0.2(conv3x3(concat(x, c_1..c_{i-1})) + b_i)   i = 1..4
//   c5  = conv3x3(concat(x, c1..c4)) + b5
//   y   = state(0.2 * c5 + x)
//   out = u ? state(0.2 * y + u) : y
// Operands (x, c1..c4, weights) are bf16, sums f32; state() rounds to the
// state type (f32 in mixed mode, bf16 in bfloat16 mode).
//
// Bound: operations. An RDB is 239,616 MACs per pixel at nf = 64, gc = 32
// against 512 bytes of f32 state read and written. One block owns a T x T
// output patch: its bf16 x window (T + 10)^2 and c1..c4 over the shrinking
// regions (T + 10 - 2i)^2 live in shared memory, as the TPU kernel keeps them
// out of HBM; the halo costs 1.31x the RDB's MACs at T = 17.
//
// Design (one block per SM, 384 threads: two consumer warpgroups and a
// producer warpgroup; setmaxnreg moves the producer's registers to the
// consumers, without which ptxas budgets 168 a thread, spills the A
// fragments and serializes every wgmma):
// - The consumers run each stage as a GEMM: rows = the stage's region in
//   64-pixel tiles (the warpgroups take alternate tiles, and split an odd
//   last one by columns), N = gc (c1..c4) or nf (c5), K stepped over
//   (source, tap, 16 channels). A is a gather (a tap's 64 rows are shifted
//   pixels of a source plane whose row pitch differs from the region's), so
//   it goes through registers: each warp's ldmatrix.x4 of 16 pixels x 16
//   channels is exactly the m16k16 fragment of wgmma.mma_async's register-A
//   form. The planes are pixel-major with the 16-byte channel chunks
//   XOR-swizzled by pixel, so those ldmatrix reads hit distinct banks.
// - One producer thread streams the weights, packed at load time as k16
//   slices in wgmma's canonical K-major layout without swizzle
//   (ops/rdb_kernel.py::_perm, order "wgmma"), through a ring of two 6 KB
//   slots in shared memory with cp.async.bulk and mbarriers (full: the chunk
//   landed; empty: all 8 consumer warps are done with it). B is read by
//   wgmma from the ring through a matrix descriptor. A slot holds 6 k16
//   slices of c1..c4 (3 of c5): per chunk a warpgroup waits once, gathers
//   all its A, fences once, issues all its products and waits for them, while
//   the other warpgroup's products keep the tensor cores busy (fewer, larger
//   chunks measured faster: tools/rdb_wgmma_ablation.py). The two take turns
//   to issue their products (named barriers), so that one gathers while the
//   other's products run.
// - The producer also prefetches the epilogue's rows of x and u into L2.
// - The x window arrives as one TMA tiled load of a [1, T+10, T+10, nf] box
//   of the bf16 operand plane (the state itself in bf16 mode; in mixed mode
//   a bf16 shadow of the f32 state that the previous RDB's epilogue wrote
//   beside it). TMA's 128-byte (nf = 64) or 64-byte (nf = 32) swizzle is the
//   planes' XOR swizzle, and its zero fill outside the tensor is the convs'
//   zero padding.
// - The patch side T is a template parameter: ops/rdb_kernel.py::
//   rdb_geometry picks it per chunk shape so that the grid fills the card's
//   SMs in whole waves (8 x 148^2: T = 17, 648 blocks, 4.91 waves).
// The machinery (layout, stage GEMM, epilogues, producer, window maps) is in
// rdb_wgmma.cuh, which K1's float32 instances (rdb_tf32.cu, 3xTF32) and the
// trunk modes' K3, K4 and K5 (rdb_modes_wgmma.cu; K3's and K5's float32
// instances in rdb_modes_tf32.cu) share.

#include "groups.cuh"
#include "rdb_wgmma.cuh"

namespace {

// Grid: (T x T patches of one tile, B).
template <int T, typename TS, int NF, int GC>
__global__ void __launch_bounds__(kThreads, 1)
    rdb_kernel(const __grid_constant__ CUtensorMap window, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  run_block<T, Layout<T, NF, GC>>(
      smem_raw, p.patches_x, p.H, p.W,
      [&](const Block& k) {
        // the epilogue's rows of the state and of u, into L2 while the stages run
        produce<T, NF>(&window, k, p.H, p.W, [&](size_t o, int n) { prefetch_state<TS, NF>(p, o, n); },
                       [&] { ring_scatter<T, NF, GC>(p.w, k); });
      },
      [&](Consumer& c, const Patch& t, int wg) {
        scatter_stages<T, NF, GC>(c, t, wg, p.bias, out_epi<T, TS, NF>(t, p));
      });
}

template <int T, typename TS, int NF, int GC>
int launch(const CUtensorMap& map, const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = Layout<T, NF, GC>::bytes;
  static_assert(smem <= kSmemBlock, "shared memory of one block");
  return launch_grid<T>(rdb_kernel<T, TS, NF, GC>, smem, map, p, B, stream);
}

template <typename TS, int NF, int GC>
int launch_tile(const CUtensorMap& map, const Params& p, int B, int tile, cudaStream_t s) {
  switch (tile) {
    case 17: return launch<17, TS, NF, GC>(map, p, B, s);
    case 12: return launch<12, TS, NF, GC>(map, p, B, s);
    case 8: return launch<8, TS, NF, GC>(map, p, B, s);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename TS>
int launch_shape(const CUtensorMap& map, const Params& p, int B, int nf, int gc, int tile, cudaStream_t s) {
#ifdef GROUP_NF64
  if (nf == 64 && gc == 32) return launch_tile<TS, 64, 32>(map, p, B, tile, s);
#endif
#ifdef GROUP_NF32
  if (nf == 32 && gc == 16) return launch_tile<TS, 32, 16>(map, p, B, tile, s);
#endif
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// One RDB over B tiles (K1/K2), bf16 operands. xs: the [B, H, W, nf] bf16
// operand plane the window is read from (x itself when the state is bf16);
// x: the state (f32, or bf16 when state_bf16); u: the RRDB entry state or
// null; out: the new state; shadow: null, or where bf16(out) goes; w: the
// weights in wgmma order; tile: the patch side (17, 12 or 8). nf, gc = 64,
// 32 or 32, 16. Returns the cudaError_t of the launch.
int rdb_wgmma_launch(const void* xs, const void* x, const void* w, const void* bias, const void* u,
                     void* out, void* shadow, int B, int H, int W, int nf, int gc, int state_bf16,
                     int tile, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1) return int(cudaErrorInvalidValue);
  CUtensorMap map;
  const int err = window_map(xs, B, H, W, nf, tile, &map);
  if (err) return err;
  const Params p{x, u, out, static_cast<__nv_bfloat16*>(shadow), static_cast<const __nv_bfloat16*>(w),
                 static_cast<const float*>(bias), H, W, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef GROUP_BF16
  if (state_bf16) return launch_shape<__nv_bfloat16>(map, p, B, nf, gc, tile, s);
#endif
#ifdef GROUP_F32
  if (!state_bf16) return launch_shape<float>(map, p, B, nf, gc, tile, s);
#endif
  return int(cudaErrorInvalidValue);
}

const char* rdb_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
