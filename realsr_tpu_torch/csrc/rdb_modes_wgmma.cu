// The trunk's alternative modes on K1's wgmma machinery (rdb_wgmma.cuh), for
// Hopper (sm_90a), with bf16 operands: K3, the chained layout, K4, the
// paired carry, and K5, the K-packed schedule.
//
// Replaces, in realsr_tpu/ops/rdb_kernel.py:
//   K3 _rdb_kernel(chained=True) (rdb_apply_chained): chained_kernel
//      (rdb_modes.cuh);
//   K4 _rdb_kernel(paired=True) (rdb_apply_paired): paired_kernel below;
//   K5 the sched="packed" branch of _make_rdb_compute (rdb_apply with
//      SCHED="packed"): packed_kernel (rdb_modes.cuh).
// Python side: realsr_tpu_torch/ops/rdb_kernel.py (rdb_apply_chained,
// rdb_apply_paired, rdb_apply_packed, rdb_trunk_chained, rdb_trunk_paired,
// rdb_trunk(sched="packed")). K3's and K5's float32 instances are in
// rdb_modes_tf32.cu; K4 is mixed-only (the JAX package's paired carry).
//
// Each computes one RDB over a batch of NHWC tiles as K1 does (rdb_wgmma.cu):
// one block of two consumer warpgroups and a producer warpgroup owns a T x T
// output patch; its bf16 window arrives by TMA, c1..c4 stay in shared memory,
// the stages run as wgmma GEMMs with register A (ldmatrix) and B streamed
// through a weight ring by cp.async.bulk. Bound: operations, as K1. K3's and
// K5's designs are described in rdb_modes.cuh.
//
// K4 (paired carry): the float32 state x = hi + lo travels as two bf16
// planes. The stages are K1's. The window is a TMA box of hi itself, so no
// launch casts the state or writes a shadow: rdb_trunk_paired threads hi'
// straight into the next launch. The epilogue (PairedEpi) reads hi at the
// centre from the window in shared memory and lo, u_hi, u_lo from global
// memory (the producer prefetches their rows into L2):
//   center = (0.2 c5 + hi) + lo,  hi' = bf16(center),  lo' = bf16(center - hi')
// and with the RRDB residual 0.2 (hi' + lo') + (u_hi + u_lo) split again.
// Against K1 it reads lo (2 bytes a channel) where K1 reads the f32 state
// (4) and writes hi' + lo' (4) where K1 writes f32 + its shadow (6).

#include "groups.cuh"
#include "rdb_modes.cuh"

namespace {

__device__ __forceinline__ void split_bf16(float v, float& hi, float& lo) {
  hi = round_to<__nv_bfloat16>(v);
  lo = round_to<__nv_bfloat16>(v - hi);
}

// ---------------------------------------------------------------------------
// K4: the paired carry
// ---------------------------------------------------------------------------

struct PairedParams {
  const __nv_bfloat16* lo;    // the state's lo plane [B, H, W, NF] (hi is the window's tensor)
  const __nv_bfloat16* u_hi;  // the RRDB entry state's planes, or both nullptr (no residual)
  const __nv_bfloat16* u_lo;
  __nv_bfloat16* out_hi;      // hi', lo'
  __nv_bfloat16* out_lo;
  const __nv_bfloat16* w;     // k16 slices in wgmma order, stage by stage (K1's)
  const float* bias;          // [4 GC + NF]
  int H, W, patches_x;
};

// The paired output from c5, hi read from the window. Every load of a pixel
// comes before its stores.
template <int T, int NF>
struct PairedEpi {
  const Patch& t;
  const PairedParams p;
  template <int NR>
  __device__ __forceinline__ void operator()(int tile, const float (&acc)[NR], int col0) const {
    constexpr int G = NR / 4, S0 = side<T>(0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tile * 64 + t.warp * 16 + t.gid + 8 * h;
      if (q >= T * T) continue;
      const int qy = q / T, qx = q % T, ty = t.py0 + qy, tx = t.px0 + qx;
      if (ty >= t.H || tx >= t.W) continue;
      const size_t o = ((size_t(t.b) * t.H + ty) * t.W + tx) * NF + col0 + t.tig * 2;
      const int pix = (qy + kHalo) * S0 + qx + kHalo;  // the window's pixel
      float hv[G][2], lv[G][2], uh[G][2], ul[G][2];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const __nv_bfloat162 w2 = *reinterpret_cast<const __nv_bfloat162*>(
            t.base + chunk_offset<NF>(pix, col0 / 8 + j) + t.tig * 4);
        hv[j][0] = __low2float(w2);
        hv[j][1] = __high2float(w2);
        load2(p.lo + o + j * 8, lv[j]);
        if (p.u_hi != nullptr) {
          load2(p.u_hi + o + j * 8, uh[j]);
          load2(p.u_lo + o + j * 8, ul[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float y[2], l[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // the residual rebuilds both states in f32 first, as the JAX
          // trunk sums them
          split_bf16((kResidual * acc[4 * j + 2 * h + e] + hv[j][e]) + lv[j][e], y[e], l[e]);
          if (p.u_hi != nullptr) split_bf16(kResidual * (y[e] + l[e]) + (uh[j][e] + ul[j][e]), y[e], l[e]);
        }
        store2(p.out_hi + o + j * 8, y);
        store2(p.out_lo + o + j * 8, l);
      }
    }
  }
};

// Grid: (T x T patches of one tile, B).
template <int T, int NF, int GC>
__global__ void __launch_bounds__(kThreads, 1)
    paired_kernel(const __grid_constant__ CUtensorMap window, const PairedParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  run_block<T, Layout<T, NF, GC>>(
      smem_raw, p.patches_x, p.H, p.W,
      [&](const Block& k) {
        const auto rows = [&](size_t o, int n) {
          prefetch_l2(p.lo + o, n * NF * 2);
          if (p.u_hi != nullptr) {
            prefetch_l2(p.u_hi + o, n * NF * 2);
            prefetch_l2(p.u_lo + o, n * NF * 2);
          }
        };
        produce<T, NF>(&window, k, p.H, p.W, rows, [&] { ring_scatter<T, NF, GC>(p.w, k); });
      },
      [&](Consumer& c, const Patch& t, int wg) {
        scatter_stages<T, NF, GC>(c, t, wg, p.bias, PairedEpi<T, NF>{t, p});
      });
}


// ---------------------------------------------------------------------------
// Host side: the instances (K3 and K4 at K1's patch sides 17, 12, 8; K5 at
// 12, 8)
// ---------------------------------------------------------------------------

template <typename TS, int NF, int GC>
int chained_tile(const CUtensorMap& map, const ChainedParams& p, int B, int tile, cudaStream_t s) {
  switch (tile) {
    case 17: return launch_chained<17, TS, NF, GC, Layout<17, NF, GC>>(map, p, B, s);
    case 12: return launch_chained<12, TS, NF, GC, Layout<12, NF, GC>>(map, p, B, s);
    case 8: return launch_chained<8, TS, NF, GC, Layout<8, NF, GC>>(map, p, B, s);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename TS>
int chained_shape(const CUtensorMap& map, const ChainedParams& p, int B, int nf, int gc, int tile, cudaStream_t s) {
#ifdef GROUP_NF64
  if (nf == 64 && gc == 32) return chained_tile<TS, 64, 32>(map, p, B, tile, s);
#endif
#ifdef GROUP_NF32
  if (nf == 32 && gc == 16) return chained_tile<TS, 32, 16>(map, p, B, tile, s);
#endif
  return int(cudaErrorInvalidValue);
}

template <int T, int NF, int GC>
int launch_paired(const CUtensorMap& map, const PairedParams& p, int B, cudaStream_t s) {
  constexpr int smem = Layout<T, NF, GC>::bytes;
  static_assert(smem <= kSmemBlock, "shared memory of one block");
  return launch_grid<T>(paired_kernel<T, NF, GC>, smem, map, p, B, s);
}

template <int NF, int GC>
int paired_tile(const CUtensorMap& map, const PairedParams& p, int B, int tile, cudaStream_t s) {
  switch (tile) {
    case 17: return launch_paired<17, NF, GC>(map, p, B, s);
    case 12: return launch_paired<12, NF, GC>(map, p, B, s);
    case 8: return launch_paired<8, NF, GC>(map, p, B, s);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename TS, int NF, int GC>
int packed_tile(const CUtensorMap& map, const Params& p, int B, int tile, cudaStream_t s) {
  switch (tile) {
    case 12: return launch_packed<12, TS, NF, GC, Layout<12, NF, GC>>(map, p, B, s);
    case 8: return launch_packed<8, TS, NF, GC, Layout<8, NF, GC>>(map, p, B, s);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename TS>
int packed_shape(const CUtensorMap& map, const Params& p, int B, int nf, int gc, int tile, cudaStream_t s) {
#ifdef GROUP_NF64
  if (nf == 64 && gc == 32) return packed_tile<TS, 64, 32>(map, p, B, tile, s);
#endif
#ifdef GROUP_NF32
  if (nf == 32 && gc == 16) return packed_tile<TS, 32, 16>(map, p, B, tile, s);
#endif
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// K3: one RDB on the chained layout [B, rows, cols, nf] (the image at row
// and column 5, zeros elsewhere; rows >= H + 10, cols >= W + 10). xs: the
// layout's bf16 operand plane the window is read from (x itself when the
// state is bf16); out: its image becomes the RDB of x's, with 0.2 y + u
// where *flag == 1 (u may be out); shadow: null, or the layout that gets
// bf16(out) at the image. w: K1's weights in wgmma order; tile: the patch
// side (17, 12 or 8); nf, gc = 64, 32 or 32, 16. Returns the cudaError_t of
// the launch.
int rdb_chained_launch(const void* xs, const void* x, const void* w, const void* bias, const void* u,
                       const void* flag, void* out, void* shadow, int B, int H, int W, int rows, int cols, int nf,
                       int gc, int state_bf16, int tile, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || flag == nullptr || rows < H + 2 * kHalo || cols < W + 2 * kHalo)
    return int(cudaErrorInvalidValue);
  CUtensorMap map;
  const int err = window_map(xs, B, rows, cols, nf, tile, &map);
  if (err) return err;
  const ChainedParams p{x, u, out, static_cast<__nv_bfloat16*>(shadow), static_cast<const int*>(flag),
                        w, static_cast<const float*>(bias), H, W, 0, rows,
                        cols};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef GROUP_BF16
  if (state_bf16) return chained_shape<__nv_bfloat16>(map, p, B, nf, gc, tile, s);
#endif
#ifdef GROUP_F32
  if (!state_bf16) return chained_shape<float>(map, p, B, nf, gc, tile, s);
#endif
  return int(cudaErrorInvalidValue);
}

// K4: one RDB on the paired state hi + lo ([B, H, W, nf] bf16 each; the
// window is read from hi) into out_hi + out_lo; u_hi / u_lo (both or
// neither): the RRDB residual. w: K1's weights in wgmma order; tile: the
// patch side (17, 12 or 8); nf, gc = 64, 32 or 32, 16. Returns the
// cudaError_t of the launch.
int rdb_paired_launch(const void* hi, const void* lo, const void* w, const void* bias, const void* u_hi,
                      const void* u_lo, void* out_hi, void* out_lo, int B, int H, int W, int nf, int gc, int tile,
                      void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || (u_hi == nullptr) != (u_lo == nullptr))
    return int(cudaErrorInvalidValue);
  CUtensorMap map;
  const int err = window_map(hi, B, H, W, nf, tile, &map);
  if (err) return err;
  using bf = __nv_bfloat16;
  const PairedParams p{static_cast<const bf*>(lo), static_cast<const bf*>(u_hi), static_cast<const bf*>(u_lo),
                       static_cast<bf*>(out_hi), static_cast<bf*>(out_lo), static_cast<const bf*>(w),
                       static_cast<const float*>(bias), H, W, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the paired carry holds a float32 state as two bf16 planes: its
  // instances are the float32 state's
#if defined(GROUP_F32) && defined(GROUP_NF64)
  if (nf == 64 && gc == 32) return paired_tile<64, 32>(map, p, B, tile, s);
#endif
#if defined(GROUP_F32) && defined(GROUP_NF32)
  if (nf == 32 && gc == 16) return paired_tile<32, 16>(map, p, B, tile, s);
#endif
  return int(cudaErrorInvalidValue);
}

// K5: one RDB in the K-packed schedule over B tiles, bf16 operands; the
// arguments as rdb_wgmma_launch's (rdb_wgmma.cu), w: the five packed
// rectangles in wgmma order; tile: the patch side (12 or 8).
int rdb_packed_launch(const void* xs, const void* x, const void* w, const void* bias, const void* u, void* out,
                      void* shadow, int B, int H, int W, int nf, int gc, int state_bf16, int tile, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1) return int(cudaErrorInvalidValue);
  CUtensorMap map;
  const int err = window_map(xs, B, H, W, nf, tile, &map);
  if (err) return err;
  const Params p{x, u, out, static_cast<__nv_bfloat16*>(shadow), static_cast<const __nv_bfloat16*>(w),
                 static_cast<const float*>(bias), H, W, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef GROUP_BF16
  if (state_bf16) return packed_shape<__nv_bfloat16>(map, p, B, nf, gc, tile, s);
#endif
#ifdef GROUP_F32
  if (!state_bf16) return packed_shape<float>(map, p, B, nf, gc, tile, s);
#endif
  return int(cudaErrorInvalidValue);
}

const char* rdb_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
