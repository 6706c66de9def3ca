// The trunk's alternative modes on K1's wgmma machinery (rdb_wgmma.cuh), for
// Hopper (sm_90a): K3, the chained layout, K4, the paired carry, and K5,
// the K-packed schedule.
//
// Replaces, in realsr_tpu/ops/rdb_kernel.py:
//   K3 _rdb_kernel(chained=True) (rdb_apply_chained): chained_kernel below;
//   K4 _rdb_kernel(paired=True) (rdb_apply_paired): paired_kernel below;
//   K5 the sched="packed" branch of _make_rdb_compute (rdb_apply with
//      SCHED="packed"): packed_kernel below.
// Python side: realsr_tpu_torch/ops/rdb_kernel.py (rdb_apply_chained,
// rdb_apply_paired, rdb_apply_packed, rdb_trunk_chained, rdb_trunk_paired,
// rdb_trunk(sched="packed")).
//
// Each computes one RDB over a batch of NHWC tiles as K1 does (rdb_wgmma.cu):
// one block of two consumer warpgroups and a producer warpgroup owns a T x T
// output patch; its bf16 window arrives by TMA, c1..c4 stay in shared memory,
// the stages run as wgmma GEMMs with register A (ldmatrix) and B streamed
// through a weight ring by cp.async.bulk. Bound: operations, as K1.
//
// K3 (chained layout): K1's stages and grid on the persistent layout
// [B, rows, cols, nf] of ops/rdb_kernel.py::to_chained (the image at row and
// column 5, zeros elsewhere; rows, cols at least H + 10, W + 10), residual
// folded where the int32 device flag is 1, so a trunk of 69 launches needs
// no host decision and no re-padding between them. The window is a TMA box
// of the layout's bf16 operand plane at the patch's place: the zero aprons
// and TMA's zero fill past the tensor are the convs' zero padding, so the
// layout's rounding (CHAIN_TILE) need not match the patch side. c1..c4 stay
// masked outside the H x W image, and only image pixels are written, so the
// aprons stay zero. In mixed mode the epilogue (ChainedEpi) also writes
// bf16(out) into the layout of the next step's operand plane (the shadow,
// as K1's); rdb_trunk_chained rotates three shadows with the three buffers.
// The residual step writes buffer 0 while reading u = buffer 0: each pixel
// reads its own u before it writes.
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
//
// K5 (K-packed schedule): the JAX package's five rectangles, each one GEMM
// over its first output's region:
//   A {x} -> {c1, a2}           N = 2 gc,       over c1's region
//   B {c1} -> {c2}              N = gc,         over c2's
//   C {x, c1, c2} -> {c3, a4, a5}  N = 2 gc + nf (128), K = 9 (nf + 2 gc)
//   D {c3} -> {c4, a5}          N = gc + nf (96)
//   E {c4} -> {c5}              N = nf
// a2, a4, a5 are f32 partial sums in shared memory, pixel rows padded by
// kPadF floats against bank conflicts; a2 (c2's region) shares its bytes with
// a4 + a5, born after a2 dies. Each rectangle is K1's Gemm with its own N, K
// walking its sources in order (x ++ c1 ++ c2 for C) and accumulators from
// zero; its epilogue (RectEpi) adds the bias or the partial sum after the
// product, as the plain version groups the sums, and sends each 8-column
// group of an m-tile to the output it belongs to (the odd last tile split by
// columns may straddle two outputs). E's epilogue is K1's OutEpi on a5 + the
// product. The partials cap the patch side at 12: at T = 12, nf = 64, the
// planes take 137,216 B and the partials 67,392 B, which leaves two 12 KB ring
// slots (three k16 slices of C, 4 KB each); at T = 13 planes and partials
// alone take 230,304 B. Each rectangle's chunk holds at most a slot and keeps
// its accumulators and A fragments within kAccA registers (C at T = 12: two
// m-tiles x 64 accumulators per warpgroup, 128 registers; chunks of 3).
// The packed rectangles issue more MACs than K1's stages (2.20x the RDB's at
// 8 x 148^2, T = 12, against K1's 1.50x at T = 17) but gather each source's A
// fewer times (x twice, c1 twice, c2..c4 once; K1 gathers x five times).

#include "rdb_wgmma.cuh"

namespace {

constexpr int kPadF = 4;          // floats of padding per pixel row of the partial sums
constexpr int kPackedSlices = 3;  // k16 slices of rectangle C a ring slot holds

__device__ __forceinline__ void split_bf16(float v, float& hi, float& lo) {
  hi = round_to<__nv_bfloat16>(v);
  lo = round_to<__nv_bfloat16>(v - hi);
}

// ---------------------------------------------------------------------------
// K3: the chained layout
// ---------------------------------------------------------------------------

struct ChainedParams {
  const void* x;           // the state, chained [B, rows, cols, NF] (f32 or bf16)
  const void* u;           // the RRDB entry state (chained), folded where *flag == 1
  void* out;               // the new state (chained): its image pixels only
  __nv_bfloat16* shadow;   // bf16(out) in the chained layout, or nullptr
  const int* flag;         // int32 on the device
  const __nv_bfloat16* w;  // K1's k16 slices in wgmma order
  const float* bias;       // [4 GC + NF]
  int H, W, patches_x;     // the image
  int rows, cols;          // pixel (b, y, x) of the image at ((b rows + y + 5) cols + x + 5) NF
};

// Element offset of image pixel (b, y, x) in the chained layout
__device__ __forceinline__ size_t chained_at(const ChainedParams& p, int b, int y, int x) {
  return (size_t(b) * p.rows + y + kHalo) * p.cols + x + kHalo;
}

// K1's output (OutEpi) at the layout's addresses, with the residual where
// `fold`. u may be out: every load of a pixel comes before its stores.
template <int T, typename TS, int NF>
struct ChainedEpi {
  const Patch& t;
  const ChainedParams p;
  const bool fold;
  template <int NR>
  __device__ __forceinline__ void operator()(int tile, const float (&acc)[NR], int col0) const {
    constexpr int G = NR / 4;  // 8-column groups
    const TS* __restrict__ x = static_cast<const TS*>(p.x);
    const TS* u = static_cast<const TS*>(p.u);
    TS* out = static_cast<TS*>(p.out);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tile * 64 + t.warp * 16 + t.gid + 8 * h;
      if (q >= T * T) continue;
      const int ty = t.py0 + q / T, tx = t.px0 + q % T;
      if (ty >= t.H || tx >= t.W) continue;
      const size_t o = chained_at(p, t.b, ty, tx) * NF + col0 + t.tig * 2;
      float xv[G][2], uv[G][2];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        load2(x + o + j * 8, xv[j]);
        if (fold) load2(u + o + j * 8, uv[j]);
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          y[e] = round_to<TS>(kResidual * acc[4 * j + 2 * h + e] + xv[j][e]);
          if (fold) y[e] = round_to<TS>(kResidual * y[e] + uv[j][e]);
        }
        store2(out + o + j * 8, y);
        if (p.shadow != nullptr) store2(p.shadow + o + j * 8, y);
      }
    }
  }
};

// Grid: (T x T patches of the image, B).
template <int T, typename TS, int NF, int GC>
__global__ void __launch_bounds__(kThreads, 1)
    chained_kernel(const __grid_constant__ CUtensorMap window, const ChainedParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  run_block<T, Layout<T, NF, GC>>(
      smem_raw, p.patches_x, p.H, p.W,
      [&](const Block& k) {
        // image pixel (py0 - 5, px0 - 5) is the layout's (py0, px0)
        load_window<T, NF>(&window, k, k.px0, k.py0);
        const bool fold = __ldg(p.flag) == 1;
        const int n = min(T, p.W - k.px0);
        for (int y = 0; y < min(T, p.H - k.py0); ++y) {
          const size_t o = chained_at(p, k.b, k.py0 + y, k.px0) * NF;
          prefetch_l2(static_cast<const TS*>(p.x) + o, n * NF * int(sizeof(TS)));
          if (fold) prefetch_l2(static_cast<const TS*>(p.u) + o, n * NF * int(sizeof(TS)));
        }
        ring_scatter<T, NF, GC>(p.w, k);
      },
      [&](Consumer& c, const Patch& t, int wg) {
        scatter_stages<T, NF, GC>(c, t, wg, p.bias, ChainedEpi<T, TS, NF>{t, p, __ldg(p.flag) == 1});
      });
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
// K5: the K-packed schedule
// ---------------------------------------------------------------------------

// Shared memory: K1's planes, then the partial sums (a2; later a4 and a5 in
// the same bytes), then a ring of two slots of kPackedSlices slices of C.
template <int T, int NF, int GC>
struct PackedLayout : Layout<T, NF, GC> {
  static constexpr int A24 = GC + kPadF, A5 = NF + kPadF;  // floats per pixel row of a2 and a4, of a5
  static constexpr int partials = Layout<T, NF, GC>::plane(5);
  static constexpr int a5 = side<T>(4) * side<T>(4) * A24;  // a5's first float, after a4
  static constexpr int partial_bytes =
      cmax(4 * side<T>(2) * side<T>(2) * A24, 4 * (a5 + side<T>(5) * side<T>(5) * A5));
  static constexpr int slot = kPackedSlices * (2 * GC + NF) * 32;
  static constexpr int ring = partials + partial_bytes;
  static constexpr int bars = ring + kSlots * slot;
  static constexpr int bytes = bars + 8 * (2 * kSlots + 1) + 1024;
};

// Rectangle I (1..5 = A..E) over region I: its first source, its N, and its
// chunk length (whole slices in a slot, accumulators + A within kAccA).
template <int T, int NF, int GC>
struct Rects {
  static constexpr int j0(int i) { return i == 1 || i == 3 ? 0 : i - 1; }
  static constexpr int n(int i) {
    return i == 1 ? 2 * GC : i == 2 ? GC : i == 3 ? 2 * GC + NF : i == 4 ? GC + NF : NF;
  }
  static constexpr int kc(int i) {
    const int tiles = (side<T>(i) * side<T>(i) + 63) / 64, mf = tiles / 2, mh = tiles % 2;
    const int acc = mf * n(i) / 2 + mh * n(i) / 4;
    return cmin(PackedLayout<T, NF, GC>::slot / (n(i) * 32), (kAccA - acc) / (4 * (mf + mh)));
  }
};

template <int T, int NF, int GC, int I, class R = Rects<T, NF, GC>>
using Rect = Gemm<T, NF, GC, I, PackedLayout<T, NF, GC>, R::j0(I), R::n(I), R::kc(I), false>;

// Rectangle I's epilogue on one m-tile (columns col0 ...): per 8-column
// group, the output it belongs to, with the bias or partial sum added after
// the product.
template <int T, typename TS, int NF, int GC, int I>
struct RectEpi {
  using PL = PackedLayout<T, NF, GC>;
  const Patch& t;
  const float* __restrict__ bias;  // [4 GC + NF]: b1..b5
  OutEpi<T, TS, NF> out;           // E
  template <int NR>
  __device__ __forceinline__ void operator()(int tile, const float (&acc)[NR], int col0) const {
    constexpr int S = side<T>(I), A24 = PL::A24, A5 = PL::A5;
    float* const a2 = reinterpret_cast<float*>(t.base + PL::partials);  // a2, later a4
    float* const a4 = a2;
    float* const a5 = a2 + PL::a5;
    const auto f2 = [](float* a) -> float2& { return *reinterpret_cast<float2*>(a); };
    if constexpr (I == 5) {
      float c5[NR];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = tile * 64 + t.warp * 16 + t.gid + 8 * h;
#pragma unroll
        for (int j = 0; j < NR / 4; ++j) {
          const float2 s = q < S * S ? f2(a5 + q * A5 + col0 + 8 * j + t.tig * 2) : make_float2(0.f, 0.f);
          c5[4 * j + 2 * h] = s.x + acc[4 * j + 2 * h];
          c5[4 * j + 2 * h + 1] = s.y + acc[4 * j + 2 * h + 1];
        }
      }
      out(tile, c5, col0);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = tile * 64 + t.warp * 16 + t.gid + 8 * h;
        if (q >= S * S) continue;
        const int qy = q / S, qx = q % S;
        const bool in = inside<T, I>(t, q);
        // where this pixel lies in the next region (inset 1) and the one after (inset 2), or -1
        const int q1 = qy >= 1 && qy <= S - 2 && qx >= 1 && qx <= S - 2 ? (qy - 1) * (S - 2) + qx - 1 : -1;
        const int q2 = qy >= 2 && qy <= S - 3 && qx >= 2 && qx <= S - 3 ? (qy - 2) * (S - 4) + qx - 2 : -1;
#pragma unroll
        for (int j = 0; j < NR / 4; ++j) {
          const int col = col0 + 8 * j + t.tig * 2;  // this thread's first column of the group
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if constexpr (I == 1) {  // {c1, a2}: b1, b2 follow each other
            const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
            if (col < GC) put_c<T, NF, GC, 1>(t, q, in, col, v0 + b0, v1 + b1);
            else if (q1 >= 0) f2(a2 + q1 * A24 + col - GC) = make_float2(v0 + b0, v1 + b1);
          } else if constexpr (I == 2) {  // c2 = lrelu(a2 + .)
            const float2 s = f2(a2 + q * A24 + col);
            put_c<T, NF, GC, 2>(t, q, in, col, s.x + v0, s.y + v1);
          } else if constexpr (I == 3) {  // {c3, a4, a5}: b3, b4, b5 follow each other
            const float b0 = __ldg(bias + 2 * GC + col), b1 = __ldg(bias + 2 * GC + col + 1);
            if (col < GC) put_c<T, NF, GC, 3>(t, q, in, col, v0 + b0, v1 + b1);
            else if (col < 2 * GC) {
              if (q1 >= 0) f2(a4 + q1 * A24 + col - GC) = make_float2(v0 + b0, v1 + b1);
            } else if (q2 >= 0) {
              f2(a5 + q2 * A5 + col - 2 * GC) = make_float2(v0 + b0, v1 + b1);
            }
          } else {  // {c4 = lrelu(a4 + .), a5 += .}
            if (col < GC) {
              const float2 s = f2(a4 + q * A24 + col);
              put_c<T, NF, GC, 4>(t, q, in, col, s.x + v0, s.y + v1);
            } else if (q1 >= 0) {
              float2& s = f2(a5 + q1 * A5 + col - GC);
              s = make_float2(s.x + v0, s.y + v1);
            }
          }
        }
      }
    }
  }
};

// Grid: (T x T patches of one tile, B).
template <int T, typename TS, int NF, int GC>
__global__ void __launch_bounds__(kThreads, 1)
    packed_kernel(const __grid_constant__ CUtensorMap window, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  run_block<T, PackedLayout<T, NF, GC>>(
      smem_raw, p.patches_x, p.H, p.W,
      [&](const Block& k) {
        produce<T, NF>(&window, k, p.H, p.W, [&](size_t o, int n) { prefetch_state<TS, NF>(p, o, n); }, [&] {
          // each rectangle's k16 slices in chunks of its KC
          using PL = PackedLayout<T, NF, GC>;
          const char* src = reinterpret_cast<const char*>(p.w);
          int s = 0;
          ring_gemm<Rect<T, NF, GC, 1>, PL>(src, k, s);
          ring_gemm<Rect<T, NF, GC, 2>, PL>(src, k, s);
          ring_gemm<Rect<T, NF, GC, 3>, PL>(src, k, s);
          ring_gemm<Rect<T, NF, GC, 4>, PL>(src, k, s);
          ring_gemm<Rect<T, NF, GC, 5>, PL>(src, k, s);
        });
      },
      [&](Consumer& c, const Patch& t, int wg) {
        const auto out = out_epi<T, TS, NF>(t, p);
        run_stage<Rect<T, NF, GC, 1>>(c, nullptr, wg, RectEpi<T, TS, NF, GC, 1>{t, p.bias, out});
        consumers_sync();
        run_stage<Rect<T, NF, GC, 2>>(c, nullptr, wg, RectEpi<T, TS, NF, GC, 2>{t, p.bias, out});
        consumers_sync();
        run_stage<Rect<T, NF, GC, 3>>(c, nullptr, wg, RectEpi<T, TS, NF, GC, 3>{t, p.bias, out});
        consumers_sync();
        run_stage<Rect<T, NF, GC, 4>>(c, nullptr, wg, RectEpi<T, TS, NF, GC, 4>{t, p.bias, out});
        consumers_sync();
        run_stage<Rect<T, NF, GC, 5>>(c, nullptr, wg, RectEpi<T, TS, NF, GC, 5>{t, p.bias, out});
      });
}

// ---------------------------------------------------------------------------
// Host side: the instances (K3 and K4 at K1's patch sides 17, 12, 8; K5 at
// 12, 8)
// ---------------------------------------------------------------------------

template <int T, typename TS, int NF, int GC>
int launch_chained(const CUtensorMap& map, const ChainedParams& p, int B, cudaStream_t s) {
  constexpr int smem = Layout<T, NF, GC>::bytes;
  static_assert(smem <= kSmemBlock, "shared memory of one block");
  return launch_grid<T>(chained_kernel<T, TS, NF, GC>, smem, map, p, B, s);
}

template <typename TS, int NF, int GC>
int chained_tile(const CUtensorMap& map, const ChainedParams& p, int B, int tile, cudaStream_t s) {
  switch (tile) {
    case 17: return launch_chained<17, TS, NF, GC>(map, p, B, s);
    case 12: return launch_chained<12, TS, NF, GC>(map, p, B, s);
    case 8: return launch_chained<8, TS, NF, GC>(map, p, B, s);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename TS>
int chained_shape(const CUtensorMap& map, const ChainedParams& p, int B, int nf, int gc, int tile, cudaStream_t s) {
  if (nf == 64 && gc == 32) return chained_tile<TS, 64, 32>(map, p, B, tile, s);
  if (nf == 32 && gc == 16) return chained_tile<TS, 32, 16>(map, p, B, tile, s);
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

template <int T, typename TS, int NF, int GC>
int launch_packed(const CUtensorMap& map, const Params& p, int B, cudaStream_t s) {
  constexpr int smem = PackedLayout<T, NF, GC>::bytes;
  static_assert(smem <= kSmemBlock, "shared memory of one block");
  return launch_grid<T>(packed_kernel<T, TS, NF, GC>, smem, map, p, B, s);
}

template <typename TS, int NF, int GC>
int packed_tile(const CUtensorMap& map, const Params& p, int B, int tile, cudaStream_t s) {
  switch (tile) {
    case 12: return launch_packed<12, TS, NF, GC>(map, p, B, s);
    case 8: return launch_packed<8, TS, NF, GC>(map, p, B, s);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename TS>
int packed_shape(const CUtensorMap& map, const Params& p, int B, int nf, int gc, int tile, cudaStream_t s) {
  if (nf == 64 && gc == 32) return packed_tile<TS, 64, 32>(map, p, B, tile, s);
  if (nf == 32 && gc == 16) return packed_tile<TS, 32, 16>(map, p, B, tile, s);
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
                        static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias), H, W, 0, rows,
                        cols};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return state_bf16 ? chained_shape<__nv_bfloat16>(map, p, B, nf, gc, tile, s)
                    : chained_shape<float>(map, p, B, nf, gc, tile, s);
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
  if (nf == 64 && gc == 32) return paired_tile<64, 32>(map, p, B, tile, s);
  if (nf == 32 && gc == 16) return paired_tile<32, 16>(map, p, B, tile, s);
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
  return state_bf16 ? packed_shape<__nv_bfloat16>(map, p, B, nf, gc, tile, s)
                    : packed_shape<float>(map, p, B, nf, gc, tile, s);
}

const char* rdb_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
