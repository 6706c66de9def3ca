// The trunk modes' K3 (the chained layout) and K5 (the K-packed schedule)
// on K1's wgmma machinery (rdb_wgmma.cuh), for either operand type: the
// layout is a template argument, Layout (bf16 operands: instances in
// rdb_modes_wgmma.cu) or LayoutF32 (float32 operands, 3xTF32 products:
// instances in rdb_modes_tf32.cu). Each computes one RDB over a batch of
// NHWC tiles as K1 does: one block of two consumer warpgroups and a producer
// warpgroup owns a T x T output patch; its window arrives by TMA, c1..c4
// stay in shared memory, the stages run as wgmma GEMMs with register A
// (ldmatrix; float32 split into tf32 hi and lo) and B streamed through a
// weight ring by cp.async.bulk. Bound: operations, as K1.
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
// float32 operands: the window is a box of the float32 state itself (two
// 32-channel boxes, LayoutF32), the weights K1's float32 "wt", the chunks
// K1's float32 ones; no shadow. At the same patch side the stages and the
// epilogue are float32 K1's, so K3 is bit-equal to it.
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
// float32 operands: the planes are LayoutF32's (twice the bytes), so with
// the partials the patch side is at most 8 (nf = 64: 173,056 B of planes,
// 31,808 B of partials, two 12 KB ring slots; T = 9 needs 236,576 B before
// any ring). A ring slot holds one k8 step of C (8 KB, its hi and lo
// slices) and 2..6 steps of the other rectangles; accumulators + A (hi and
// lo) stay within kAccA (C at T = 8: 96 accumulators, chunks of 1).

#pragma once

#include "rdb_wgmma.cuh"

namespace {

constexpr int kPadF = 4;          // floats of padding per pixel row of the partial sums
constexpr int kPackedSlices = 3;  // k16 slices of rectangle C a bf16 ring slot holds

// ---------------------------------------------------------------------------
// K3: the chained layout
// ---------------------------------------------------------------------------

struct ChainedParams {
  const void* x;           // the state, chained [B, rows, cols, NF] (f32 or bf16)
  const void* u;           // the RRDB entry state (chained), folded where *flag == 1
  void* out;               // the new state (chained): its image pixels only
  __nv_bfloat16* shadow;   // bf16(out) in the chained layout, or nullptr (float32 operands: always)
  const int* flag;         // int32 on the device
  const void* w;           // K1's k-step slices in wgmma order (bf16, or tf32 hi/lo: "wt")
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

// Grid: (T x T patches of the image, B). L: Layout (bf16 operands, the
// window from the layout's bf16 operand plane) or LayoutF32 (float32
// operands, the window from the float32 state itself, K1's float32 chunks).
template <int T, typename TS, int NF, int GC, class L = Layout<T, NF, GC>>
__global__ void __launch_bounds__(kThreads, 1)
    chained_kernel(const __grid_constant__ CUtensorMap window, const ChainedParams p) {
  using OP = typename L::Operand;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  run_block<T, L>(
      smem_raw, p.patches_x, p.H, p.W,
      [&](const Block& k) {
        // image pixel (py0 - 5, px0 - 5) is the layout's (py0, px0)
        load_window<T, NF, OP>(&window, k, k.px0, k.py0);
        const bool fold = __ldg(p.flag) == 1;
        const int n = min(T, p.W - k.px0);
        for (int y = 0; y < min(T, p.H - k.py0); ++y) {
          const size_t o = chained_at(p, k.b, k.py0 + y, k.px0) * NF;
          prefetch_l2(static_cast<const TS*>(p.x) + o, n * NF * int(sizeof(TS)));
          if (fold) prefetch_l2(static_cast<const TS*>(p.u) + o, n * NF * int(sizeof(TS)));
        }
        if constexpr (sizeof(OP) == 2) {
          ring_scatter<T, NF, GC>(p.w, k);
        } else {
          ring_stages<T, NF, GC, L>(p.w, k);
        }
      },
      [&](Consumer& c, const Patch& t, int wg) {
        scatter_stages<T, NF, GC, L>(c, t, wg, p.bias, ChainedEpi<T, TS, NF>{t, p, __ldg(p.flag) == 1});
      });
}

// K3 at patch side T on layout L: the launch (grid and shared memory)
template <int T, typename TS, int NF, int GC, class L>
int launch_chained(const CUtensorMap& map, const ChainedParams& p, int B, cudaStream_t s) {
  constexpr int smem = L::bytes;
  static_assert(smem <= kSmemBlock, "shared memory of one block");
  return launch_grid<T>(chained_kernel<T, TS, NF, GC, L>, smem, map, p, B, s);
}

// ---------------------------------------------------------------------------
// K5: the K-packed schedule
// ---------------------------------------------------------------------------

// Shared memory: the planes of Base (K1's: bf16 Layout, or LayoutF32 for
// float32 operands), then the partial sums (a2; later a4 and a5 in the same
// bytes), then a ring of two slots: bf16, kPackedSlices k16 slices of C;
// float32, what the rest leaves in 2 KB units, at most kTf32Slot (one k8
// step of C, its tf32 hi and lo slices, is 8 KB at nf = 64).
template <int T, int NF, int GC, class Base = Layout<T, NF, GC>>
struct PackedLayout : Base {
  static constexpr int A24 = GC + kPadF, A5 = NF + kPadF;  // floats per pixel row of a2 and a4, of a5
  static constexpr int partials = Base::plane(5);
  static constexpr int a5 = side<T>(4) * side<T>(4) * A24;  // a5's first float, after a4
  static constexpr int partial_bytes =
      cmax(4 * side<T>(2) * side<T>(2) * A24, 4 * (a5 + side<T>(5) * side<T>(5) * A5));
  static constexpr int slot =
      sizeof(typename Base::Operand) == 2
          ? kPackedSlices * (2 * GC + NF) * 32
          : cmin(kTf32Slot, (kSmemBlock - 1024 - 8 * (2 * kSlots + 1) - partials - partial_bytes) / kSlots / 2048 * 2048);
  static constexpr int ring = partials + partial_bytes;
  static constexpr int bars = ring + kSlots * slot;
  static constexpr int bytes = bars + 8 * (2 * kSlots + 1) + 1024;
};

// Rectangle I (1..5 = A..E) over region I on layout PL: its first source,
// its N, and its chunk length (whole k-steps in a slot, accumulators + A
// within kAccA; float32 steps are twice the slices and A registers).
template <int T, int NF, int GC, class PL = PackedLayout<T, NF, GC>>
struct Rects {
  using OS = OperandSteps<typename PL::Operand>;
  static constexpr int j0(int i) { return i == 1 || i == 3 ? 0 : i - 1; }
  static constexpr int n(int i) {
    return i == 1 ? 2 * GC : i == 2 ? GC : i == 3 ? 2 * GC + NF : i == 4 ? GC + NF : NF;
  }
  static constexpr int kc(int i) {
    const int tiles = (side<T>(i) * side<T>(i) + 63) / 64, mf = tiles / 2, mh = tiles % 2;
    const int acc = mf * n(i) / 2 + mh * n(i) / 4;
    return cmin(PL::slot / (OS::SLICES * n(i) * 32), (kAccA - acc) / (OS::A * (mf + mh)));
  }
};

template <int T, int NF, int GC, int I, class PL = PackedLayout<T, NF, GC>, class R = Rects<T, NF, GC, PL>>
using Rect = Gemm<T, NF, GC, I, PL, R::j0(I), R::n(I), R::kc(I), false>;

// Rectangle I's epilogue on one m-tile (columns col0 ...): per 8-column
// group, the output it belongs to, with the bias or partial sum added after
// the product.
template <int T, typename TS, int NF, int GC, int I, class PL = PackedLayout<T, NF, GC>>
struct RectEpi {
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
            if (col < GC) put_c<T, NF, GC, 1, PL>(t, q, in, col, v0 + b0, v1 + b1);
            else if (q1 >= 0) f2(a2 + q1 * A24 + col - GC) = make_float2(v0 + b0, v1 + b1);
          } else if constexpr (I == 2) {  // c2 = lrelu(a2 + .)
            const float2 s = f2(a2 + q * A24 + col);
            put_c<T, NF, GC, 2, PL>(t, q, in, col, s.x + v0, s.y + v1);
          } else if constexpr (I == 3) {  // {c3, a4, a5}: b3, b4, b5 follow each other
            const float b0 = __ldg(bias + 2 * GC + col), b1 = __ldg(bias + 2 * GC + col + 1);
            if (col < GC) put_c<T, NF, GC, 3, PL>(t, q, in, col, v0 + b0, v1 + b1);
            else if (col < 2 * GC) {
              if (q1 >= 0) f2(a4 + q1 * A24 + col - GC) = make_float2(v0 + b0, v1 + b1);
            } else if (q2 >= 0) {
              f2(a5 + q2 * A5 + col - 2 * GC) = make_float2(v0 + b0, v1 + b1);
            }
          } else {  // {c4 = lrelu(a4 + .), a5 += .}
            if (col < GC) {
              const float2 s = f2(a4 + q * A24 + col);
              put_c<T, NF, GC, 4, PL>(t, q, in, col, s.x + v0, s.y + v1);
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

// Grid: (T x T patches of one tile, B). Base: K1's bf16 Layout (the window
// from the bf16 operand plane) or LayoutF32 (the float32 state's window).
template <int T, typename TS, int NF, int GC, class Base = Layout<T, NF, GC>>
__global__ void __launch_bounds__(kThreads, 1)
    packed_kernel(const __grid_constant__ CUtensorMap window, const Params p) {
  using PL = PackedLayout<T, NF, GC, Base>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  run_block<T, PL>(
      smem_raw, p.patches_x, p.H, p.W,
      [&](const Block& k) {
        produce<T, NF, typename Base::Operand>(
            &window, k, p.H, p.W, [&](size_t o, int n) { prefetch_state<TS, NF>(p, o, n); }, [&] {
          // each rectangle's k-step slices in chunks of its KC
          const char* src = reinterpret_cast<const char*>(p.w);
          int s = 0;
          ring_gemm<Rect<T, NF, GC, 1, PL>, PL>(src, k, s);
          ring_gemm<Rect<T, NF, GC, 2, PL>, PL>(src, k, s);
          ring_gemm<Rect<T, NF, GC, 3, PL>, PL>(src, k, s);
          ring_gemm<Rect<T, NF, GC, 4, PL>, PL>(src, k, s);
          ring_gemm<Rect<T, NF, GC, 5, PL>, PL>(src, k, s);
        });
      },
      [&](Consumer& c, const Patch& t, int wg) {
        const auto out = out_epi<T, TS, NF>(t, p);
        run_stage<Rect<T, NF, GC, 1, PL>>(c, nullptr, wg, RectEpi<T, TS, NF, GC, 1, PL>{t, p.bias, out});
        consumers_sync();
        run_stage<Rect<T, NF, GC, 2, PL>>(c, nullptr, wg, RectEpi<T, TS, NF, GC, 2, PL>{t, p.bias, out});
        consumers_sync();
        run_stage<Rect<T, NF, GC, 3, PL>>(c, nullptr, wg, RectEpi<T, TS, NF, GC, 3, PL>{t, p.bias, out});
        consumers_sync();
        run_stage<Rect<T, NF, GC, 4, PL>>(c, nullptr, wg, RectEpi<T, TS, NF, GC, 4, PL>{t, p.bias, out});
        consumers_sync();
        run_stage<Rect<T, NF, GC, 5, PL>>(c, nullptr, wg, RectEpi<T, TS, NF, GC, 5, PL>{t, p.bias, out});
      });
}

// K5 at patch side T on the planes of Base: the launch
template <int T, typename TS, int NF, int GC, class Base>
int launch_packed(const CUtensorMap& map, const Params& p, int B, cudaStream_t s) {
  constexpr int smem = PackedLayout<T, NF, GC, Base>::bytes;
  static_assert(smem <= kSmemBlock, "shared memory of one block");
  return launch_grid<T>(packed_kernel<T, TS, NF, GC, Base>, smem, map, p, B, s);
}

}  // namespace
