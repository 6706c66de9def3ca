// The wgmma machinery of the fused RDB kernels, shared by K1/K2
// (rdb_wgmma.cu with bf16 operands, rdb_tf32.cu with float32 operands) and
// the trunk modes' K3, K4 and K5 (rdb_modes.cuh, rdb_modes_wgmma.cu,
// rdb_modes_tf32.cu): the shared-memory
// layout of a T x T patch, the stage GEMM (register A by ldmatrix, B from a
// weight ring by descriptor), the epilogues of c1..c4 and of the output, the
// producer (TMA window, L2 prefetch, weight ring) and the host's cache of
// window tensor maps. rdb_wgmma.cu's header describes the design. The
// operand type is the layout's: Layout (bf16, the default everywhere) or
// LayoutF32 (float32 planes, 3xTF32 products; rdb_tf32.cu's header).

#pragma once

#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int kHalo = 5;                             // receptive field of five 3x3 convs
// The weight ring: two slots of 3 x 16 x nf bf16 weights (6 KB at nf = 64).
// A slot holds a chunk of kChunk x nf / N k16 slices of a stage with N
// outputs (6 for c1..c4, 3 for c5), which the consumers take with one wait,
// one fence and one commit.
constexpr int kChunk = 3;
constexpr int kSlots = 2;
constexpr float kResidual = 0.2f;
// registers a GEMM's accumulators and one chunk's A fragments may take per
// thread: more makes ptxas spill and serialize the wgmmas (C7512)
constexpr int kAccA = 192;
constexpr int kSmemBlock = 232448;  // shared memory one block may use
constexpr int kTf32Slot = 12288;    // the largest ring slot of LayoutF32

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <typename T>
__device__ __forceinline__ float round_to(float v) { return round_to(v, static_cast<T*>(nullptr)); }

__device__ __forceinline__ void load2(const float* p, float v[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float v[2]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void store2(float* p, const float v[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, const float v[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

// ---------------------------------------------------------------------------
// Shared memory: the x window, c1..c4, the weight ring, the barriers
// ---------------------------------------------------------------------------

// Side of region j of a T x T patch: 0 the x window, 1..4 c_j, 5 the output.
template <int T>
__host__ __device__ constexpr int side(int j) { return T + 2 * kHalo - 2 * j; }

template <int T, int NF, int GC>
struct Layout {
  using Operand = __nv_bfloat16;
  // byte offset of plane j (0 = the window, 1..4 = c_j); the window first,
  // at a 1024-byte boundary (TMA's swizzle repeats every 1024 bytes)
  __host__ __device__ static constexpr int plane(int j) {
    return j == 0 ? 0 : plane(j - 1) + 2 * (j == 1 ? NF : GC) * side<T>(j - 1) * side<T>(j - 1);
  }
  static constexpr int slot = NF * 32 * kChunk;  // bytes of a ring slot
  static constexpr int ring = plane(5);
  static constexpr int bars = ring + kSlots * slot;
  // + the runtime alignment of the base to 1024 bytes
  static constexpr int bytes = bars + 8 * (2 * kSlots + 1) + 1024;
  // k16 steps of K1's stage r a chunk holds: a ring slot
  static constexpr int kc(int r) { return kChunk * NF / (r < 5 ? GC : NF); }
  // byte offset of (pixel, 16-byte chunk) in the window and in a c_j plane
  static __device__ __forceinline__ uint32_t window_offset(int pix, int chunk) {
    return chunk_offset<NF>(pix, chunk);
  }
  static __device__ __forceinline__ uint32_t c_offset(int pix, int chunk) { return chunk_offset<GC>(pix, chunk); }
};

// float32 operands (rdb_tf32.cu): the window and c1..c4 in f32, twice K1's
// bytes, the window of nf = 64 as two 32-channel sub-planes (one TMA box
// each, at 1024-byte boundaries); then a ring of two slots as large as the
// rest allows (at most kTf32Slot), in whole k-steps of c5 (its tf32 hi and
// lo k8 slices). Each stage's chunk length follows the tail's Plan::KC:
// whole steps in a slot, accumulators + A (hi and lo) within kAccA.
template <int T, int NF, int GC>
struct LayoutF32 {
  using Operand = float;
  static constexpr int S0 = side<T>(0);
  static constexpr int window = NF <= 32 ? 4 * NF * S0 * S0 : NF / 32 * sub_plane_bytes(S0 * S0);
  __host__ __device__ static constexpr int plane(int j) {
    return j == 0 ? 0 : j == 1 ? window : plane(j - 1) + 4 * GC * side<T>(j - 1) * side<T>(j - 1);
  }
  static constexpr int ring = plane(5);
  static constexpr int step5 = 2 * NF * 32;  // bytes of one k-step of c5's weights
  static constexpr int slot =
      cmax(step5, cmin(kTf32Slot, (kSmemBlock - 1024 - 8 * (2 * kSlots + 1) - ring) / kSlots / step5 * step5));
  static constexpr int bars = ring + kSlots * slot;
  static constexpr int bytes = bars + 8 * (2 * kSlots + 1) + 1024;
  static constexpr int kc(int r) {
    const int n = r < 5 ? GC : NF, tiles = (side<T>(r) * side<T>(r) + 63) / 64, mf = tiles / 2, mh = tiles % 2;
    return cmax(1, cmin(slot / (2 * n * 32), (kAccA - mf * n / 2 - mh * n / 4) / (8 * (mf + mh))));
  }
  static __device__ __forceinline__ uint32_t window_offset(int pix, int chunk) {
    return chunk_offset_f32<NF, S0 * S0>(pix, chunk);
  }
  static __device__ __forceinline__ uint32_t c_offset(int pix, int chunk) {
    return chunk_offset_f32<GC, 0>(pix, chunk);
  }
};

// ---------------------------------------------------------------------------
// The consumers: stage GEMMs and epilogues
// ---------------------------------------------------------------------------

// What a launch of K1 (either operand type) or K5 reads and writes.
struct Params {
  const void* x;                 // the state [B, H, W, NF] (f32 or bf16), read at the centre
  const void* u;                 // the RRDB entry state, or nullptr (no residual)
  void* out;                     // the new state
  __nv_bfloat16* shadow;         // bf16(out) for the next RDB's window, or nullptr
  const void* w;                 // the stages' k-step slices in wgmma order (bf16, or tf32 hi/lo)
  const float* bias;             // [4 GC + NF]: b1..b5
  int H, W, patches_x;
};

// k16 steps of stage r: 9 taps x (NF + (r - 1) GC) / 16
template <int NF, int GC>
__host__ __device__ constexpr int stage_steps(int r) { return 9 * (NF + (r - 1) * GC) / 16; }

// Everything a consumer thread carries from stage to stage.
struct Consumer {
  uint32_t smem;   // the aligned base of the planes
  uint32_t full;   // the ring's "landed" barriers (8 bytes each)
  uint32_t empty;  // the ring's "free" barriers
  int s;           // the next ring step
  int warp, lane;  // warp in the warpgroup, lane
};

// The GEMM over region R for one warpgroup: N columns, K over the sources
// J0 .. R - 1 (0 the window, j c_j) in (source, tap, channel block) k-steps
// (OperandSteps of L's operand type), whose weight slices come from the
// ring of layout L in chunks of KC steps; the accumulators start from the
// bias (BIAS) or from zero. K1's stage R on bf16 is the default: all
// sources, N = gc (c1..c4) or nf (c5); Stage below on any layout.
//
// The region's 64-pixel m-tiles alternate between the two warpgroups (tiles
// wg, wg + 2, ...: MF each); where their number is odd, both take the last
// one, each with half of the N columns, so that both run this one code path
// with the same counts and no product is wasted (ptxas serializes the wgmma
// pipeline of two paths with different counts, and of a product skipped on
// a runtime condition).
template <int T, int NF, int GC, int R, class L = Layout<T, NF, GC>, int J0 = 0, int N_ = (R < 5 ? GC : NF),
          int KC_ = kChunk * NF / N_, bool BIAS = true>
struct Gemm {
  using OS = OperandSteps<typename L::Operand>;
  static constexpr int S = side<T>(R), P = S * S;
  static constexpr int N = N_, NR = N / 2;
  static constexpr int TILES = (P + 63) / 64;
  static constexpr int MF = TILES / 2;  // whole tiles of each warpgroup
  static constexpr int MH = TILES % 2;  // the shared half tile
  static constexpr int MA = MF + MH;    // A fragments per k-step

  Consumer& c;
  const int wg;
  float acc[MF > 0 ? MF : 1][NR];
  float half[NR / 2];  // the shared tile, columns wg * N / 2 ...
  int ry[MA], rx[MA];  // the pixel whose row this lane addresses for ldmatrix
  int src = J0, tap = 0, kb = 0;  // the next step's source, tap and 16-channel block

  __device__ __forceinline__ Gemm(Consumer& c_, const float* __restrict__ bias, int wg_) : c(c_), wg(wg_) {
    const int tig = c.lane % 4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      float b0 = 0.f, b1 = 0.f;
      if constexpr (BIAS) {
        b0 = bias[j * 8 + tig * 2];
        b1 = bias[j * 8 + tig * 2 + 1];
      }
#pragma unroll
      for (int m = 0; m < MF; ++m) {
        acc[m][4 * j] = b0; acc[m][4 * j + 1] = b1; acc[m][4 * j + 2] = b0; acc[m][4 * j + 3] = b1;
      }
    }
    if constexpr (MH > 0) {
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        float b0 = 0.f, b1 = 0.f;
        if constexpr (BIAS) {
          b0 = bias[wg * (N / 2) + j * 8 + tig * 2];
          b1 = bias[wg * (N / 2) + j * 8 + tig * 2 + 1];
        }
        half[4 * j] = b0; half[4 * j + 1] = b1; half[4 * j + 2] = b0; half[4 * j + 3] = b1;
      }
    }
    // rows past the region repeat its last pixel
#pragma unroll
    for (int m = 0; m < MA; ++m) {
      const int tile = m < MF ? wg + 2 * m : TILES - 1;
      const int q = min(tile * 64 + c.warp * 16 + (c.lane & 15), P - 1);
      ry[m] = q / S;
      rx[m] = q % S;
    }
    fence_all();
  }

  __device__ __forceinline__ void fence_all() {
#pragma unroll
    for (int m = 0; m < MF; ++m) fence_regs(acc[m]);
    if constexpr (MH > 0) fence_regs(half);
  }

  static constexpr int KC = KC_;  // k16 steps of a full chunk
  static constexpr int STEPS = 9 * ((J0 == 0 ? NF : 0) + (R - (J0 == 0 ? 1 : J0)) * GC) / OS::K;
  uint32_t a[KC][MA][OS::A];

  // A of m-tile m of step k from shared memory: bf16 as ldmatrix gives it;
  // float32 split into tf32 hi (a[k][m][0..3]) and lo (a[k][m][4..7])
  __device__ __forceinline__ void load(int k, int m, uint32_t addr) {
    if constexpr (OS::A == 4) {
      ldmatrix_x4(addr, a[k][m]);
    } else {
      uint32_t v[4];
      ldmatrix_x4(addr, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], a[k][m][i], a[k][m][4 + i]);
    }
  }

  // A of the next k-step into a[k]
  __device__ __forceinline__ void gather(int k) {
    const int off = R - 1 - src, dy = tap / 3 + off, dx = tap % 3 + off;
    const int chunk = 2 * kb + (c.lane >> 4);
    if (src == 0) {
      constexpr int S0 = side<T>(0);
#pragma unroll
      for (int m = 0; m < MA; ++m) load(k, m, c.smem + L::window_offset((ry[m] + dy) * S0 + rx[m] + dx, chunk));
    } else {
      const int Sj = T + 2 * kHalo - 2 * src;
      const uint32_t plane = c.smem + (src == 1   ? L::plane(1)
                                       : src == 2 ? L::plane(2)
                                       : src == 3 ? L::plane(3)
                                                  : L::plane(4));
#pragma unroll
      for (int m = 0; m < MA; ++m) load(k, m, plane + L::c_offset((ry[m] + dy) * Sj + rx[m] + dx, chunk));
    }
    if (++kb == (src == 0 ? NF : GC) / OS::K) {
      kb = 0;
      if (++tap == 9) { tap = 0; ++src; }
    }
  }

  // A chunk of K k-steps: wait for its weights, gather all its A, issue
  // its products behind one fence in this warpgroup's turn, and free its slot
  // once they are done. A slice is N x 32 bytes, 8-column groups are 256
  // bytes apart, 16 bytes per descriptor unit. float32: the split product
  // A_lo B_hi + A_hi B_lo + A_hi B_hi, small terms first, from the step's
  // hi slice and the lo slice after it.
  template <int K>
  __device__ __forceinline__ void chunk() {
    const int slot = c.s % kSlots;
    mbar_wait(c.full + 8 * slot, (c.s / kSlots) & 1);
#pragma unroll
    for (int k = 0; k < K; ++k) gather(k);
    wg_fence();
    const uint64_t desc = b_desc(c.smem + L::ring + slot * L::slot);
    turn_wait(wg);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if constexpr (OS::SLICES == 1) {
#pragma unroll
        for (int m = 0; m < MF; ++m) Wgmma<N>::run(acc[m], a[k][m], desc + k * 2 * N);
        if constexpr (MH > 0) Wgmma<N / 2>::run(half, a[k][MF], desc + k * 2 * N + wg * N);
      } else {
        const uint64_t hi = desc + k * 4 * N, lo = hi + 2 * N;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const int ia = p == 0 ? 4 : 0;
          const uint64_t b = p == 1 ? lo : hi;
#pragma unroll
          for (int m = 0; m < MF; ++m) WgmmaTf32<N>::run(acc[m], &a[k][m][ia], b);
          if constexpr (MH > 0) WgmmaTf32<N / 2>::run(half, &a[k][MF][ia], b + wg * N);
        }
      }
    }
    wg_commit();
    turn_pass(wg);
    wg_wait<0>();
    if (c.lane == 0) mbar_arrive(c.empty + 8 * slot);
    ++c.s;
  }

  __device__ __forceinline__ void run() {
#pragma unroll 1
    for (int i = 0; i < STEPS / KC; ++i) chunk<KC>();
    if constexpr (STEPS % KC > 0) chunk<STEPS % KC>();
    fence_all();
  }
};

// K1's stage R on layout L: all sources, N = gc (c1..c4) or nf (c5), L's
// chunk length (Gemm's defaults for the bf16 Layout)
template <int T, int NF, int GC, int R, class L = Layout<T, NF, GC>>
using Stage = Gemm<T, NF, GC, R, L, 0, (R < 5 ? GC : NF), L::kc(R)>;

// GEMM G, then epi(tile, accumulators, first column) on each of this
// warpgroup's tiles.
template <class G, typename Epi>
__device__ __forceinline__ void run_stage(Consumer& c, const float* __restrict__ bias, int wg, const Epi& epi) {
  G g(c, bias, wg);
  g.run();
#pragma unroll
  for (int m = 0; m < G::MF; ++m) epi(wg + 2 * m, g.acc[m], 0);
  if constexpr (G::MH > 0) epi(G::TILES - 1, g.half, wg * (G::N / 2));
}

// Where a block's patch lies, and its lane's place in the accumulators.
struct Patch {
  unsigned char* base;  // the planes, generic address
  int b, py0, px0, H, W;
  int warp, gid, tig;
};

// c_I's two values at (pixel q of region I, column col) lrelu'd into plane
// I of layout L, in its operand type; zero outside the image (every conv's
// zero padding)
template <int T, int NF, int GC, int I, class L = Layout<T, NF, GC>>
__device__ __forceinline__ void put_c(const Patch& t, int q, bool in, int col, float v0, float v1) {
  if constexpr (sizeof(typename L::Operand) == 2) {
    *reinterpret_cast<uint32_t*>(t.base + L::plane(I) + L::c_offset(q, col >> 3) + (col & 7) * 2) =
        in ? pack_bf16x2(lrelu(v0), lrelu(v1)) : 0u;
  } else {
    *reinterpret_cast<float2*>(t.base + L::plane(I) + L::c_offset(q, col >> 2) + (col & 3) * 4) =
        in ? make_float2(lrelu(v0), lrelu(v1)) : make_float2(0.f, 0.f);
  }
}

// whether pixel q of region I (side S) lies in the image
template <int T, int I>
__device__ __forceinline__ bool inside(const Patch& t, int q) {
  constexpr int S = side<T>(I);
  const int ty = t.py0 - kHalo + I + q / S, tx = t.px0 - kHalo + I + q % S;
  return ty >= 0 && ty < t.H && tx >= 0 && tx < t.W;
}

// c_I over region I from the accumulators of one m-tile (columns col0 ...)
template <int T, int NF, int GC, int I, class L = Layout<T, NF, GC>>
struct CEpi {
  const Patch& t;
  template <int NR>
  __device__ __forceinline__ void operator()(int tile, const float (&acc)[NR], int col0) const {
    constexpr int S = side<T>(I);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tile * 64 + t.warp * 16 + t.gid + 8 * h;
      if (q >= S * S) continue;
      const bool in = inside<T, I>(t, q);
#pragma unroll
      for (int j = 0; j < NR / 4; ++j)
        put_c<T, NF, GC, I, L>(t, q, in, col0 + 8 * j + t.tig * 2, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
};

// The output from c5: 0.2 c5 + x, the RRDB residual 0.2 y + u, and the bf16
// shadow of the output. Every load of a pixel comes before its stores.
template <int T, typename TS, int NF>
struct OutEpi {
  const Patch& t;
  const TS* __restrict__ x;
  const TS* __restrict__ u;
  TS* __restrict__ out;
  __nv_bfloat16* __restrict__ shadow;
  template <int NR>
  __device__ __forceinline__ void operator()(int tile, const float (&acc)[NR], int col0) const {
    constexpr int G = NR / 4;  // 8-column groups
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tile * 64 + t.warp * 16 + t.gid + 8 * h;
      if (q >= T * T) continue;
      const int ty = t.py0 + q / T, tx = t.px0 + q % T;
      if (ty >= t.H || tx >= t.W) continue;
      const size_t o = ((size_t(t.b) * t.H + ty) * t.W + tx) * NF + col0 + t.tig * 2;
      float xv[G][2], uv[G][2];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        load2(x + o + j * 8, xv[j]);
        if (u != nullptr) load2(u + o + j * 8, uv[j]);
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          y[e] = round_to<TS>(kResidual * acc[4 * j + 2 * h + e] + xv[j][e]);
          if (u != nullptr) y[e] = round_to<TS>(kResidual * y[e] + uv[j][e]);
        }
        store2(out + o + j * 8, y);
        if (shadow != nullptr) store2(shadow + o + j * 8, y);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// The block and its producer
// ---------------------------------------------------------------------------

// A block's shared memory (aligned to 1024 bytes) with its barriers, and
// where its T x T patch lies. Grid: (patches of one tile, B).
struct Block {
  uint32_t smem, full, empty, win_bar;  // shared addresses: the base, the ring's and the window's barriers
  unsigned char* base;                  // the base, generic address
  int b, py0, px0;
};

// One block of layout L: the barriers initialised, then the roles.
// produce(k) runs on one producer thread, once setmaxnreg gave the other
// producer threads' registers to the consumers; consume(c, t, wg) on every
// consumer thread once the window landed, warpgroup 0 taking the first turn.
template <int T, class L, class Produce, class Consume>
__device__ __forceinline__ void run_block(unsigned char* smem_raw, int patches_x, int H, int W,
                                          const Produce& produce, const Consume& consume) {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t smem = (raw + 1023u) & ~1023u;
  const uint32_t full = smem + L::bars, empty = full + 8 * kSlots;
  const Block k{smem, full, empty, empty + 8 * kSlots, smem_raw + (smem - raw), int(blockIdx.y),
                int(blockIdx.x / patches_x) * T, int(blockIdx.x % patches_x) * T};
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers * 4);  // lane 0 of each consumer warp
    }
    mbar_init(k.win_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    setmaxnreg_producer();
    if (threadIdx.x == kConsumers * 128) produce(k);
    return;
  }
  setmaxnreg_consumer();
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  Consumer c{k.smem, k.full, k.empty, 0, warp, lane};
  const Patch t{k.base, k.b, k.py0, k.px0, H, W, warp, lane / 4, lane % 4};
  mbar_wait(k.win_bar, 0);
  if (wg == 1) turn_pass(wg);
  consume(c, t, wg);
}

// K1's five stages (also K3's and K4's) on layout L: c1..c4 into their
// planes, the output through `out`.
template <int T, int NF, int GC, class L = Layout<T, NF, GC>, class Out>
__device__ __forceinline__ void scatter_stages(Consumer& c, const Patch& t, int wg, const float* __restrict__ bias,
                                               const Out& out) {
  run_stage<Stage<T, NF, GC, 1, L>>(c, bias, wg, CEpi<T, NF, GC, 1, L>{t});
  consumers_sync();
  run_stage<Stage<T, NF, GC, 2, L>>(c, bias + GC, wg, CEpi<T, NF, GC, 2, L>{t});
  consumers_sync();
  run_stage<Stage<T, NF, GC, 3, L>>(c, bias + 2 * GC, wg, CEpi<T, NF, GC, 3, L>{t});
  consumers_sync();
  run_stage<Stage<T, NF, GC, 4, L>>(c, bias + 3 * GC, wg, CEpi<T, NF, GC, 4, L>{t});
  consumers_sync();
  run_stage<Stage<T, NF, GC, 5, L>>(c, bias + 4 * GC, wg, out);
}

// The L2 prefetch of the epilogue's rows of the state and of u (K1, K5).
template <typename TS, int NF>
__device__ __forceinline__ void prefetch_state(const Params& p, size_t o, int n) {
  prefetch_l2(static_cast<const TS*>(p.x) + o, n * NF * int(sizeof(TS)));
  if (p.u != nullptr) prefetch_l2(static_cast<const TS*>(p.u) + o, n * NF * int(sizeof(TS)));
}

// The output epilogue of K1 and K5 on the state type TS.
template <int T, typename TS, int NF>
__device__ __forceinline__ OutEpi<T, TS, NF> out_epi(const Patch& t, const Params& p) {
  return {t, static_cast<const TS*>(p.x), static_cast<const TS*>(p.u), static_cast<TS*>(p.out), p.shadow};
}

// The window: (T + 10)^2 pixels of image k.b of the operand plane from
// (x0, y0) on, as one TMA box [1, T + 10, T + 10, NF] of bf16 or, for
// float32 operands, one box per 32-channel sub-plane; zero outside the
// tensor.
template <int T, int NF, typename OP = __nv_bfloat16>
__device__ __forceinline__ void load_window(const CUtensorMap* window, const Block& k, int x0, int y0) {
  constexpr int S0 = side<T>(0);
  mbar_expect_tx(k.win_bar, S0 * S0 * NF * int(sizeof(OP)));
  if constexpr (sizeof(OP) == 2 || NF <= 32) {
    tma_load_4d(k.smem, window, k.win_bar, 0, x0, y0, k.b);
  } else {
#pragma unroll
    for (int h = 0; h < NF / 32; ++h)
      tma_load_4d(k.smem + h * sub_plane_bytes(S0 * S0), window, k.win_bar, 32 * h, x0, y0, k.b);
  }
}

// The producer thread: the window as TMA boxes of the operand plane,
// rows(o, n) for each of the epilogue's rows (n pixels from element o of a
// [B, H, W, NF] tensor: the L2 prefetches), then ring(): the weights.
template <int T, int NF, typename OP = __nv_bfloat16, class Rows, class Ring>
__device__ __forceinline__ void produce(const CUtensorMap* window, const Block& k, int H, int W, const Rows& rows,
                                        const Ring& ring) {
  load_window<T, NF, OP>(window, k, k.px0 - kHalo, k.py0 - kHalo);
  const int n = min(T, W - k.px0);
  for (int y = 0; y < min(T, H - k.py0); ++y) rows(((size_t(k.b) * H + k.py0 + y) * W + k.px0) * NF, n);
  ring();
}

// K1's weights (the five convs' k16 slices, stage by stage) through the ring.
template <int T, int NF, int GC>
__device__ __forceinline__ void ring_scatter(const void* w, const Block& k) {
  using L = Layout<T, NF, GC>;
  const char* src = reinterpret_cast<const char*>(w);
  int s = 0;
#pragma unroll 1
  for (int r = 1; r <= 5; ++r) {
    const int stage_bytes = stage_steps<NF, GC>(r) * (r < 5 ? GC : NF) * 32;
#pragma unroll 1
    for (int done = 0; done < stage_bytes; done += L::slot, ++s) {
      const int slot = s % kSlots, bytes = min(L::slot, stage_bytes - done);
      if (s >= kSlots) mbar_wait(k.empty + 8 * slot, ((s / kSlots) - 1) & 1);
      mbar_expect_tx(k.full + 8 * slot, bytes);
      bulk_copy(k.smem + L::ring + slot * L::slot, src + done, bytes, k.full + 8 * slot);
    }
    src += stage_bytes;
  }
}

// The weights of the GEMM G on layout L: its k-steps (OperandSteps::SLICES
// slices of N x 32 bytes each) in chunks of G::KC steps, through the ring.
template <class G, class L>
__device__ __forceinline__ void ring_gemm(const char*& src, const Block& k, int& s) {
  constexpr int step = G::N * 32 * G::OS::SLICES;
#pragma unroll 1
  for (int done = 0; done < G::STEPS; done += G::KC, ++s) {
    const int slot = s % kSlots, bytes = cmin(G::KC, G::STEPS - done) * step;
    if (s >= kSlots) mbar_wait(k.empty + 8 * slot, ((s / kSlots) - 1) & 1);
    mbar_expect_tx(k.full + 8 * slot, bytes);
    bulk_copy(k.smem + L::ring + slot * L::slot, src + done * step, bytes, k.full + 8 * slot);
  }
  src += G::STEPS * step;
}

// K1's five stages' weights on layout L, each in its Stage's chunks.
template <int T, int NF, int GC, class L>
__device__ __forceinline__ void ring_stages(const void* w, const Block& k) {
  const char* src = static_cast<const char*>(w);
  int s = 0;
  ring_gemm<Stage<T, NF, GC, 1, L>, L>(src, k, s);
  ring_gemm<Stage<T, NF, GC, 2, L>, L>(src, k, s);
  ring_gemm<Stage<T, NF, GC, 3, L>, L>(src, k, s);
  ring_gemm<Stage<T, NF, GC, 4, L>, L>(src, k, s);
  ring_gemm<Stage<T, NF, GC, 5, L>, L>(src, k, s);
}

// ---------------------------------------------------------------------------
// Host side: the window's tensor map, cached
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// The tensor maps of the last few operand planes: 69 launches of a trunk
// reuse a few addresses (the allocator's), so each is encoded once.
struct MapEntry {
  const void* ptr;
  int B, H, W, nf, tile, elem;
  CUtensorMap map;
};
constexpr int kMapCache = 16;
MapEntry g_maps[kMapCache];
int g_maps_next = 0;
std::mutex g_maps_lock;

// The window map of a [B, H, W, nf] plane of `elem`-byte values (2: bf16,
// 4: float32): boxes of [1, T+10, T+10, nf] (float32: of 32 channels, one
// per sub-plane) in the planes' swizzle, zero outside the tensor. Returns a
// cudaError_t.
int window_map(const void* xs, int B, int H, int W, int nf, int tile, CUtensorMap* map, int elem = 2) {
  std::lock_guard<std::mutex> guard(g_maps_lock);
  for (const MapEntry& e : g_maps) {
    if (e.ptr == xs && e.B == B && e.H == H && e.W == W && e.nf == nf && e.tile == tile && e.elem == elem) {
      *map = e.map;
      return 0;
    }
  }
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  const int S0 = tile + 2 * kHalo, inner = cmin(nf, 128 / elem);
  const cuuint64_t dims[4] = {cuuint64_t(nf), cuuint64_t(W), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(nf) * elem, cuuint64_t(W) * nf * elem, cuuint64_t(H) * W * nf * elem};
  const cuuint32_t box[4] = {cuuint32_t(inner), cuuint32_t(S0), cuuint32_t(S0), 1};
  const cuuint32_t estrides[4] = {1, 1, 1, 1};
  MapEntry& e = g_maps[g_maps_next];
  const CUresult r =
      encode(&e.map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
             const_cast<void*>(xs), dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             inner * elem == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    e.ptr = nullptr;
    return int(cudaErrorInvalidValue);
  }
  e.ptr = xs; e.B = B; e.H = H; e.W = W; e.nf = nf; e.tile = tile; e.elem = elem;
  *map = e.map;
  g_maps_next = (g_maps_next + 1) % kMapCache;
  return 0;
}

// Launch kernel(map, p) on the (patches of one tile, B) grid of T x T
// patches with `smem` bytes of dynamic shared memory (p: H, W, patches_x).
// Returns a cudaError_t.
template <int T, typename Kernel, class P>
int launch_grid(Kernel kernel, int smem, const CUtensorMap& map, P p, int B, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  p.patches_x = (p.W + T - 1) / T;
  kernel<<<dim3(p.patches_x * ((p.H + T - 1) / T), B), kThreads, smem, stream>>>(map, p);
  return int(cudaGetLastError());
}

}  // namespace
