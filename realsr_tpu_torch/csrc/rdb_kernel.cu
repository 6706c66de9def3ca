// Fused residual dense block (RDB) for Hopper (sm_90a): the mma.sync forms.
//
// Replaces, in realsr_tpu/ops/rdb_kernel.py:
//   K1 _rdb_kernel and K2 _rdb_resident_kernel for float32 operands only
//      (fp32::rdb_kernel below; bf16 operands run on csrc/rdb_wgmma.cu);
//   K3 _rdb_kernel(chained=True) (rdb_apply_chained): form kChained;
//   K4 _rdb_kernel(paired=True) (rdb_apply_paired): form kPaired;
//   K5 the sched="packed" branch of _make_rdb_compute: form kPacked.
//
// Per tile, with every conv zero-padded at the tile border:
//   c_i = lrelu_0.2(conv3x3(concat(x, c_1..c_{i-1})) + b_i)   i = 1..4
//   c5  = conv3x3(concat(x, c1..c4)) + b5
//   y   = state(0.2 * c5 + x)
//   out = u ? state(0.2 * y + u) : y
// Conv operands (x, c1..c4, weights) are rounded to the operand type; sums
// are f32. state() rounds to the state type.
//
// Bound: compute. An RDB is 239,616 MACs per pixel at nf = 64, gc = 32
// against 512 bytes of f32 state read and written, ~470 MAC per byte. The
// design keeps c1..c4 out of device memory, as the TPU kernel keeps them out
// of HBM: one block owns a T x T output patch, loads its x window with the
// 5-pixel halo of five chained 3x3 convs into shared memory, and computes c_i
// over the shrinking region (T + 2(5 - i))^2 there. The price is halo
// recompute: sum_i MAC_i (T + 10 - 2i)^2 / (MAC_rdb T^2) = 1.34x the RDB's
// MACs at T = 16 and 1.58x at T = 10.
//
// Two kernels, chosen by the operand type:
// - bf16 operands (mixed and bfloat16 modes), K3-K5: tensor cores, template
//   tc::rdb_kernel<Form, state type, nf, gc>. Shared memory holds bf16
//   planes, pixel-major with the channels of a pixel contiguous and their
//   16-byte chunks XOR-swizzled by pixel, so ldmatrix reads the A tile (16
//   pixels x 16 channels of one tap) without bank conflicts; T = 16 fits
//   (196 KB at nf = 64, gc = 32). Each stage is one GEMM "rectangle" over a
//   region: each of the 8 warps takes one item, a run of m-tiles (16 pixels
//   each) times all the rectangle's outputs, with mma.sync m16n8k16 and f32
//   accumulators. The B fragments come from the weights, packed at load
//   time in fragment order (ops/rdb_kernel.py::_perm), through L2/L1,
//   and each serves all m-tiles of the item. Measured per RDB at 8 x 148^2
//   (H100 SXM): 2 m-tiles per item 0.715 ms, 4 (2 in stage 5) 0.601 ms,
//   one item per warp 0.554 ms.
//   The forms:
//   * kChained: K1's arithmetic (the five convs in turn) on the persistent layout
//     [B, Hp + 10, Wp + 10, nf] (Hp, Wp: H, W rounded up to T; the image at
//     row and column 5). The aprons are zeroed once when the trunk allocates
//     its three buffers, and the kernel writes centre pixels only, so they
//     stay zero and the window load has no bounds test; c1..c4 are still
//     masked to zero outside the image. The residual folds where the device
//     flag *flag == 1.
//   * kPaired: the state as two bf16 planes, x = hi + lo. The window is hi,
//     copied as bf16 (no f32 pass); lo is read at the centre only. Epilogue:
//     center = (0.2 c5 + hi) + lo, hi' = bf16(center), lo' = bf16(center -
//     hi'); with the residual, the f32 sum 0.2 (hi' + lo') + (u_hi + u_lo) is
//     split again. Per block the window read is 26^2 x 64 x 2 + 16^2 x 64 x 2
//     bytes instead of 26^2 x 64 x 4.
//   * kPacked: the JAX package's five rectangles, A {x} -> {c1, a2},
//     B {c1} -> {c2}, C {x, c1, c2} -> {c3, a4, a5} (N = 2gc + nf = 128,
//     K = 9 (nf + 2gc) = 1152: one product, K order x ++ c1 ++ c2),
//     D {c3} -> {c4, a5}, E {c4} -> {c5}, with f32 partial sums a2, a4, a5
//     in shared memory. Each rectangle runs over its first output's region
//     (C over c3's: 16^2 pixels at T = 12), which costs 1.84x the RDB's MACs.
//     a2 (c2's region) shares its bytes with a4 + a5, born after a2 dies; T
//     = 12 makes planes + partials fit: 137,216 + 67,392 = 204,608 B at nf
//     = 64, gc = 32 (each partial pixel row padded by 4 floats).
// - f32 operands (float32 mode): CUDA cores, K1's arithmetic only.
//   Shared memory holds f32 planes (one per channel), which caps T at 10
//   (216 KB). A thread item is a 2 x 2 pixel block times 8 output channels:
//   per input channel it reads the 4 x 4 input patch once and the 9 x 8
//   weights, then does 288 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHalo = 5;  // receptive field of five 3x3 convs
constexpr int kThreads = 256;
constexpr float kSlope = 0.2f;
constexpr float kResidual = 0.2f;

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : v * kSlope; }

__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// v rounded to T's precision, as f32
template <typename T>
__device__ __forceinline__ float round_to(float v) { return round_to(v, static_cast<T*>(nullptr)); }

// Eight consecutive values (16-byte aligned) to f32.
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t h[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(h[k] << 16);
    v[2 * k + 1] = __uint_as_float(h[k] & 0xffff0000u);
  }
}

// Two consecutive values (aligned) to f32, and back (already rounded).
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// ---------------------------------------------------------------------------
// bf16 operands: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarps = kThreads / 32;
constexpr int kPadF = 4;  // floats of padding per pixel of the packed partial sums (banks)

// The three forms of the kernel, one template:
enum Form {
  kChained,  // K3: the five convs in turn on the zero-aproned layout, residual where *flag == 1
  kPaired,   // K4: the same with the state as bf16 hi + lo planes
  kPacked,   // K5: the five rectangles of the K-packed schedule
};

// Output patch side: 16, or 12 where the packed schedule's f32 partial sums
// must fit beside the planes.
template <int F>
__host__ __device__ constexpr int tile() { return F == kPacked ? 12 : 16; }

// Side of region j of a T x T patch: 0 the x window, 1..4 c_j, 5 the output.
template <int T>
__host__ __device__ constexpr int side(int j) { return T + 2 * kHalo - 2 * j; }

// Byte offset of plane j (0 = x window, 1..4 = c_j) in shared memory.
template <int T, int NF, int GC>
__host__ __device__ constexpr int plane_offset(int j) {
  return j == 0 ? 0
                : plane_offset<T, NF, GC>(j - 1) +
                      2 * (j == 1 ? NF : GC) * side<T>(j - 1) * side<T>(j - 1);
}

// The packed schedule's f32 partial sums, after the planes: a2 (c2's region)
// lives through rectangles A and B; a4 (c4's) and a5 (the output's) through C
// to E, in the same bytes.
template <int T, int NF, int GC>
constexpr int partial_bytes() {
  constexpr int a2 = 4 * side<T>(2) * side<T>(2) * (GC + kPadF);
  constexpr int a45 = 4 * (side<T>(4) * side<T>(4) * (GC + kPadF) +
                           side<T>(5) * side<T>(5) * (NF + kPadF));
  return a2 > a45 ? a2 : a45;
}

template <int F, int NF, int GC>
constexpr size_t smem_bytes() {
  constexpr int T = tile<F>();
  return size_t(plane_offset<T, NF, GC>(5)) + (F == kPacked ? partial_bytes<T, NF, GC>() : 0);
}

// Rectangle r (1..5) of the weights: K rows (sources x taps x channels) by N
// outputs. Chained, paired: conv r over {x, c1..c_{r-1}}. Packed: A {x} -> {c1, a2},
// B {c1} -> {c2}, C {x, c1, c2} -> {c3, a4, a5}, D {c3} -> {c4, a5},
// E {c4} -> {c5}.
template <int F, int NF, int GC>
__host__ __device__ constexpr int rect_k(int r) {
  return F == kPacked ? 9 * (r == 1 ? NF : r == 3 ? NF + 2 * GC : GC) : 9 * (NF + (r - 1) * GC);
}
template <int F, int NF, int GC>
__host__ __device__ constexpr int rect_n(int r) {
  return F == kPacked ? (r == 1 ? 2 * GC : r == 2 ? GC : r == 3 ? 2 * GC + NF : r == 4 ? GC + NF : NF)
                      : (r < 5 ? GC : NF);
}
// Element offset of rectangle r's packed weights: the rectangles back to back.
template <int F, int NF, int GC>
__host__ __device__ constexpr int weight_offset(int r) {
  return r == 1 ? 0
                : weight_offset<F, NF, GC>(r - 1) +
                      rect_k<F, NF, GC>(r - 1) * rect_n<F, NF, GC>(r - 1);
}

// Byte offset of (pixel, 16-byte channel chunk) in a plane of C channels:
// the chunk index is XORed with bits of the pixel index so that the 8 rows
// of an ldmatrix phase (8 consecutive pixels, one chunk) hit 8 distinct
// 16-byte bank groups.
template <int C>
__device__ __forceinline__ uint32_t chunk_offset(int pix, int chunk) {
  constexpr int chunks = C / 8;
  constexpr int lanes = chunks < 8 ? chunks : 8;
  constexpr int group = 8 / lanes;
  return uint32_t(pix) * (C * 2) + (uint32_t(chunk ^ ((pix / group) & (lanes - 1))) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Accumulate one source (C channels, region side Sj at window offset j) into
// the warp item's accumulators: 9 taps x C/16 k-steps, starting at k-step ks.
template <int MT, int C, int NB>
__device__ __forceinline__ void accumulate(float (&acc)[MT][NB][4], uint32_t plane, int Sj,
                                           int off, const int (&ry)[MT], const int (&rx)[MT],
                                           const uint2* __restrict__ wfrag, int& ks, int lane) {
#pragma unroll 1
  for (int t = 0; t < 9; ++t) {
    int sp[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) sp[m] = (ry[m] + off + t / 3) * Sj + rx[m] + off + t % 3;
#pragma unroll
    for (int kb = 0; kb < C / 16; ++kb, ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldmatrix_x4(plane + chunk_offset<C>(sp[m], 2 * kb + (lane >> 4)), a[m]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const uint2 b = __ldg(wfrag + (size_t(ks) * NB + nb) * 32 + lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(acc[m][nb], a[m], b.x, b.y);
      }
    }
  }
}

// One rectangle over region I: sources J0..J1-1 (0 = the x window, j = c_j)
// into N outputs. The region's m-tiles (16 pixels each) split into at most
// one item per warp, so each weight fragment serves MT m-tiles and no warp
// waits through a second round. init(c) seeds output column c's
// accumulators; epi(q, qy, qx, a, h) takes pixel q's sums: a[nb][2h + e] at
// column nb * 8 + (lane % 4) * 2 + e.
template <int T, int NF, int GC, int I, int J0, int J1, int N, typename Init, typename Epi>
__device__ __forceinline__ void gemm_stage(const unsigned char* smem_raw,
                                           const uint2* __restrict__ wfrag, Init init, Epi epi) {
  constexpr int S = side<T>(I), P = S * S;
  constexpr int MT = ((P + 15) / 16 + kWarps - 1) / kWarps;
  constexpr int items = ((P + 15) / 16 + MT - 1) / MT;
  constexpr int NB = N / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const uint32_t smem = uint32_t(__cvta_generic_to_shared(smem_raw));

  for (int item = warp; item < items; item += kWarps) {
    float acc[MT][NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float b0 = init(nb * 8 + tig * 2), b1 = init(nb * 8 + tig * 2 + 1);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        acc[m][nb][0] = b0; acc[m][nb][1] = b1; acc[m][nb][2] = b0; acc[m][nb][3] = b1;
      }
    }
    // the pixel this lane addresses for ldmatrix (rows past P repeat P - 1)
    int ry[MT], rx[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int q = min((item * MT + m) * 16 + (lane & 15), P - 1);
      ry[m] = q / S;
      rx[m] = q % S;
    }
    int ks = 0;
    if constexpr (J0 == 0)
      accumulate<MT, NF, NB>(acc, smem, side<T>(0), I - 1, ry, rx, wfrag, ks, lane);
#pragma unroll 1
    for (int j = J0 > 1 ? J0 : 1; j < J1; ++j)
      accumulate<MT, GC, NB>(acc, smem + plane_offset<T, NF, GC>(j), side<T>(j), I - j - 1, ry,
                             rx, wfrag, ks, lane);

#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = (item * MT + m) * 16 + gid + 8 * h;
        if (q >= P) continue;
        epi(q, q / S, q % S, acc[m], h);
      }
    }
  }
}

__device__ __forceinline__ void split_bf16(float v, float& hi, float& lo) {
  hi = round_to<__nv_bfloat16>(v);
  lo = round_to<__nv_bfloat16>(v - hi);
}

struct Params {
  const void* x;     // the window's source: the state, or its hi plane (paired)
  const void* lo;    // paired: the state's lo plane
  const void* u;     // the RRDB entry state (nullptr: no residual); paired: its hi plane
  const void* u_lo;  // paired: the entry state's lo plane
  void* out;         // paired: hi'
  void* out_lo;      // paired: lo'
  const int* flag;   // chained: fold the residual where *flag == 1
  const __nv_bfloat16* w;  // the five rectangles in fragment order
  const float* bias;       // [4 GC + NF]: b1..b5
  int H, W;                // the image
  // pixel (b, y, x) of x, lo, u, out at ((b rows + y + apron) cols + x + apron) NF
  int rows, cols, apron;
  int patches_x;
};

// Grid: (T x T patches of one tile, B).
template <int F, typename TS, int NF, int GC>
__global__ void __launch_bounds__(kThreads, 1)  // one block per SM: shared memory
    rdb_kernel(const Params p) {
  constexpr int T = tile<F>(), S0 = side<T>(0), chunks = NF / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y, H = p.H, W = p.W;
  const int py0 = (blockIdx.x / p.patches_x) * T, px0 = (blockIdx.x % p.patches_x) * T;
  const auto at = [&](int y, int x) {
    return ((size_t(b) * p.rows + y + p.apron) * p.cols + x + p.apron) * NF;
  };
  const TS* x = static_cast<const TS*>(p.x);

  // x window in bf16, zero outside the image (chained: the layout's zero
  // aprons hold those zeros, so the load has no bounds test)
  for (int idx = threadIdx.x; idx < S0 * S0 * chunks; idx += kThreads) {
    const int pix = idx / chunks, ch = idx % chunks;
    const int ty = py0 - kHalo + pix / S0, tx = px0 - kHalo + pix % S0;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (F == kChained || (ty >= 0 && ty < H && tx >= 0 && tx < W)) {
      const TS* src = x + at(ty, tx) + ch * 8;
      if constexpr (sizeof(TS) == 2) {
        q = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        float v[8];
        load8(src, v);
        q = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                       pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
      }
    }
    *reinterpret_cast<uint4*>(smem_raw + chunk_offset<NF>(pix, ch)) = q;
  }
  __syncthreads();

  // whether pixel (qy, qx) of region I lies in the image: c_I is zero
  // outside it (every conv's zero padding)
  const int tig = threadIdx.x % 4;
  const auto inside = [&](int I, int qy, int qx) {
    const int ty = py0 - kHalo + I + qy, tx = px0 - kHalo + I + qx;
    return ty >= 0 && ty < H && tx >= 0 && tx < W;
  };
  // c_I's two values at (pixel q, column c) as lrelu'd bf16 into plane I
  const auto put_c = [&](int I, int q, bool in, int c, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(smem_raw + plane_offset<T, NF, GC>(I) +
                                 chunk_offset<GC>(q, c >> 3) + (c & 7) * 2) =
        in ? pack_bf16x2(lrelu(v0), lrelu(v1)) : 0u;
  };
  // the output at patch pixel (qy, qx) from c5v(nb, e), c5 at column
  // nb * 8 + tig * 2 + e: 0.2 c5 + x, then the RRDB residual 0.2 y + u
  const bool fold = p.u != nullptr && (p.flag == nullptr || __ldg(p.flag) == 1);
  const auto put_out = [&](int qy, int qx, auto c5v) {
    constexpr int NB = NF / 8;
    const int ty = py0 + qy, tx = px0 + qx;
    if (ty >= H || tx >= W) return;
    const size_t o = at(ty, tx) + tig * 2;
    // every load of the pixel before its first store: out may be u
    // (chained), and the loads then overlap
    float xv[NB][2], lv[NB][2], uv[NB][2], ul[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      load2(x + o + nb * 8, xv[nb]);
      if constexpr (F == kPaired) load2(static_cast<const __nv_bfloat16*>(p.lo) + o + nb * 8, lv[nb]);
    }
    if (fold) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if constexpr (F == kPaired) {
          load2(static_cast<const __nv_bfloat16*>(p.u) + o + nb * 8, uv[nb]);
          load2(static_cast<const __nv_bfloat16*>(p.u_lo) + o + nb * 8, ul[nb]);
        } else {
          load2(static_cast<const TS*>(p.u) + o + nb * 8, uv[nb]);
        }
      }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float y[2], lo[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (F == kPaired) {
          // center = (0.2 c5 + hi) + lo, re-split into hi' + lo'; the
          // residual rebuilds both states in f32 first, as the JAX trunk
          // sums them
          split_bf16((kResidual * c5v(nb, e) + xv[nb][e]) + lv[nb][e], y[e], lo[e]);
          if (fold)
            split_bf16(kResidual * (y[e] + lo[e]) + (uv[nb][e] + ul[nb][e]), y[e], lo[e]);
        } else {
          y[e] = round_to<TS>(kResidual * c5v(nb, e) + xv[nb][e]);
          if (fold) y[e] = round_to<TS>(kResidual * y[e] + uv[nb][e]);
        }
      }
      if constexpr (F == kPaired) {
        store2(static_cast<__nv_bfloat16*>(p.out) + o + nb * 8, y);
        store2(static_cast<__nv_bfloat16*>(p.out_lo) + o + nb * 8, lo);
      } else {
        store2(static_cast<TS*>(p.out) + o + nb * 8, y);
      }
    }
  };
  const auto frag = [&](int r) {
    return reinterpret_cast<const uint2*>(p.w + weight_offset<F, NF, GC>(r));
  };
  const float* bias = p.bias;

  if constexpr (F != kPacked) {
    // conv I over {x, c1..c_{I-1}}, bias-seeded
    const auto c_epi = [&](int I) {
      return [&, I](int q, int qy, int qx, const auto& a, int h) {
        const bool in = inside(I, qy, qx);
#pragma unroll
        for (int nb = 0; nb < GC / 8; ++nb) put_c(I, q, in, nb * 8 + tig * 2, a[nb][2 * h], a[nb][2 * h + 1]);
      };
    };
    gemm_stage<T, NF, GC, 1, 0, 1, GC>(smem_raw, frag(1), [&](int c) { return bias[c]; }, c_epi(1));
    __syncthreads();
    gemm_stage<T, NF, GC, 2, 0, 2, GC>(smem_raw, frag(2), [&](int c) { return bias[GC + c]; }, c_epi(2));
    __syncthreads();
    gemm_stage<T, NF, GC, 3, 0, 3, GC>(smem_raw, frag(3), [&](int c) { return bias[2 * GC + c]; }, c_epi(3));
    __syncthreads();
    gemm_stage<T, NF, GC, 4, 0, 4, GC>(smem_raw, frag(4), [&](int c) { return bias[3 * GC + c]; }, c_epi(4));
    __syncthreads();
    gemm_stage<T, NF, GC, 5, 0, 5, NF>(
        smem_raw, frag(5), [&](int c) { return bias[4 * GC + c]; },
        [&](int, int qy, int qx, const auto& a, int h) {
          put_out(qy, qx, [&](int nb, int e) { return a[nb][2 * h + e]; });
        });
  } else {
    // the K-packed schedule; sums grouped as the JAX package's
    // _make_rdb_compute groups them: each rectangle's product first, then
    // its bias or partial sum
    constexpr int S2 = side<T>(2), S4 = side<T>(4), S5 = side<T>(5);
    constexpr int A24 = GC + kPadF, A5 = NF + kPadF;  // floats per pixel
    constexpr int G8 = GC / 8, F8 = NF / 8;             // n-blocks of gc, nf outputs
    float* a2 = reinterpret_cast<float*>(smem_raw + plane_offset<T, NF, GC>(5));
    float* a4 = a2;  // a2 is dead once c2 is made
    float* a5 = a4 + S4 * S4 * A24;
    const auto zero = [](int) { return 0.f; };
    const auto f2 = [](float* a) -> float2& { return *reinterpret_cast<float2*>(a); };

    // A: {x} -> {c1, a2} over c1's region; a2 kept on c2's
    gemm_stage<T, NF, GC, 1, 0, 1, 2 * GC>(
        smem_raw, frag(1), zero, [&](int q, int qy, int qx, const auto& a, int h) {
          const bool in = inside(1, qy, qx);
#pragma unroll
          for (int nb = 0; nb < G8; ++nb) {
            const int c = nb * 8 + tig * 2;
            put_c(1, q, in, c, a[nb][2 * h] + bias[c], a[nb][2 * h + 1] + bias[c + 1]);
          }
          if (qy >= 1 && qy <= S2 && qx >= 1 && qx <= S2) {
            float* d = a2 + ((qy - 1) * S2 + qx - 1) * A24 + tig * 2;
#pragma unroll
            for (int nb = 0; nb < G8; ++nb) {
              const int c = GC + nb * 8 + tig * 2;
              f2(d + nb * 8) = make_float2(a[G8 + nb][2 * h] + bias[c], a[G8 + nb][2 * h + 1] + bias[c + 1]);
            }
          }
        });
    __syncthreads();
    // B: {c1} -> c2 = lrelu(a2 + .)
    gemm_stage<T, NF, GC, 2, 1, 2, GC>(
        smem_raw, frag(2), zero, [&](int q, int qy, int qx, const auto& a, int h) {
          const bool in = inside(2, qy, qx);
          const float* s = a2 + q * A24 + tig * 2;
#pragma unroll
          for (int nb = 0; nb < G8; ++nb)
            put_c(2, q, in, nb * 8 + tig * 2, s[nb * 8] + a[nb][2 * h], s[nb * 8 + 1] + a[nb][2 * h + 1]);
        });
    __syncthreads();
    // C: {x, c1, c2} -> {c3, a4, a5}, one K = 9 (NF + 2 GC) product over
    // c3's region; a4 kept on c4's region, a5 on the output's
    gemm_stage<T, NF, GC, 3, 0, 3, 2 * GC + NF>(
        smem_raw, frag(3), zero, [&](int q, int qy, int qx, const auto& a, int h) {
          const float* b3 = bias + 2 * GC + tig * 2;  // b3, b4, b5 follow each other
          const bool in = inside(3, qy, qx);
#pragma unroll
          for (int nb = 0; nb < G8; ++nb)
            put_c(3, q, in, nb * 8 + tig * 2, a[nb][2 * h] + b3[nb * 8], a[nb][2 * h + 1] + b3[nb * 8 + 1]);
          if (qy >= 1 && qy <= S4 && qx >= 1 && qx <= S4) {
            float* d = a4 + ((qy - 1) * S4 + qx - 1) * A24 + tig * 2;
#pragma unroll
            for (int nb = 0; nb < G8; ++nb) {
              const int k = G8 + nb;
              f2(d + nb * 8) = make_float2(a[k][2 * h] + b3[k * 8], a[k][2 * h + 1] + b3[k * 8 + 1]);
            }
          }
          if (qy >= 2 && qy < S5 + 2 && qx >= 2 && qx < S5 + 2) {
            float* d = a5 + ((qy - 2) * S5 + qx - 2) * A5 + tig * 2;
#pragma unroll
            for (int nb = 0; nb < F8; ++nb) {
              const int k = 2 * G8 + nb;
              f2(d + nb * 8) = make_float2(a[k][2 * h] + b3[k * 8], a[k][2 * h + 1] + b3[k * 8 + 1]);
            }
          }
        });
    __syncthreads();
    // D: {c3} -> {c4 = lrelu(a4 + .), a5 += .} over c4's region
    gemm_stage<T, NF, GC, 4, 3, 4, GC + NF>(
        smem_raw, frag(4), zero, [&](int q, int qy, int qx, const auto& a, int h) {
          const bool in = inside(4, qy, qx);
          const float* s = a4 + q * A24 + tig * 2;
#pragma unroll
          for (int nb = 0; nb < G8; ++nb)
            put_c(4, q, in, nb * 8 + tig * 2, s[nb * 8] + a[nb][2 * h], s[nb * 8 + 1] + a[nb][2 * h + 1]);
          if (qy >= 1 && qy <= S5 && qx >= 1 && qx <= S5) {
            float* d = a5 + ((qy - 1) * S5 + qx - 1) * A5 + tig * 2;
#pragma unroll
            for (int nb = 0; nb < F8; ++nb) {
              float2& v = f2(d + nb * 8);
              v = make_float2(v.x + a[G8 + nb][2 * h], v.y + a[G8 + nb][2 * h + 1]);
            }
          }
        });
    __syncthreads();
    // E: {c4} -> c5 = a5 + ., then the output
    gemm_stage<T, NF, GC, 5, 4, 5, NF>(
        smem_raw, frag(5), zero, [&](int q, int qy, int qx, const auto& a, int h) {
          const float* s = a5 + q * A5 + tig * 2;
          put_out(qy, qx, [&](int nb, int e) { return s[nb * 8 + e] + a[nb][2 * h + e]; });
        });
  }
}

template <int F, typename TS, int NF, int GC>
int launch(Params p, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<F, NF, GC>();
  constexpr int T = tile<F>();
  const cudaError_t err = cudaFuncSetAttribute(
      rdb_kernel<F, TS, NF, GC>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  p.patches_x = (p.W + T - 1) / T;
  const int patches_y = (p.H + T - 1) / T;
  rdb_kernel<F, TS, NF, GC><<<dim3(p.patches_x * patches_y, B), kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <int F, typename TS>
int launch_shape(const Params& p, int B, int nf, int gc, cudaStream_t s) {
  if (nf == 64 && gc == 32) return launch<F, TS, 64, 32>(p, B, s);
  if (nf == 32 && gc == 16) return launch<F, TS, 32, 16>(p, B, s);
  return int(cudaErrorInvalidValue);
}

template <int F>
int launch_state(const Params& p, int B, int nf, int gc, int state_bf16, cudaStream_t s) {
  return state_bf16 ? launch_shape<F, __nv_bfloat16>(p, B, nf, gc, s)
                    : launch_shape<F, float>(p, B, nf, gc, s);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 operands: CUDA cores
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int kT = 10;
constexpr int kWin = kT + 2 * kHalo;
constexpr int kCo = 8;  // output channels of one thread item

// Side of source j's region (j = 0: the x window, j = 1..4: c_j), and its
// channel-plane stride (+1 float staggers the banks).
__host__ __device__ constexpr int side(int j) { return kWin - 2 * j; }
__host__ __device__ constexpr int pstride(int j) { return side(j) * side(j) + 1; }

size_t smem_bytes(int nf, int gc) {
  return sizeof(float) * (size_t(nf) * pstride(0) +
                          size_t(gc) * (pstride(1) + pstride(2) + pstride(3) + pstride(4)));
}

// x, u, out: [B, H, W, nf] f32; w: the five convs packed as [cin_i][3][3]
// [cout_i], back to back; bias: [4 gc + nf]. Grid: (patches of a tile, B).
__global__ void __launch_bounds__(kThreads)
    rdb_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ u,
               float* __restrict__ out, int H, int W, int nf, int gc, int patches_x) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int py0 = (blockIdx.x / patches_x) * kT;
  const int px0 = (blockIdx.x % patches_x) * kT;
  float* plane[5];
  plane[0] = smem;
  plane[1] = plane[0] + nf * pstride(0);
  for (int j = 2; j < 5; ++j) plane[j] = plane[j - 1] + gc * pstride(j - 1);

  // x window, zero outside the tile
  const float* xb = x + size_t(b) * H * W * nf;
  for (int idx = threadIdx.x; idx < kWin * kWin * nf; idx += kThreads) {
    const int ci = idx % nf, pix = idx / nf;
    const int ty = py0 - kHalo + pix / kWin, tx = px0 - kHalo + pix % kWin;
    float v = 0.f;
    if (ty >= 0 && ty < H && tx >= 0 && tx < W) v = xb[(size_t(ty) * W + tx) * nf + ci];
    plane[0][ci * pstride(0) + pix] = v;
  }
  __syncthreads();

  size_t woff = 0;
  int cin = nf;
  for (int i = 1; i <= 5; ++i) {
    // stage i: output region of side S at window offset i
    const int S = side(i), half = S / 2;
    const int cout = i < 5 ? gc : nf, ngrp = cout / kCo;
    const float* bi = bias + (i - 1) * gc;
    const float* wi = w + woff;
    for (int item = threadIdx.x; item < half * half * ngrp; item += kThreads) {
      const int g = item % ngrp, blk = item / ngrp;
      const int by = blk / half, bx = blk % half;
      float acc[4][kCo];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int n = 0; n < kCo; ++n) acc[p][n] = bi[g * kCo + n];

      for (int j = 0; j < i; ++j) {
        const int Sj = side(j), ps = pstride(j), off = i - j - 1;
        const int cj = j ? gc : nf, kbase = j ? nf + (j - 1) * gc : 0;
        const float* src = plane[j] + (2 * by + off) * Sj + 2 * bx + off;
        const float* wj = wi + size_t(kbase) * 9 * cout + g * kCo;
        for (int ci = 0; ci < cj; ++ci, src += ps, wj += 9 * cout) {
          float v[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) v[r][c] = src[r * Sj + c];
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            float wt[kCo];
            load8(wj + t * cout, wt);
            const int ky = t / 3, kx = t % 3;
#pragma unroll
            for (int p = 0; p < 4; ++p)
#pragma unroll
              for (int n = 0; n < kCo; ++n)
                acc[p][n] = fmaf(v[(p >> 1) + ky][(p & 1) + kx], wt[n], acc[p][n]);
          }
        }
      }

      if (i < 5) {
        // c_i: lrelu, zero outside the tile
        float* dst = plane[i] + g * kCo * pstride(i);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int ry = 2 * by + (p >> 1), rx = 2 * bx + (p & 1);
          const int ty = py0 - kHalo + i + ry, tx = px0 - kHalo + i + rx;
          const bool inside = ty >= 0 && ty < H && tx >= 0 && tx < W;
#pragma unroll
          for (int n = 0; n < kCo; ++n)
            dst[n * pstride(i) + ry * S + rx] = inside ? lrelu(acc[p][n]) : 0.f;
        }
      } else {
        // residual 0.2 * c5 + x, then the optional RRDB residual 0.2 * y + u
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int ty = py0 + 2 * by + (p >> 1), tx = px0 + 2 * bx + (p & 1);
          if (ty >= H || tx >= W) continue;
          const size_t o = ((size_t(b) * H + ty) * W + tx) * nf + g * kCo;
          float xv[kCo], y[kCo];
          load8(x + o, xv);
#pragma unroll
          for (int n = 0; n < kCo; ++n) y[n] = kResidual * acc[p][n] + xv[n];
          if (u != nullptr) {
            float uv[kCo];
            load8(u + o, uv);
#pragma unroll
            for (int n = 0; n < kCo; ++n) y[n] = kResidual * y[n] + uv[n];
          }
          reinterpret_cast<float4*>(out + o)[0] = make_float4(y[0], y[1], y[2], y[3]);
          reinterpret_cast<float4*>(out + o)[1] = make_float4(y[4], y[5], y[6], y[7]);
        }
      }
    }
    woff += size_t(cin) * 9 * cout;
    cin += gc;
    __syncthreads();
  }
}

int launch(const void* x, const void* w, const void* bias, const void* u, void* out, int B,
           int H, int W, int nf, int gc, cudaStream_t stream) {
  const size_t smem = smem_bytes(nf, gc);
  const cudaError_t err =
      cudaFuncSetAttribute(rdb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int patches_x = (W + kT - 1) / kT, patches_y = (H + kT - 1) / kT;
  rdb_kernel<<<dim3(patches_x * patches_y, B), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(u), static_cast<float*>(out),
      H, W, nf, gc, patches_x);
  return int(cudaGetLastError());
}

}  // namespace fp32

}  // namespace

extern "C" {

// One RDB over B tiles (K1/K2) with float32 state and operands, on CUDA
// cores (any nf, gc that are multiples of 8). Returns the cudaError_t of the
// launch.
int rdb_launch_f32(const void* x, const void* w, const void* bias, const void* u, void* out,
                   int B, int H, int W, int nf, int gc, void* stream) {
  if (nf % 8 || gc % 8 || B < 1 || B > 65535 || H < 1 || W < 1)
    return int(cudaErrorInvalidValue);
  return fp32::launch(x, w, bias, u, out, B, H, W, nf, gc, static_cast<cudaStream_t>(stream));
}

// K5: one RDB in the K-packed schedule (bf16 operands, nf, gc = 64, 32 or
// 32, 16); w holds the five packed rectangles in fragment order.
int rdb_launch_packed(const void* x, const void* w, const void* bias, const void* u, void* out,
                      int B, int H, int W, int nf, int gc, int state_bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1) return int(cudaErrorInvalidValue);
  tc::Params p{x, nullptr, u, nullptr, out, nullptr, nullptr,
               static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
               H, W, H, W, 0, 0};
  return tc::launch_state<tc::kPacked>(p, B, nf, gc, state_bf16, static_cast<cudaStream_t>(stream));
}

// K3: one RDB on the chained layout [B, rows, cols, nf] (image at row and
// column 5, zero aprons, rows >= H rounded up to 16 plus 10, cols alike);
// out gets the centre pixels, with the residual 0.2 y + u where *flag == 1
// (u may be out).
int rdb_launch_chained(const void* x, const void* w, const void* bias, const void* u,
                       const int* flag, void* out, int B, int H, int W, int rows, int cols,
                       int nf, int gc, int state_bf16, void* stream) {
  constexpr int T = tc::tile<tc::kChained>();
  if (B < 1 || B > 65535 || H < 1 || W < 1 || flag == nullptr ||
      rows < (H + T - 1) / T * T + 2 * kHalo || cols < (W + T - 1) / T * T + 2 * kHalo)
    return int(cudaErrorInvalidValue);
  tc::Params p{x, nullptr, u, nullptr, out, nullptr, flag,
               static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
               H, W, rows, cols, kHalo, 0};
  return tc::launch_state<tc::kChained>(p, B, nf, gc, state_bf16, static_cast<cudaStream_t>(stream));
}

// K4: one RDB on the paired state hi + lo ([B, H, W, nf] bf16 each) into
// hi_out + lo_out; u_hi / u_lo (both or neither): the RRDB residual.
int rdb_launch_paired(const void* hi, const void* lo, const void* w, const void* bias,
                      const void* u_hi, const void* u_lo, void* hi_out, void* lo_out, int B,
                      int H, int W, int nf, int gc, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || (u_hi == nullptr) != (u_lo == nullptr))
    return int(cudaErrorInvalidValue);
  tc::Params p{hi, lo, u_hi, u_lo, hi_out, lo_out, nullptr,
               static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
               H, W, H, W, 0, 0};
  return tc::launch_shape<tc::kPaired, __nv_bfloat16>(p, B, nf, gc, static_cast<cudaStream_t>(stream));
}

const char* rdb_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
