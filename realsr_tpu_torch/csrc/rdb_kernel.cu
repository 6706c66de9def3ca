// Fused residual dense block (RDB) for Hopper (sm_90a): the mma.sync and
// CUDA-core forms.
//
// Replaces, in realsr_tpu/ops/rdb_kernel.py:
//   K1 _rdb_kernel and K2 _rdb_resident_kernel for float32 operands only
//      (fp32::rdb_kernel below; bf16 operands run on csrc/rdb_wgmma.cu);
//   K3 _rdb_kernel(chained=True) (rdb_apply_chained): tc::rdb_kernel below.
// K4 (paired) and K5 (packed) run on K1's wgmma machinery in
// csrc/rdb_modes_wgmma.cu.
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
// - bf16 operands (mixed and bfloat16 modes), K3: tensor cores, template
//   tc::rdb_kernel<state type, nf, gc>. Shared memory holds bf16
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
//   K3 computes K1's arithmetic (the five convs in turn) on the persistent
//   layout [B, Hp + 10, Wp + 10, nf] (Hp, Wp: H, W rounded up to T; the
//   image at row and column 5). The aprons are zeroed once when the trunk
//   allocates its three buffers, and the kernel writes centre pixels only,
//   so they stay zero and the window load has no bounds test; c1..c4 are
//   still masked to zero outside the image. The residual folds where the
//   device flag *flag == 1.
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
constexpr int kT = 16;  // output patch side

// Side of region j of a T x T patch: 0 the x window, 1..4 c_j, 5 the output.
__host__ __device__ constexpr int side(int j) { return kT + 2 * kHalo - 2 * j; }

// Byte offset of plane j (0 = x window, 1..4 = c_j) in shared memory.
template <int NF, int GC>
__host__ __device__ constexpr int plane_offset(int j) {
  return j == 0 ? 0 : plane_offset<NF, GC>(j - 1) + 2 * (j == 1 ? NF : GC) * side(j - 1) * side(j - 1);
}

// Element offset of conv r's weights (K = 9 (NF + (r - 1) GC) rows by its
// outputs, in fragment order): the convs back to back, c1..c4 with GC outputs.
template <int NF, int GC>
__host__ __device__ constexpr int weight_offset(int r) {
  return r == 1 ? 0 : weight_offset<NF, GC>(r - 1) + 9 * (NF + (r - 2) * GC) * GC;
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

// Conv I over region I from sources 0..I-1 (0 = the x window, j = c_j) into
// N outputs. The region's m-tiles (16 pixels each) split into at most one
// item per warp, so each weight fragment serves MT m-tiles and no warp waits
// through a second round. The accumulators start from the bias; epi(q, qy,
// qx, a, h) takes pixel q's sums: a[nb][2h + e] at column nb * 8 + (lane %
// 4) * 2 + e.
template <int NF, int GC, int I, int N, typename Epi>
__device__ __forceinline__ void gemm_stage(const unsigned char* smem_raw, const uint2* __restrict__ wfrag,
                                           const float* __restrict__ bias, Epi epi) {
  constexpr int S = side(I), P = S * S;
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
      const float b0 = bias[nb * 8 + tig * 2], b1 = bias[nb * 8 + tig * 2 + 1];
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
    accumulate<MT, NF, NB>(acc, smem, side(0), I - 1, ry, rx, wfrag, ks, lane);
#pragma unroll 1
    for (int j = 1; j < I; ++j)
      accumulate<MT, GC, NB>(acc, smem + plane_offset<NF, GC>(j), side(j), I - j - 1, ry, rx, wfrag, ks, lane);

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

struct Params {
  const void* x;     // the state, chained layout
  const void* u;     // the RRDB entry state (chained), folded where *flag == 1
  void* out;         // the new state's image (chained)
  const int* flag;
  const __nv_bfloat16* w;  // the five convs in fragment order
  const float* bias;       // [4 GC + NF]: b1..b5
  int H, W;                // the image
  int rows, cols;          // the layout: pixel (b, y, x) at ((b rows + y + 5) cols + x + 5) NF
  int patches_x;
};

// Grid: (T x T patches of one tile, B).
template <typename TS, int NF, int GC>
__global__ void __launch_bounds__(kThreads, 1)  // one block per SM: shared memory
    rdb_kernel(const Params p) {
  constexpr int S0 = side(0), chunks = NF / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y, H = p.H, W = p.W;
  const int py0 = (blockIdx.x / p.patches_x) * kT, px0 = (blockIdx.x % p.patches_x) * kT;
  const auto at = [&](int y, int x) {
    return ((size_t(b) * p.rows + y + kHalo) * p.cols + x + kHalo) * NF;
  };
  const TS* x = static_cast<const TS*>(p.x);

  // x window in bf16; the layout's zero aprons hold the zeros outside the
  // image, so the load has no bounds test
  for (int idx = threadIdx.x; idx < S0 * S0 * chunks; idx += kThreads) {
    const int pix = idx / chunks, ch = idx % chunks;
    const TS* src = x + at(py0 - kHalo + pix / S0, px0 - kHalo + pix % S0) + ch * 8;
    uint4 q;
    if constexpr (sizeof(TS) == 2) {
      q = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      float v[8];
      load8(src, v);
      q = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                     pack_bf16x2(v[6], v[7]));
    }
    *reinterpret_cast<uint4*>(smem_raw + chunk_offset<NF>(pix, ch)) = q;
  }
  __syncthreads();

  const int tig = threadIdx.x % 4;
  // conv I's epilogue: lrelu'd bf16 into plane I, zero outside the image
  // (every conv's zero padding)
  const auto c_epi = [&](int I) {
    return [&, I](int q, int qy, int qx, const auto& a, int h) {
      const int ty = py0 - kHalo + I + qy, tx = px0 - kHalo + I + qx;
      const bool in = ty >= 0 && ty < H && tx >= 0 && tx < W;
#pragma unroll
      for (int nb = 0; nb < GC / 8; ++nb)
        *reinterpret_cast<uint32_t*>(smem_raw + plane_offset<NF, GC>(I) + chunk_offset<GC>(q, nb) + tig * 4) =
            in ? pack_bf16x2(lrelu(a[nb][2 * h]), lrelu(a[nb][2 * h + 1])) : 0u;
    };
  };
  const auto frag = [&](int r) { return reinterpret_cast<const uint2*>(p.w + weight_offset<NF, GC>(r)); };
  gemm_stage<NF, GC, 1, GC>(smem_raw, frag(1), p.bias, c_epi(1));
  __syncthreads();
  gemm_stage<NF, GC, 2, GC>(smem_raw, frag(2), p.bias + GC, c_epi(2));
  __syncthreads();
  gemm_stage<NF, GC, 3, GC>(smem_raw, frag(3), p.bias + 2 * GC, c_epi(3));
  __syncthreads();
  gemm_stage<NF, GC, 4, GC>(smem_raw, frag(4), p.bias + 3 * GC, c_epi(4));
  __syncthreads();
  // the output: 0.2 c5 + x, then the RRDB residual 0.2 y + u where the flag
  // is 1; every load of a pixel before its first store (out may be u)
  const bool fold = __ldg(p.flag) == 1;
  gemm_stage<NF, GC, 5, NF>(smem_raw, frag(5), p.bias + 4 * GC, [&](int, int qy, int qx, const auto& a, int h) {
    constexpr int NB = NF / 8;
    const int ty = py0 + qy, tx = px0 + qx;
    if (ty >= H || tx >= W) return;
    const size_t o = at(ty, tx) + tig * 2;
    float xv[NB][2], uv[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      load2(x + o + nb * 8, xv[nb]);
      if (fold) load2(static_cast<const TS*>(p.u) + o + nb * 8, uv[nb]);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        y[e] = round_to<TS>(kResidual * a[nb][2 * h + e] + xv[nb][e]);
        if (fold) y[e] = round_to<TS>(kResidual * y[e] + uv[nb][e]);
      }
      store2(static_cast<TS*>(p.out) + o + nb * 8, y);
    }
  });
}

template <typename TS, int NF, int GC>
int launch(Params p, int B, cudaStream_t stream) {
  constexpr int smem = plane_offset<NF, GC>(5);
  const cudaError_t err =
      cudaFuncSetAttribute(rdb_kernel<TS, NF, GC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  p.patches_x = (p.W + kT - 1) / kT;
  const int patches_y = (p.H + kT - 1) / kT;
  rdb_kernel<TS, NF, GC><<<dim3(p.patches_x * patches_y, B), kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename TS>
int launch_shape(const Params& p, int B, int nf, int gc, cudaStream_t s) {
  if (nf == 64 && gc == 32) return launch<TS, 64, 32>(p, B, s);
  if (nf == 32 && gc == 16) return launch<TS, 32, 16>(p, B, s);
  return int(cudaErrorInvalidValue);
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

// K3: one RDB on the chained layout [B, rows, cols, nf] (image at row and
// column 5, zero aprons, rows >= H rounded up to 16 plus 10, cols alike);
// out gets the centre pixels, with the residual 0.2 y + u where *flag == 1
// (u may be out). bf16 operands; nf, gc = 64, 32 or 32, 16.
int rdb_launch_chained(const void* x, const void* w, const void* bias, const void* u,
                       const int* flag, void* out, int B, int H, int W, int rows, int cols,
                       int nf, int gc, int state_bf16, void* stream) {
  constexpr int T = tc::kT;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || flag == nullptr ||
      rows < (H + T - 1) / T * T + 2 * kHalo || cols < (W + T - 1) / T * T + 2 * kHalo)
    return int(cudaErrorInvalidValue);
  const tc::Params p{x, u, out, flag, static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
                     H, W, rows, cols, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return state_bf16 ? tc::launch_shape<__nv_bfloat16>(p, B, nf, gc, s) : tc::launch_shape<float>(p, B, nf, gc, s);
}

const char* rdb_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
