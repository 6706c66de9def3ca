// Fused packed-phase tail for Hopper (sm_90a): up2 + HRconv + conv_last.
//
// Replaces realsr_tpu/ops/tail_kernel.py::_tail_kernel in both of its forms:
// with_up2=True (up2_hr_last_packed, K6: from the four 2x phases P1 that
// up1 writes) and with_up2=False (hr_last_packed, K7: from the sixteen 4x
// phases P2, materialized). Python side: realsr_tpu_torch/ops/tail_kernel.py.
//
// What it computes, in 4x-resolution coordinates (nf = 64, 3 outputs):
//   P2(2y+c, 2x+d) = lrelu(b2 + sum_{s,t} k2[c][d][s,t] . X2(y+c-1+s, x+d-1+t))
//     X2 is the 2x image the P1 phases hold, zero outside the tile; k2 are
//     the tap sums of nearest-x2 + conv3x3 (4 taps instead of 9)
//   z   = lrelu(conv3x3(P2) + b1)          P2 zero outside the 4x tile
//   out = conv3x3(z) + b3, float32          z zero outside the 4x tile
// P2 and z are rounded to bf16 (the operand type); sums are f32. The output
// is written interleaved, [B, 4H, 4W, 3], so no phase interleave follows.
//
// Bound: compute. Per base pixel the tail is 16 * 64 * (256 + 576) +
// 16 * 3 * 576 = 879,616 MACs against 512 B of P1 read (4 phases x 64
// bf16) and 192 B written (16 pixels x 3 f32): ~2,500 flop per byte, far
// above the card's ~295. What the TPU kernel keeps out of HBM, this one keeps
// out of device memory too: P2 and z (64 channels at 4x resolution, 718 MB
// each per chunk of 8 x 148^2 tiles in f32) live only in shared memory.
//
// Design: the TPU kernel holds a whole row block of all 16 phases in ~100 MB
// of VMEM; an SM has 227 KB. Here one block of 8 warps owns a 16 x 16 patch
// of the 4x output and keeps in shared memory, as bf16, pixel-major with the
// 16-byte channel chunks XOR-swizzled by pixel (as in rdb_kernel.cu, so
// ldmatrix reads 8 pixels of one chunk without bank conflicts):
//   region A: the 12 x 12 2x window (18 KB) during up2, then z with its
//             1-pixel halo (18 x 18, 41 KB);
//   region B: P2 with its 2-pixel halo (20 x 20, 51 KB).
// 92.7 KB in all. Each stage is a gather GEMM on mma.sync m16n8k16 (bf16 in,
// f32 accumulators): up2 is four of them, one per 4x sub-phase (c, d), with
// M = 100 pixels, K = 4 taps x 64, N = 64; HRconv M = 324, K = 576, N = 64;
// conv_last M = 256, K = 576, N = 8 (3 padded). A warp item is a run of
// m-tiles times all output channels; the B fragments come from weights
// packed at load time in fragment order (ops/tail_kernel.py::_frag_perm)
// through L2/L1, each serving all m-tiles of the item. The halo recompute
// costs 1.56x on up2 and 1.27x on HRconv; with conv_last's padding and the
// m-tile rounding the block does ~1.4x the tail's MACs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNF = 64;
constexpr int kOut = 3;
constexpr int kT = 16;          // output patch side (4x pixels)
constexpr int kZ = kT + 2;      // z region: conv_last's 1-pixel halo
constexpr int kP = kT + 4;      // P2 region: HRconv's halo on top
constexpr int kQ = kP / 2;      // P2 pixels of one sub-phase per side
constexpr int kX = kQ + 2;      // 2x window side: up2's taps reach one 2x pixel out
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKb = kNF / 16;   // k-steps per tap
constexpr float kSlope = 0.2f;
constexpr int kPixBytes = kNF * 2;
constexpr int kBytesA = kZ * kZ * kPixBytes;  // holds the window (kX^2 pixels) first
constexpr int kSmem = kBytesA + kP * kP * kPixBytes;
static_assert(kX * kX <= kZ * kZ, "the 2x window must fit region A");

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : v * kSlope; }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// Byte offset of (pixel, 16-byte channel chunk) in a 64-channel plane: the
// chunk index is XORed with the pixel's low bits, so the 8 rows of an
// ldmatrix phase (8 consecutive pixels, one chunk) hit 8 bank groups.
__device__ __forceinline__ uint32_t chunk_offset(int pix, int chunk) {
  return uint32_t(pix) * kPixBytes + (uint32_t(chunk ^ (pix & 7)) << 4);
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

template <int MT, int NB>
__device__ __forceinline__ void init_acc(float (&acc)[MT][NB][4], const float* __restrict__ bias,
                                         int tig) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const float b0 = bias[nb * 8 + tig * 2], b1 = bias[nb * 8 + tig * 2 + 1];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      acc[m][nb][0] = b0; acc[m][nb][1] = b1; acc[m][nb][2] = b0; acc[m][nb][3] = b1;
    }
  }
}

// Accumulate a KS x KS conv over a 64-channel plane of side S into a warp
// item of MT m-tiles x NB n-blocks. This lane's ldmatrix row of m-tile m
// reads the plane at pixel (ry[m] + ky, rx[m] + kx) for tap (ky, kx); the
// k-steps run over (tap, 16-channel block), as the weights were packed.
template <int MT, int NB, int KS>
__device__ __forceinline__ void accumulate(float (&acc)[MT][NB][4], uint32_t plane, int S,
                                           const int (&ry)[MT], const int (&rx)[MT],
                                           const uint2* __restrict__ wfrag, int lane) {
#pragma unroll 1
  for (int tap = 0; tap < KS * KS; ++tap) {
    int sp[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) sp[m] = (ry[m] + tap / KS) * S + rx[m] + tap % KS;
#pragma unroll
    for (int kb = 0; kb < kKb; ++kb) {
      const int ks = tap * kKb + kb;
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldmatrix_x4(plane + chunk_offset(sp[m], 2 * kb + (lane >> 4)), a[m]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const uint2 b = __ldg(wfrag + (size_t(ks) * NB + nb) * 32 + lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(acc[m][nb], a[m], b.x, b.y);
      }
    }
  }
}

// up2 into region B. P2 pixel (py, px) of the region, at 4x (Y0 - 2 + py,
// X0 - 2 + px), has sub-phase (c, d) = (py & 1, px & 1) (Y0 and X0 are even)
// and reads the 2x window at (py / 2 + c + s, px / 2 + d + t): one GEMM per
// sub-phase with its own tap-sum weights.
__device__ __forceinline__ void up2_stage(unsigned char* smem_raw, const __nv_bfloat16* __restrict__ w2,
                                          const float* __restrict__ b2, int H4, int W4, int Y0,
                                          int X0) {
  constexpr int MT = 2, NB = 8;
  constexpr int n_pix = kQ * kQ, n_mt = (n_pix + 15) / 16, runs = (n_mt + MT - 1) / MT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const uint32_t smem = uint32_t(__cvta_generic_to_shared(smem_raw));
  for (int item = warp; item < 4 * runs; item += kWarps) {
    const int g = item / runs, c = g >> 1, d = g & 1, mt0 = (item % runs) * MT;
    float acc[MT][NB][4];
    init_acc<MT, NB>(acc, b2, tig);
    int ry[MT], rx[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int q = min((mt0 + m) * 16 + (lane & 15), n_pix - 1);
      ry[m] = q / kQ + c;
      rx[m] = q % kQ + d;
    }
    accumulate<MT, NB, 2>(acc, smem, kX, ry, rx,
                          reinterpret_cast<const uint2*>(w2) + size_t(g) * 4 * kKb * NB * 32, lane);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = (mt0 + m) * 16 + gid + 8 * h;
        if (q >= n_pix) continue;
        const int py = 2 * (q / kQ) + c, px = 2 * (q % kQ) + d;
        const int Y = Y0 - 2 + py, X = X0 - 2 + px;
        const bool inside = Y >= 0 && Y < H4 && X >= 0 && X < W4;
        unsigned char* dst = smem_raw + kBytesA + 4 * tig;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const uint32_t v =
              inside ? pack_bf16x2(lrelu(acc[m][nb][2 * h]), lrelu(acc[m][nb][2 * h + 1])) : 0u;
          *reinterpret_cast<uint32_t*>(dst + chunk_offset(py * kP + px, nb)) = v;
        }
      }
    }
  }
}

// HRconv from region B into region A: z pixel (zy, zx), at 4x (Y0 - 1 + zy,
// X0 - 1 + zx), reads P2 region pixels (zy + ky, zx + kx).
__device__ __forceinline__ void hr_stage(unsigned char* smem_raw, const __nv_bfloat16* __restrict__ w1,
                                         const float* __restrict__ b1, int H4, int W4, int Y0,
                                         int X0) {
  constexpr int MT = 3, NB = 8;
  constexpr int n_pix = kZ * kZ, items = ((n_pix + 15) / 16 + MT - 1) / MT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const uint32_t smem = uint32_t(__cvta_generic_to_shared(smem_raw));
  for (int item = warp; item < items; item += kWarps) {
    float acc[MT][NB][4];
    init_acc<MT, NB>(acc, b1, tig);
    int ry[MT], rx[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int q = min((item * MT + m) * 16 + (lane & 15), n_pix - 1);
      ry[m] = q / kZ;
      rx[m] = q % kZ;
    }
    accumulate<MT, NB, 3>(acc, smem + kBytesA, kP, ry, rx, reinterpret_cast<const uint2*>(w1),
                          lane);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = (item * MT + m) * 16 + gid + 8 * h;
        if (q >= n_pix) continue;
        const int Y = Y0 - 1 + q / kZ, X = X0 - 1 + q % kZ;
        const bool inside = Y >= 0 && Y < H4 && X >= 0 && X < W4;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const uint32_t v =
              inside ? pack_bf16x2(lrelu(acc[m][nb][2 * h]), lrelu(acc[m][nb][2 * h + 1])) : 0u;
          *reinterpret_cast<uint32_t*>(smem_raw + chunk_offset(q, nb) + 4 * tig) = v;
        }
      }
    }
  }
}

// conv_last from region A into the interleaved f32 output.
__device__ __forceinline__ void last_stage(const unsigned char* smem_raw,
                                           const __nv_bfloat16* __restrict__ w9,
                                           const float* __restrict__ b3, float* __restrict__ out,
                                           int b, int H4, int W4, int Y0, int X0) {
  constexpr int MT = 2, NB = 1;
  constexpr int items = kT * kT / 16 / MT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const uint32_t smem = uint32_t(__cvta_generic_to_shared(smem_raw));
  for (int item = warp; item < items; item += kWarps) {
    float acc[MT][NB][4];
    init_acc<MT, NB>(acc, b3, tig);
    int ry[MT], rx[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int q = (item * MT + m) * 16 + (lane & 15);
      ry[m] = q / kT;
      rx[m] = q % kT;
    }
    accumulate<MT, NB, 3>(acc, smem, kZ, ry, rx, reinterpret_cast<const uint2*>(w9), lane);
    if (2 * tig >= kOut) continue;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = (item * MT + m) * 16 + gid + 8 * h;
        const int Y = Y0 + q / kT, X = X0 + q % kT;
        if (Y >= H4 || X >= W4) continue;
        float* o = out + ((size_t(b) * H4 + Y) * W4 + X) * kOut + 2 * tig;
        o[0] = acc[m][0][2 * h];
        if (2 * tig + 1 < kOut) o[1] = acc[m][0][2 * h + 1];
      }
    }
  }
}

// UP2: x is P1 as up1 writes it, [B, H + 1, W + 1, 4 * 64] bf16, phase (i, j)
// of base pixel (a, b) at [a + i, b + j, (2i + j) * 64]. Otherwise x is P2,
// [B, H, W, 16 * 64] bf16, phase (P, Q) of base pixel (a, b) at
// [a, b, (4P + Q) * 64]. w2, w1, w9: bf16 in fragment order; b2, b1: [64],
// b3: [8] f32. out: [B, 4H, 4W, 3] f32. Grid: (16 x 16 patches of the 4x
// tile, B).
template <bool UP2>
__global__ void __launch_bounds__(kThreads, 1)
    tail_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w2,
                const float* __restrict__ b2, const __nv_bfloat16* __restrict__ w1,
                const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w9,
                const float* __restrict__ b3, float* __restrict__ out, int H, int W,
                int patches_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  const int Y0 = (blockIdx.x / patches_x) * kT, X0 = (blockIdx.x % patches_x) * kT;
  const int H4 = 4 * H, W4 = 4 * W;
  constexpr int chunks = kNF / 8;
  if constexpr (UP2) {
    // the 2x window, rows and columns from (Y0 / 2 - 2, X0 / 2 - 2); zero
    // outside the 2x tile
    for (int idx = threadIdx.x; idx < kX * kX * chunks; idx += kThreads) {
      const int pix = idx / chunks, ch = idx % chunks;
      const int r2 = Y0 / 2 - 2 + pix / kX, c2 = X0 / 2 - 2 + pix % kX;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r2 >= 0 && r2 < 2 * H && c2 >= 0 && c2 < 2 * W) {
        const int i = r2 & 1, j = c2 & 1;
        const size_t o = ((size_t(b) * (H + 1) + (r2 >> 1) + i) * (W + 1) + (c2 >> 1) + j) * (4 * kNF) +
                         (2 * i + j) * kNF + ch * 8;
        v = __ldg(reinterpret_cast<const uint4*>(x + o));
      }
      *reinterpret_cast<uint4*>(smem_raw + chunk_offset(pix, ch)) = v;
    }
    __syncthreads();
    up2_stage(smem_raw, w2, b2, H4, W4, Y0, X0);
  } else {
    // P2 with its 2-pixel halo, zero outside the 4x tile
    for (int idx = threadIdx.x; idx < kP * kP * chunks; idx += kThreads) {
      const int pix = idx / chunks, ch = idx % chunks;
      const int Y = Y0 - 2 + pix / kP, X = X0 - 2 + pix % kP;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (Y >= 0 && Y < H4 && X >= 0 && X < W4) {
        const size_t o = ((size_t(b) * H + (Y >> 2)) * W + (X >> 2)) * (16 * kNF) +
                         ((Y & 3) * 4 + (X & 3)) * kNF + ch * 8;
        v = __ldg(reinterpret_cast<const uint4*>(x + o));
      }
      *reinterpret_cast<uint4*>(smem_raw + kBytesA + chunk_offset(pix, ch)) = v;
    }
  }
  __syncthreads();
  hr_stage(smem_raw, w1, b1, H4, W4, Y0, X0);
  __syncthreads();
  last_stage(smem_raw, w9, b3, out, b, H4, W4, Y0, X0);
}

template <bool UP2>
int launch(const void* x, const void* w2, const void* b2, const void* w1, const void* b1,
           const void* w9, const void* b3, void* out, int B, int H, int W, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(tail_kernel<UP2>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return int(err);
  const int patches_x = (4 * W + kT - 1) / kT, patches_y = (4 * H + kT - 1) / kT;
  tail_kernel<UP2><<<dim3(patches_x * patches_y, B), kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w9),
      static_cast<const float*>(b3), static_cast<float*>(out), H, W, patches_x);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// The fused tail over B tiles of H x W base pixels (nf = 64, 3 outputs, bf16
// operands). with_up2 = 1: x is P1 (K6); 0: x is P2 and w2, b2 are unused
// (K7). Returns the cudaError_t of the launch.
int tail_launch(const void* x, const void* w2, const void* b2, const void* w1, const void* b1,
                const void* w9, const void* b3, void* out, int B, int H, int W, int with_up2,
                void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || H > (1 << 20) || W > (1 << 20))
    return int(cudaErrorInvalidValue);
  if (with_up2 && (w2 == nullptr || b2 == nullptr)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_up2) return launch<true>(x, w2, b2, w1, b1, w9, b3, out, B, H, W, s);
  return launch<false>(x, w2, b2, w1, b1, w9, b3, out, B, H, W, s);
}

const char* tail_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
