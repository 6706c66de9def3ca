// Swin layer kernels for Hopper (sm_90a): K8 window attention and K9 the
// residual add with the LayerNorm after it. Python side:
// realsr_tpu_torch/ops/swin_kernel.py (the plain versions are there too).
//
// Neither replaces a TPU kernel: the JAX package has no transformer. They
// serve Real-SwinIR (models/swinir.py), whose 54 Swin layers of width 240
// run per tile: qkv, proj, fc1 and fc2 are plain bf16 products
// (torch.matmul); what sits between them is these two kernels.
//
// K8 window_attn<HEADS, HD>: per 8 x 8 window and head,
//   out = softmax(q k^T + B + M) v     (q pre-scaled by HD^-0.5 at load)
// q, k and v are read straight from the qkv product's [B, Hp, Wp, 3C] bf16
// output at the shifted layer's rolled coordinates (pixel (y + s) mod Hp,
// (x + s) mod Wp for window position (y, x)), and the output is written at
// the pixels they were read from, which is the roll back: no torch.roll
// and no partition copies. B is the relative-position bias, packed at load
// in each lane's accumulator order (pack_bias); M is SwinIR's
// calculate_mask, -100 between tokens of different regions of the shifted
// map, found from the region labels of the two tokens' rolled coordinates.
//
// Bound: bytes. Per token and layer q, k, v in and the output out are
// 1,920 bytes against 61,440 FLOP of q k^T and . v (32 FLOP/B, the card's
// ridge is ~295). So the design keeps every read of device memory 16
// bytes wide and single: a block takes one window and four of its heads
// (the q, k and v channels of four heads are 240-byte runs, 16-byte
// aligned), copies them by cp.async into shared memory (48 KB, 4 blocks an
// SM), and each of its 4 warps computes one head with mma.sync m16n8k16
// (bf16 in, f32 sums): for each 16-row tile, S = q k^T over 64 keys (head
// dim 30 padded to 32 by zeroing q's last two columns in registers), + B
// + M, row max and sum by quad shuffles, P = exp(S - max) rounded to bf16
// as the A operand of P v (the accumulator layout of S is the A layout of
// the next product), 1/sum after. Fragments load from shared memory as
// 32-bit words at a row pitch of 376 values, which no two lanes of a load
// share a bank at. The output of a row tile goes over q's columns of its
// own head, then the block writes its 64 x 120 values out in 16-byte
// stores.
//
// K9 swin_norm<C>: per token s = x + branch (f32 residual, bf16 branch),
// optionally s = LN_pre(s) (the patch embed's norm before the first
// layer's), s written as the next residual where asked, and LN(s), or s,
// written in bf16 for the next product. One warp a token, 8 channels a lane
// (30 lanes at C = 240): every value read and written once, 16 bytes a
// lane, statistics in f32 by warp shuffles. Bound: bytes (2,880 a token at
// a layer's add + norm).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWin = 8;       // window side
constexpr int kTok = 64;      // tokens of a window
constexpr int kHeadsBlk = 4;  // heads a block
constexpr int kThreads = 128; // one warp a head

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t lds_pair(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  return uint32_t(*reinterpret_cast<const uint16_t*>(lo)) | (uint32_t(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

// d += a (16 x 16, row) * b (16 x 8, col); bf16 operands, f32 sums
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the region of a shifted map's row (or column) i of n: SwinIR's slices
// (0, -window), (-window, -shift), (-shift, None)
__device__ __forceinline__ int region(int i, int n, int shift) {
  return (i >= n - kWin) + (i >= n - shift);
}

template <int HEADS, int HD>
__global__ void __launch_bounds__(kThreads, 4)
    window_attn_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int Hp, int Wp, int shift) {
  constexpr int C = HEADS * HD;
  constexpr int GC = kHeadsBlk * HD;  // channels of q (k, v) of the block's heads: 120
  constexpr int CH = GC / 8;          // their 16-byte chunks a token: 15
  constexpr int ROW = 3 * GC + 16;    // shared row pitch in values: 376, conflict-free fragments
  static_assert(GC % 8 == 0 && HD % 2 == 0 && HD <= 32 && HEADS % kHeadsBlk == 0, "shapes");
  __shared__ __align__(16) __nv_bfloat16 sm[kTok * ROW];

  const int nwx = Wp / kWin, nwy = Hp / kWin;
  int bid = blockIdx.x;
  const int grp = bid % (HEADS / kHeadsBlk);
  bid /= HEADS / kHeadsBlk;
  const int wx = bid % nwx;
  bid /= nwx;
  const int wy = bid % nwy;
  const int b = bid / nwy;
  const int tid = threadIdx.x;

  // window token t -> its pixel's offset in tokens
  auto pixel = [&](int t) {
    int y = wy * kWin + (t >> 3) + shift, x = wx * kWin + (t & 7) + shift;
    y -= y >= Hp ? Hp : 0;
    x -= x >= Wp ? Wp : 0;
    return (size_t(b) * Hp + y) * Wp + x;
  };

  for (int i = tid; i < kTok * 3 * CH; i += kThreads) {
    const int t = i / (3 * CH), r = i % (3 * CH), seg = r / CH, ch = r % CH;
    cp_async16(sm + t * ROW + seg * GC + ch * 8, qkv + pixel(t) * (3 * C) + seg * C + grp * GC + ch * 8);
  }
  for (int i = tid; i < kTok * 2; i += kThreads)  // the pad columns: finite for the padded dims' reads
    *reinterpret_cast<uint4*>(sm + (i >> 1) * ROW + 3 * GC + (i & 1) * 8) = make_uint4(0, 0, 0, 0);
  cp_async_wait_all();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int head = grp * kHeadsBlk + warp;
  __nv_bfloat16* Q = sm + warp * HD;
  const __nv_bfloat16* K = sm + GC + warp * HD;
  const __nv_bfloat16* V = sm + 2 * GC + warp * HD;
  const bool masked = shift > 0 && (wy == nwy - 1 || wx == nwx - 1);
  // a token's region label in the shifted map
  auto label = [&](int t) {
    return 3 * region(wy * kWin + (t >> 3), Hp, shift) + region(wx * kWin + (t & 7), Wp, shift);
  };
  const uint4* bp = reinterpret_cast<const uint4*>(bias) + size_t(head) * 4 * 32 * 4;

#pragma unroll 1
  for (int mt = 0; mt < 4; ++mt) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    uint32_t qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int k0 = ks * 16 + 2 * c;
      qa[ks][0] = k0 < HD ? lds32(Q + r0 * ROW + k0) : 0u;
      qa[ks][1] = k0 < HD ? lds32(Q + r1 * ROW + k0) : 0u;
      qa[ks][2] = k0 + 8 < HD ? lds32(Q + r0 * ROW + k0 + 8) : 0u;
      qa[ks][3] = k0 + 8 < HD ? lds32(Q + r1 * ROW + k0 + 8) : 0u;
    }
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = K + (nt * 8 + g) * ROW + 2 * c;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) mma16816(s[nt], qa[ks], lds32(kr + ks * 16), lds32(kr + ks * 16 + 8));
    }
    // + bias: this lane's 32 values of the row tile, n-tile by n-tile
    const uint4* bl = bp + (mt * 32 + lane) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 u = __ldg(bl + j);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 top = unpack_bf16(w[2 * h]), bot = unpack_bf16(w[2 * h + 1]);
        float* d = s[2 * j + h];
        d[0] += top.x;
        d[1] += top.y;
        d[2] += bot.x;
        d[3] += bot.y;
      }
    }
    if (masked) {
      const int l0 = label(r0), l1 = label(r1);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lk = label(nt * 8 + 2 * c + e);
          s[nt][e] += lk != l0 ? -100.f : 0.f;
          s[nt][2 + e] += lk != l1 ? -100.f : 0.f;
        }
      }
    }
    // softmax over the 64 keys of rows r0 (values 0, 1) and r1 (2, 3):
    // each row's 64 values lie in the 4 lanes of a quad
    float m0 = -3.0e38f, m1 = -3.0e38f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - m0);
      s[nt][1] = __expf(s[nt][1] - m0);
      s[nt][2] = __expf(s[nt][2] - m1);
      s[nt][3] = __expf(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    // o = P v: keys 16kk..16kk+15 are n-tiles 2kk, 2kk + 1 of S
    float o[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr = V + (kk * 16 + 2 * c) * ROW + g;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* v = vr + nt * 8;
        mma16816(o[nt], pa, lds_pair(v, v + ROW), lds_pair(v + 8 * ROW, v + 9 * ROW));
      }
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int d = nt * 8 + 2 * c;
      if (d < HD) {
        *reinterpret_cast<uint32_t*>(Q + r0 * ROW + d) = pack_bf16(o[nt][0] * i0, o[nt][1] * i0);
        *reinterpret_cast<uint32_t*>(Q + r1 * ROW + d) = pack_bf16(o[nt][2] * i1, o[nt][3] * i1);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kTok * CH; i += kThreads) {
    const int t = i / CH, ch = i % CH;
    *reinterpret_cast<uint4*>(out + pixel(t) * C + grp * GC + ch * 8) =
        *reinterpret_cast<const uint4*>(sm + t * ROW + ch * 8);
  }
}

struct AttnArgs {
  const void* qkv;
  const void* bias;
  void* out;
  int B, Hp, Wp, shift;
};

template <int HEADS, int HD>
int launch_window_attn(const AttnArgs& a, cudaStream_t s) {
  if (a.Hp % kWin || a.Wp % kWin || a.shift < 0 || a.shift >= kWin || a.B < 1) return int(cudaErrorInvalidValue);
  const long long blocks = 1LL * a.B * (a.Hp / kWin) * (a.Wp / kWin) * (HEADS / kHeadsBlk);
  if (blocks < 1 || blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  window_attn_kernel<HEADS, HD><<<unsigned(blocks), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a.qkv), static_cast<const __nv_bfloat16*>(a.bias),
      static_cast<__nv_bfloat16*>(a.out), a.Hp, a.Wp, a.shift);
  return int(cudaGetLastError());
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// v (8 values of the lane, zero on idle lanes) -> LN(v) with w, b
template <int C>
__device__ __forceinline__ void layer_norm(float (&v)[8], bool act, const float* w, const float* b, int c0,
                                           float eps) {
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) sum += v[k];
  const float mean = warp_sum(sum) * (1.f / C);
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float d = act ? v[k] - mean : 0.f;
    sq += d * d;
  }
  const float rstd = rsqrtf(warp_sum(sq) * (1.f / C) + eps);
  if (!act) return;
  const float4 w0 = __ldg(reinterpret_cast<const float4*>(w + c0)), w1 = __ldg(reinterpret_cast<const float4*>(w + c0 + 4));
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(b + c0)), b1 = __ldg(reinterpret_cast<const float4*>(b + c0 + 4));
  const float ww[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = (v[k] - mean) * rstd * ww[k] + bb[k];
}

template <int C>
__global__ void __launch_bounds__(256)
    swin_norm_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ branch,
                     const float* __restrict__ pre_w, const float* __restrict__ pre_b, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ res, __nv_bfloat16* __restrict__ out, int n,
                     float eps) {
  static_assert(C % 8 == 0 && C / 8 <= 32, "one warp a token, 8 channels a lane");
  const int token = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (token >= n) return;
  const bool act = lane < C / 8;
  const int c0 = lane * 8;
  const size_t base = size_t(token) * C + c0;
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (act) {
    const float4 a0 = *reinterpret_cast<const float4*>(x + base), a1 = *reinterpret_cast<const float4*>(x + base + 4);
    v[0] = a0.x, v[1] = a0.y, v[2] = a0.z, v[3] = a0.w, v[4] = a1.x, v[5] = a1.y, v[6] = a1.z, v[7] = a1.w;
    if (branch != nullptr) {
      const uint4 u = *reinterpret_cast<const uint4*>(branch + base);
      const uint32_t p[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = unpack_bf16(p[k]);
        v[2 * k] += f.x;
        v[2 * k + 1] += f.y;
      }
    }
  }
  // every lane takes part in the norms' shuffles; only the active ones store
  if (pre_w != nullptr) layer_norm<C>(v, act, pre_w, pre_b, c0, eps);
  if (act && res != nullptr) {
    *reinterpret_cast<float4*>(res + base) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(res + base + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
  if (w != nullptr) layer_norm<C>(v, act, w, b, c0, eps);
  if (act)
    *reinterpret_cast<uint4*>(out + base) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

struct NormArgs {
  const void *x, *branch, *pre_w, *pre_b, *w, *b;
  void *res, *out;
  int n;
  float eps;
};

template <int C>
int launch_swin_norm(const NormArgs& a, cudaStream_t s) {
  if (a.n < 1) return int(cudaErrorInvalidValue);
  const int per_block = 256 / 32;
  swin_norm_kernel<C><<<(a.n + per_block - 1) / per_block, 256, 0, s>>>(
      static_cast<const float*>(a.x), static_cast<const __nv_bfloat16*>(a.branch),
      static_cast<const float*>(a.pre_w), static_cast<const float*>(a.pre_b), static_cast<const float*>(a.w),
      static_cast<const float*>(a.b), static_cast<float*>(a.res), static_cast<__nv_bfloat16*>(a.out), a.n, a.eps);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// K8 over B maps of Hp x Wp tokens (whole windows of 8) of width C in
// heads: qkv [B, Hp, Wp, 3C] bf16, bias the packed [heads * 4096] bf16 of
// one layer, out [B, Hp, Wp, C] bf16; shift 0 or the layer's roll. Returns
// the cudaError_t of the launch.
int window_attn_launch(const void* qkv, const void* bias, void* out, int B, int Hp, int Wp, int C, int heads,
                       int shift, void* stream) {
  const AttnArgs a{qkv, bias, out, B, Hp, Wp, shift};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (heads == 8 && C == 240) return launch_window_attn<8, 30>(a, s);
  return int(cudaErrorInvalidValue);
}

// K9 over n tokens of width C: x [n, C] f32, branch [n, C] bf16 or null,
// pre_w / pre_b (a LayerNorm before the residual is written) or null, w / b
// (the LayerNorm of the output) or null, res [n, C] f32 or null, out [n, C]
// bf16. Returns the cudaError_t of the launch.
int swin_norm_launch(const void* x, const void* branch, const void* pre_w, const void* pre_b, const void* w,
                     const void* b, void* res, void* out, int n, int C, float eps, void* stream) {
  const NormArgs a{x, branch, pre_w, pre_b, w, b, res, out, n, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 240) return launch_swin_norm<240>(a, s);
  return int(cudaErrorInvalidValue);
}

const char* swin_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
