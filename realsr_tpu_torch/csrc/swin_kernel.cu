// Swin layer kernels for Hopper (sm_90a): K8 window attention, K9 the
// residual add with the LayerNorm after it and K10 the MLP. Python side:
// realsr_tpu_torch/ops/swin_kernel.py (the plain versions are there too).
//
// None replaces a TPU kernel: the JAX package has no transformer. They
// serve Real-SwinIR (models/swinir.py), whose 54 Swin layers of width 240
// run per tile: qkv and proj are plain bf16 products (torch.matmul); the
// attention between them, the adds and norms and the MLP are these kernels.
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
//
// K10 swin_mlp<HC>: per token m = fc2(GELU(h W1^T + b1)) + b2, C = 240,
// hidden 480, GELU with the exact erf (nn.GELU()'s default) in f32, the
// hidden rounded to bf16 once, after GELU (the route it replaced, F.linear,
// F.gelu, F.linear, rounded fc1's output and GELU's). It was added to keep
// the hidden (960 bytes a token) out of device memory: the three passes
// over it were 3,840 of a Swin layer's ~15,360 bytes a token.
// Bound: operations. fc1 + fc2 are 230,400 MACs a token against 960 bytes
// of h read and m written: 480 flop a byte, above the card's ~295.
// Design (one persistent block per SM, 384 threads: two consumer
// warpgroups and a producer warpgroup, setmaxnreg as in rdb_wgmma.cu;
// helpers in hopper.cuh). A block walks 128-token tiles, 64 rows a
// consumer warpgroup, and the hidden in chunks of HC = 48 columns:
//   fc1 of a chunk is 15 wgmma k-steps of N = 48 with A (h) from shared
//   memory by descriptor: h lies in 64-channel sub-planes of 128-byte rows
//   with TMA's 128B swizzle, so a k-step is the descriptor of its
//   sub-plane plus 32 bytes a step; the epilogue adds b1, applies GELU
//   (one ex2 and 17 f32 operations, gelu_erf) and rounds once to bf16;
//   fc2's part of the chunk is 3 wgmma k-steps of N = 240 with A from
//   those registers (the accumulator layout of n8 blocks 2k, 2k + 1 is the
//   A fragment of k-step k), summed over the chunks in 120 f32 registers.
//   The consumers keep two chunks' fc1 sums (acc1[2]): while GELU works on
//   chunk g, fc1 of g + 1 runs on the tensor cores, and fc2(g) and fc1(g +
//   2) are issued behind it. Each wait names its commit groups by template
//   arguments, with the first step and the last three peeled, so ptxas
//   inserts no wait of its own (C7517) in the loop. The GELU epilogue
//   (about 20 f32 issue slots a hidden value) is what bounds the kernel
//   now: the issue of a step's products returns only as the tensor cores
//   take them, so little of them is left to overlap the next GELU; the
//   warpgroups taking turns to issue (hopper.cuh's turn_wait / turn_pass)
//   measured slower (PERF.md, the K10 findings).
//   The weights (230 KB each a layer, L2-resident over the launch) are
//   packed at load as wgmma k16 slices (ops/swin_kernel.py::pack_mlp) and
//   streamed per chunk, W1's and W2's part one ring slot each, by one
//   producer thread with cp.async.bulk through four 23 KB slots: the
//   weights are read from L2 once per 128 tokens.
//   Three producer warps load the next tile's h by cp.async (zeros past
//   the last token) into the second of two 64 KB buffers. A tile's output
//   (+ b2, bf16) is staged over its h and leaves as one bulk copy a
//   warpgroup: the tile's rows are contiguous in m.

#include "hopper.cuh"

namespace {

constexpr int kWin = 8;       // window side
constexpr int kTok = 64;      // tokens of a window
constexpr int kHeadsBlk = 4;  // heads a block
constexpr int kAttnThreads = 128; // one warp a head

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
__global__ void __launch_bounds__(kAttnThreads, 4)
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

  for (int i = tid; i < kTok * 3 * CH; i += kAttnThreads) {
    const int t = i / (3 * CH), r = i % (3 * CH), seg = r / CH, ch = r % CH;
    cp_async16(sm + t * ROW + seg * GC + ch * 8, qkv + pixel(t) * (3 * C) + seg * C + grp * GC + ch * 8);
  }
  for (int i = tid; i < kTok * 2; i += kAttnThreads)  // the pad columns: finite for the padded dims' reads
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
  for (int i = tid; i < kTok * CH; i += kAttnThreads) {
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
  window_attn_kernel<HEADS, HD><<<unsigned(blocks), kAttnThreads, 0, s>>>(
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


// ---------------------------------------------------------------------------
// K10 swin_mlp: m = fc2(GELU(h W1^T + b1)) + b2 for a Swin layer's tokens
// ---------------------------------------------------------------------------

// d[m64 x N] (+)= A[m64 x k16] (shared memory, descriptor) * B[k16 x N]
// (descriptor), f32 sums; scale_d 0 starts the sum
template <int N>
struct WgmmaSS;

// d[m64 x N] (+)= A[m64 x k16] (registers) * B[k16 x N] (descriptor)
template <int N>
struct WgmmaRS;

template <>
struct WgmmaSS<48> {
  static __device__ __forceinline__ void run(float (&d)[24], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "%24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<240> {
  static __device__ __forceinline__ void run(float (&d)[120], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %125, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n240k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119}, "
        "{%120, %121, %122, %123}, %124, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// Matrix descriptor of A (64 rows x k16) in a K-major plane of 128-byte rows
// with TMA's 128B swizzle (hopper.cuh::chunk_offset<64>), 8-row groups 1,024
// bytes apart, at `addr` (the plane's 1,024-byte aligned base plus the
// k-step's 32-byte offset inside the row: the swizzle is applied to the
// address bits, so the offset selects the k-step's chunks of every row)
__device__ __forceinline__ uint64_t a_desc_sw128(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

template <int R>
__device__ __forceinline__ void fence_u32(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// GELU with the exact erf, nn.GELU()'s default, in f32: GELU(x) = x Phi(x) =
// relu(x) - u Q(u), u = |x|, Q the normal upper tail. Q(u) = exp(-u^2 / 2)
// P(u), P a polynomial of degree 10 in v = min(u, 4.5) / 2.25 - 1, fitted
// to Q(u) exp(u^2 / 2) (the normal's Mills ratio over sqrt(2 pi)) on
// [0, 4.5]: |error| / |GELU(x)| < 6e-6 for |x| <= 4.5, |error| < 1e-6
// beyond (u Q(u) < 2e-5 there); bf16 rounding of the result is 2e-3. One
// ex2 and 17 f32 operations, no branch. (tests/test_torch_swinir.py reads
// the coefficients from this source and checks these bounds on the CPU.)
__device__ __forceinline__ float gelu_erf(float x) {
  const float u = fabsf(x);
  const float v = fmaf(fminf(u, 4.5f), 2.f / 4.5f, -1.f);
  float p = 0.0014129403280094266f;
  p = fmaf(p, v, -0.0034135214518755674f);
  p = fmaf(p, v, 0.003237348748371005f);
  p = fmaf(p, v, -0.004969682544469833f);
  p = fmaf(p, v, 0.012174286879599094f);
  p = fmaf(p, v, -0.02226654253900051f);
  p = fmaf(p, v, 0.03614242747426033f);
  p = fmaf(p, v, -0.05718439444899559f);
  p = fmaf(p, v, 0.08578132092952728f);
  p = fmaf(p, v, -0.11976279318332672f);
  p = fmaf(p, v, 0.15365225076675415f);
  const float e = ex2_approx(x * (x * -0.72134752044448170f));  // exp(-x^2 / 2)
  return fmaf(-(u * p), e, fmaxf(x, 0.f));
}

__device__ __forceinline__ float2 bf16x2_at(const __nv_bfloat16* p) {
  return unpack_bf16(__ldg(reinterpret_cast<const unsigned int*>(p)));
}

namespace mlp {

constexpr int kC = 240;                // the layer's width
constexpr int kHidden = 480;           // mlp_ratio 2
constexpr int kRows = 128;             // tokens a tile: 64 a consumer warpgroup
constexpr int kSteps1 = kC / 16;       // fc1's k16 steps: 15
constexpr int kSlice2 = kC * 32;       // fc2's k16 slice of N = 240: 7,680 bytes
constexpr int kSub = 64 * 128;         // 64 rows of a 64-channel sub-plane: 8 KB
constexpr int kHalf = 4 * kSub;        // a warpgroup's h: 4 sub-planes (the last with 48 channels)
constexpr int kTile = 2 * kHalf;       // a tile's h: 64 KB
constexpr int kBufs = 2;               // h buffers: the next tile lands while this one is read
constexpr int kChunks = kC / 8;        // 16-byte chunks of a token: 30
constexpr int kLoaders = 96;           // producer threads that load h
constexpr int kSmem = 232448;          // shared memory of one block

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The hidden is taken HC columns at a time (a chunk): fc1 of the chunk (15
// k-steps of N = HC), then its part of fc2 (HC / 16 k-steps of N = 240).
// Both operands of a chunk are HC x 480 bytes, one slot of the ring each.
template <int HC>
struct Plan {
  static_assert(kHidden % HC == 0 && HC % 16 == 0, "whole k-steps of fc2");
  static_assert(kHidden / HC % 2 == 0, "an even number of chunks: the walk takes them in pairs");
  static constexpr int CHUNKS = kHidden / HC;
  static constexpr int SLICE1 = HC * 32;             // fc1's k16 slice of N = HC
  static constexpr int S2 = HC / 16;                 // fc2's k-steps a chunk
  static constexpr int SLOT = kSteps1 * SLICE1;      // = S2 * kSlice2
  static constexpr int RING = kBufs * kTile;         // after the h buffers
  static constexpr int SLOTS = (kSmem - 1024 - RING - 256) / SLOT;
  static constexpr int BARS = RING + SLOTS * SLOT;
  static constexpr int BYTES = BARS + 8 * (2 * SLOTS + 2 * kBufs) + 1024;  // + the base's alignment
  // in flight on a warpgroup: fc1 of the next chunk, fc2 of this one and
  // fc1 of the one after; the producer fills the rest
  static_assert(SLOTS >= 4 && BYTES <= kSmem, "the pieces in flight fit the ring");
};

struct Params {
  const __nv_bfloat16* h;   // [n, 240]
  const char* w1;           // fc1: per chunk its 15 k16 slices of N = HC, wgmma order
  const __nv_bfloat16* b1;  // [480]
  const char* w2;           // fc2: per chunk its HC / 16 k16 slices of N = 240
  const __nv_bfloat16* b2;  // [240]
  __nv_bfloat16* out;       // [n, 240]
  int n, tiles;
};

// The ring as a consumer or the producer walks it: s counts the pieces.
struct Ring {
  uint32_t base, full, empty;
  int s;
};

// One operand of one chunk, as the producer streams it: wait for the slot
// to be free, then one bulk copy that completes on its barrier.
template <class P>
__device__ __forceinline__ void produce(Ring& r, const char* src) {
  const int slot = r.s % P::SLOTS;
  if (r.s >= P::SLOTS) mbar_wait(r.empty + 8 * slot, ((r.s / P::SLOTS) - 1) & 1);
  mbar_expect_tx(r.full + 8 * slot, P::SLOT);
  bulk_copy(r.base + slot * P::SLOT, src, P::SLOT, r.full + 8 * slot);
  ++r.s;
}

// fc1 of a chunk for this warpgroup's 64 rows: acc = h . W1_j^T (h the A
// operand from its swizzled sub-planes at `hb`), one commit group
template <class P, int HC>
__device__ __forceinline__ void issue_fc1(Ring& r, float (&acc)[HC / 2], uint32_t hb) {
  const int slot = r.s % P::SLOTS;
  mbar_wait(r.full + 8 * slot, (r.s / P::SLOTS) & 1);
  wg_fence();
  const uint64_t b = b_desc(r.base + slot * P::SLOT);
#pragma unroll
  for (int step = 0; step < kSteps1; ++step)
    WgmmaSS<HC>::run(acc, a_desc_sw128(hb + (step / 4) * kSub + (step % 4) * 32), b + step * (P::SLICE1 / 16),
                     step > 0);
  wg_commit();
  ++r.s;
}

// fc2's part of a chunk: acc += GELU'd hidden (registers) . W2_j^T; `first`
// starts the sum (the tile's first chunk)
template <class P>
__device__ __forceinline__ void issue_fc2(Ring& r, float (&acc)[kC / 2], const uint32_t (&a)[P::S2][4],
                                          bool first) {
  const int slot = r.s % P::SLOTS;
  mbar_wait(r.full + 8 * slot, (r.s / P::SLOTS) & 1);
  wg_fence();
  const uint64_t b = b_desc(r.base + slot * P::SLOT);
#pragma unroll
  for (int kk = 0; kk < P::S2; ++kk) WgmmaRS<kC>::run(acc, a[kk], b + kk * (kSlice2 / 16), !(first && kk == 0));
  wg_commit();
  ++r.s;
}

// Wait for the oldest N of the N + REST commit groups in flight, one at a
// time, freeing each one's slot as it completes (lane 0 of each warp).
template <class P, int N, int REST>
__device__ __forceinline__ void drain(const Ring& r, int lane) {
  if constexpr (N > 0) {
    wg_wait<N - 1 + REST>();
    if (lane == 0) mbar_arrive(r.empty + 8 * ((r.s - N - REST) % P::SLOTS));
    drain<P, N - 1, REST>(r, lane);
  }
}

// fc1's sums of chunk j (+ b1), GELU, rounded once to bf16 as fc2's A
// fragments: n8 blocks 2kk and 2kk + 1 of the accumulator are k16 step kk
// (rows g and g + 8 of the warp, columns 2 tig, 2 tig + 1 of each block)
template <int HC>
__device__ __forceinline__ void gelu_a(const float (&acc)[HC / 2], uint32_t (&a)[HC / 16][4],
                                       const __nv_bfloat16* b1, int tig) {
#pragma unroll
  for (int kk = 0; kk < HC / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 b = bf16x2_at(b1 + (2 * kk + h) * 8 + 2 * tig);
      const int i = 8 * kk + 4 * h;
      a[kk][2 * h] = pack_bf16x2(gelu_erf(acc[i] + b.x), gelu_erf(acc[i + 1] + b.y));
      a[kk][2 * h + 1] = pack_bf16x2(gelu_erf(acc[i + 2] + b.x), gelu_erf(acc[i + 3] + b.y));
    }
  }
}

// + b2, bf16, into this warpgroup's 64 output rows at `stage` (row-major,
// 480 bytes a row, over its h sub-planes, no longer read), then one bulk
// copy of the rows that exist to the output: the output rows of a tile are
// contiguous, so the warpgroup's store is one 30 KB write that runs while
// the tensor cores go on. The issuing thread (warp 0, lane 0) waits until
// the copy has read shared memory before the buffer is handed back.
__device__ __forceinline__ void store_m(const Params& p, const float (&acc)[kC / 2], unsigned char* stage,
                                        int row0, int wg, int warp, int lane) {
  const int r = warp * 16 + lane / 4, tig = lane % 4;
#pragma unroll
  for (int i = 0; i < kC / 8; ++i) {
    const int col = 8 * i + 2 * tig;
    const float2 b = bf16x2_at(p.b2 + col);
    *reinterpret_cast<uint32_t*>(stage + r * (kC * 2) + col * 2) = pack_bf16x2(acc[4 * i] + b.x, acc[4 * i + 1] + b.y);
    *reinterpret_cast<uint32_t*>(stage + (r + 8) * (kC * 2) + col * 2) =
        pack_bf16x2(acc[4 * i + 2] + b.x, acc[4 * i + 3] + b.y);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(4 + wg) : "memory");  // this warpgroup's rows are all in
  const int rows = cmin(cmax(p.n - row0, 0), 64);
  if (warp == 0 && lane == 0 && rows > 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(p.out + size_t(row0) * kC),
                 "r"(smem_u32(stage)), "r"(rows * kC * 2)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// A tile's h into buffer `dst` by the loader threads (tid 0 .. kLoaders -
// 1): cp.async of 16-byte chunks into the warpgroups' 128B-swizzled
// sub-planes, zeros past the last token; `full` counts each thread once its
// copies landed.
__device__ __forceinline__ void load_h(const Params& p, int tile, uint32_t dst, uint32_t full, int tid) {
#pragma unroll 1  // unrolled, the copies spill in the producer's 40 registers
  for (int idx = tid; idx < kRows * kChunks; idx += kLoaders) {
    const int row = idx / kChunks, ch = idx % kChunks, r = row & 63;
    const int grow = tile * kRows + row;
    const bool in = grow < p.n;
    cp_async_16(dst + (row >> 6) * kHalf + (ch >> 3) * kSub + chunk_offset<64>(r, ch & 7),
                p.h + size_t(in ? grow : 0) * kC + ch * 8, in);
  }
  cp_async_arrive(full);
}

// One consumer warpgroup's state on its walk over the chunks g = 0 .. G - 1
// of its block's tiles (tile g / CHUNKS, chunk g % CHUNKS).
template <int HC>
struct Walk {
  using P = Plan<HC>;
  const Params& p;
  unsigned char* base;  // the block's shared memory (1,024-byte aligned)
  uint32_t smem, h_full, h_empty;
  Ring r;
  int G, wg, warp, lane;
  float acc1[2][HC / 2];  // fc1's sums, two chunks in flight
  float acc2[kC / 2];     // fc2's sums of the tile
  uint32_t a[P::S2][4];   // the GELU'd hidden of a chunk: fc2's A

  __device__ __forceinline__ int tile(int g) const { return int(blockIdx.x) + (g / P::CHUNKS) * int(gridDim.x); }
  __device__ __forceinline__ uint32_t h_of(int g) const {
    return smem + ((g / P::CHUNKS) % kBufs) * kTile + wg * kHalf;
  }

  // fc1 of chunk g into acc1[B], once its tile's h has landed
  template <int B>
  __device__ __forceinline__ void fc1(int g) {
    const int k = g / P::CHUNKS;
    if (g % P::CHUNKS == 0) {
      mbar_wait(h_full + 8 * (k % kBufs), (k / kBufs) & 1);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // cp.async's writes, to wgmma's reads
    }
    issue_fc1<P, HC>(r, acc1[B], h_of(g));
  }

  // Chunk g, fc1's sums in acc1[B]: in flight are the DONE + LEFT commit
  // groups fc1(g), fc2(g - 1) (not at g = 0) and fc1(g + 1) (not at the
  // last chunk), in that order. Wait for the first DONE; store the last
  // tile's output after its last fc2; GELU while fc1(g + 1) runs; then
  // issue fc2(g) and, where NEXT, fc1(g + 2) into acc1[B]. The counts are
  // template arguments, so that ptxas sees which products each wait has
  // finished and inserts no wait of its own.
  template <int B, int DONE, int LEFT, bool NEXT>
  __device__ __forceinline__ void step(int g) {
    const int j = g % P::CHUNKS;
    drain<P, DONE, LEFT>(r, lane);
    fence_regs(acc1[B]);
    fence_regs(acc2);
    fence_u32(a);
    if (j == 0 && g > 0) finish(g - 1);
    gelu_a<HC>(acc1[B], a, p.b1 + j * HC, lane % 4);
    issue_fc2<P>(r, acc2, a, j == 0);
    if constexpr (NEXT) fc1<B>(g + 2);
  }

  // the output of chunk g's tile (its last fc2 done): staged over its h,
  // which then goes back to the loaders
  __device__ __forceinline__ void finish(int g) {
    const int k = g / P::CHUNKS, row0 = tile(g) * kRows + wg * 64;
    store_m(p, acc2, base + (k % kBufs) * kTile + wg * kHalf, row0, wg, warp, lane);
    if (warp == 0 && lane == 0) mbar_arrive(h_empty + 8 * (k % kBufs));
  }
};

}  // namespace mlp

// Grid: min(tiles, SMs) persistent blocks; block i takes the 128-token tiles
// i, i + gridDim.x, ...
template <int HC>
__global__ void __launch_bounds__(kThreads, 1) swin_mlp_kernel(const mlp::Params p) {
  using namespace mlp;
  using P = Plan<HC>;
  extern __shared__ __align__(1024) unsigned char mlp_smem[];
  const uint32_t raw = smem_u32(mlp_smem), smem = (raw + 1023) & ~1023u;  // the swizzle's 1,024-byte pattern
  unsigned char* base = mlp_smem + (smem - raw);
  const uint32_t full = smem + P::BARS, empty = full + 8 * P::SLOTS;
  const uint32_t h_full = empty + 8 * P::SLOTS, h_empty = h_full + 8 * kBufs;
  const int mine = p.tiles > int(blockIdx.x) ? (p.tiles - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x) : 0;
  const int G = mine * P::CHUNKS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < P::SLOTS; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers * 4);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < kBufs; ++i) {
      mbar_init(h_full + 8 * i, kLoaders);
      mbar_init(h_empty + 8 * i, kConsumers);  // each warpgroup once its output left the buffer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    setmaxnreg_producer();
    const int tid = threadIdx.x - kConsumers * 128;
    if (tid == 0) {
      // the weights in the order the consumers issue them: fc1 of chunks 0
      // and 1, then per chunk g fc2(g) and fc1(g + 2)
      Ring r{smem + P::RING, full, empty, 0};
      for (int g = 0; g < 2 && g < G; ++g) produce<P>(r, p.w1 + size_t(g % P::CHUNKS) * P::SLOT);
      for (int g = 0; g < G; ++g) {
        produce<P>(r, p.w2 + size_t(g % P::CHUNKS) * P::SLOT);
        if (g + 2 < G) produce<P>(r, p.w1 + size_t((g + 2) % P::CHUNKS) * P::SLOT);
      }
    } else if (tid >= 32) {
      // tile k's h into buffer k % kBufs once the consumers are done with
      // the tile that used it before
      for (int k = 0; k < mine; ++k) {
        const int j = k % kBufs, u = k / kBufs;
        if (u > 0) mbar_wait(h_empty + 8 * j, (u - 1) & 1);
        load_h(p, int(blockIdx.x) + k * int(gridDim.x), smem + j * kTile, h_full + 8 * j, tid - 32);
      }
    }
    return;
  }
  setmaxnreg_consumer();
  if (mine == 0) return;

  // chunks in pairs, so that each step's fc1 buffer is known at compile
  // time; the first step and the last three peeled (G is even), so that the
  // loop issues and waits alike every time round
  Walk<HC> w{p, base, smem, h_full, h_empty, Ring{smem + P::RING, full, empty, 0}, G, int(threadIdx.x) / 128,
             int(threadIdx.x / 32) % 4, int(threadIdx.x % 32)};
  w.template fc1<0>(0);
  w.template fc1<1>(1);
  w.template step<0, 1, 1, true>(0);
  int g = 1;
#pragma unroll 1
  for (; g + 3 < G; g += 2) {
    w.template step<1, 2, 1, true>(g);
    w.template step<0, 2, 1, true>(g + 1);
  }
  w.template step<1, 2, 1, true>(g);
  w.template step<0, 2, 1, false>(g + 1);
  w.template step<1, 2, 0, false>(g + 2);
  drain<P, 1, 0>(w.r, w.lane);
  fence_regs(w.acc2);
  w.finish(G - 1);
}

struct MlpArgs {
  const void *h, *w1, *b1, *w2, *b2;
  void* out;
  int n;
};

template <int HC>
int launch_swin_mlp(const MlpArgs& a, int sms, cudaStream_t s) {
  using P = mlp::Plan<HC>;
  const cudaError_t err =
      cudaFuncSetAttribute(swin_mlp_kernel<HC>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return int(err);
  const mlp::Params p{static_cast<const __nv_bfloat16*>(a.h), static_cast<const char*>(a.w1),
                      static_cast<const __nv_bfloat16*>(a.b1), static_cast<const char*>(a.w2),
                      static_cast<const __nv_bfloat16*>(a.b2), static_cast<__nv_bfloat16*>(a.out), a.n,
                      mlp::cdiv(a.n, mlp::kRows)};
  swin_mlp_kernel<HC><<<mlp::cmin(p.tiles, sms), kThreads, P::BYTES, s>>>(p);
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

// K10 over n tokens of width C with a hidden of `hidden` (mlp_ratio 2): h
// [n, C] bf16, w1 / w2 fc1's and fc2's weights packed for a hidden chunk
// of `hc` (ops/swin_kernel.py::pack_mlp), b1 [hidden] and b2 [C] bf16, out
// [n, C] bf16; sms: the persistent blocks at most. Returns the cudaError_t
// of the launch.
int swin_mlp_launch(const void* h, const void* w1, const void* b1, const void* w2, const void* b2, void* out, int n,
                    int C, int hidden, int hc, int sms, void* stream) {
  if (n < 1 || sms < 1) return int(cudaErrorInvalidValue);
  const MlpArgs a{h, w1, b1, w2, b2, out, n};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 240 && hidden == 480 && hc == 48) return launch_swin_mlp<48>(a, sms, s);
  return int(cudaErrorInvalidValue);
}

const char* swin_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
