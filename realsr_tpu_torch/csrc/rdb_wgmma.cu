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
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

struct Params {
  const void* x;                 // the state [B, H, W, NF] (f32 or bf16), read at the centre
  const void* u;                 // the RRDB entry state, or nullptr (no residual)
  void* out;                     // the new state
  __nv_bfloat16* shadow;         // bf16(out) for the next RDB's window, or nullptr
  const __nv_bfloat16* w;        // k16 slices in wgmma order, stage by stage
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

// Stage R's GEMM for one warpgroup. The region's 64-pixel m-tiles alternate
// between the two warpgroups (tiles wg, wg + 2, ...: MF each); where their
// number is odd, both take the last one, each with half of the N columns,
// so that both run this one code path with the same counts and no product
// is wasted (ptxas serializes the wgmma pipeline of two paths with different
// counts, and of a product skipped on a runtime condition).
template <int T, int NF, int GC, int R>
struct Gemm {
  static constexpr int S = side<T>(R), P = S * S;
  static constexpr int N = R < 5 ? GC : NF, NR = N / 2;
  static constexpr int TILES = (P + 63) / 64;
  static constexpr int MF = TILES / 2;  // whole tiles of each warpgroup
  static constexpr int MH = TILES % 2;  // the shared half tile
  static constexpr int MA = MF + MH;    // A fragments per k-step
  using L = Layout<T, NF, GC>;

  Consumer& c;
  const int wg;
  float acc[MF > 0 ? MF : 1][NR];
  float half[NR / 2];  // the shared tile, columns wg * N / 2 ...
  int ry[MA], rx[MA];  // the pixel whose row this lane addresses for ldmatrix
  int src = 0, tap = 0, kb = 0;  // the next step's source, tap and 16-channel block

  __device__ __forceinline__ Gemm(Consumer& c_, const float* __restrict__ bias, int wg_) : c(c_), wg(wg_) {
    const int tig = c.lane % 4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float b0 = bias[j * 8 + tig * 2], b1 = bias[j * 8 + tig * 2 + 1];
#pragma unroll
      for (int m = 0; m < MF; ++m) {
        acc[m][4 * j] = b0; acc[m][4 * j + 1] = b1; acc[m][4 * j + 2] = b0; acc[m][4 * j + 3] = b1;
      }
    }
    if constexpr (MH > 0) {
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        const float* bh = bias + wg * (N / 2) + j * 8 + tig * 2;
        half[4 * j] = bh[0]; half[4 * j + 1] = bh[1]; half[4 * j + 2] = bh[0]; half[4 * j + 3] = bh[1];
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

  static constexpr int KC = kChunk * NF / N;  // k16 steps of a full chunk
  static constexpr int STEPS = stage_steps<NF, GC>(R);
  uint32_t a[KC][MA][4];

  // A of the next k16 step into a[k]
  __device__ __forceinline__ void gather(int k) {
    const int off = R - 1 - src, dy = tap / 3 + off, dx = tap % 3 + off;
    const int chunk = 2 * kb + (c.lane >> 4);
    if (src == 0) {
      constexpr int S0 = side<T>(0);
#pragma unroll
      for (int m = 0; m < MA; ++m)
        ldmatrix_x4(c.smem + chunk_offset<NF>((ry[m] + dy) * S0 + rx[m] + dx, chunk), a[k][m]);
    } else {
      const int Sj = T + 2 * kHalo - 2 * src;
      const uint32_t plane = c.smem + (src == 1   ? L::plane(1)
                                       : src == 2 ? L::plane(2)
                                       : src == 3 ? L::plane(3)
                                                  : L::plane(4));
#pragma unroll
      for (int m = 0; m < MA; ++m)
        ldmatrix_x4(plane + chunk_offset<GC>((ry[m] + dy) * Sj + rx[m] + dx, chunk), a[k][m]);
    }
    if (++kb == (src == 0 ? NF : GC) / 16) {
      kb = 0;
      if (++tap == 9) { tap = 0; ++src; }
    }
  }

  // A chunk of K k16 steps: wait for its weights, gather all its A, issue
  // its products behind one fence in this warpgroup's turn, and free its slot
  // once they are done. A k16 slice is N x 32 bytes, 8-column groups are 256
  // bytes apart, 16 bytes per descriptor unit.
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
#pragma unroll
      for (int m = 0; m < MF; ++m) Wgmma<N>::run(acc[m], a[k][m], desc + k * 2 * N);
      if constexpr (MH > 0) Wgmma<N / 2>::run(half, a[k][MF], desc + k * 2 * N + wg * N);
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

// Stage R: epi(tile, accumulators, first column) takes each of this
// warpgroup's tiles.
template <int T, int NF, int GC, int R, typename Epi>
__device__ __forceinline__ void stage(Consumer& c, const float* __restrict__ bias, int wg, const Epi& epi) {
  using G = Gemm<T, NF, GC, R>;
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

// c_I over region I from the accumulators of one m-tile (columns col0 ...):
// lrelu'd bf16 into plane I, zero outside the image (every conv's zero
// padding)
template <int T, int NF, int GC, int I>
struct CEpi {
  const Patch& t;
  template <int NR>
  __device__ __forceinline__ void operator()(int tile, const float (&acc)[NR], int col0) const {
    constexpr int S = side<T>(I);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tile * 64 + t.warp * 16 + t.gid + 8 * h;
      if (q >= S * S) continue;
      const int ty = t.py0 - kHalo + I + q / S, tx = t.px0 - kHalo + I + q % S;
      const bool in = ty >= 0 && ty < t.H && tx >= 0 && tx < t.W;
#pragma unroll
      for (int j = 0; j < NR / 4; ++j)
        *reinterpret_cast<uint32_t*>(t.base + Layout<T, NF, GC>::plane(I) +
                                     chunk_offset<GC>(q, col0 / 8 + j) + t.tig * 4) =
            in ? pack_bf16x2(lrelu(acc[4 * j + 2 * h]), lrelu(acc[4 * j + 2 * h + 1])) : 0u;
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

// The producer: the window by TMA, then every weight slice in the order the
// stages consume them, through the ring.
template <int T, typename TS, int NF, int GC>
__device__ __forceinline__ void produce(const CUtensorMap* window, const Params& p, uint32_t smem,
                                        uint32_t full, uint32_t empty, uint32_t win_bar, int px0,
                                        int py0, int b) {
  using L = Layout<T, NF, GC>;
  constexpr int S0 = side<T>(0);
  mbar_expect_tx(win_bar, S0 * S0 * NF * 2);
  tma_load_4d(smem, window, win_bar, 0, px0 - kHalo, py0 - kHalo, b);
  // the epilogue's rows of the state and of u, into L2 while the stages run
  const int rows = min(T, p.H - py0), row_bytes = min(T, p.W - px0) * NF * int(sizeof(TS));
  for (int y = 0; y < rows; ++y) {
    const size_t o = ((size_t(b) * p.H + py0 + y) * p.W + px0) * NF;
    prefetch_l2(static_cast<const TS*>(p.x) + o, row_bytes);
    if (p.u != nullptr) prefetch_l2(static_cast<const TS*>(p.u) + o, row_bytes);
  }
  const char* src = reinterpret_cast<const char*>(p.w);
  int s = 0;
#pragma unroll 1
  for (int r = 1; r <= 5; ++r) {
    const int stage_bytes = stage_steps<NF, GC>(r) * (r < 5 ? GC : NF) * 32;
#pragma unroll 1
    for (int done = 0; done < stage_bytes; done += L::slot, ++s) {
      const int slot = s % kSlots, bytes = min(L::slot, stage_bytes - done);
      if (s >= kSlots) mbar_wait(empty + 8 * slot, ((s / kSlots) - 1) & 1);
      mbar_expect_tx(full + 8 * slot, bytes);
      bulk_copy(smem + L::ring + slot * L::slot, src + done, bytes, full + 8 * slot);
    }
    src += stage_bytes;
  }
}

// Grid: (T x T patches of one tile, B).
template <int T, typename TS, int NF, int GC>
__global__ void __launch_bounds__(kThreads, 1)
    rdb_kernel(const __grid_constant__ CUtensorMap window, const Params p) {
  using L = Layout<T, NF, GC>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t smem = (raw + 1023u) & ~1023u;
  unsigned char* const base = smem_raw + (smem - raw);
  const uint32_t full = smem + L::bars, empty = full + 8 * kSlots, win_bar = empty + 8 * kSlots;
  const int b = blockIdx.y, H = p.H, W = p.W;
  const int py0 = (blockIdx.x / p.patches_x) * T, px0 = (blockIdx.x % p.patches_x) * T;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers * 4);  // lane 0 of each consumer warp
    }
    mbar_init(win_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    setmaxnreg_producer();
    if (threadIdx.x == kConsumers * 128)
      produce<T, TS, NF, GC>(&window, p, smem, full, empty, win_bar, px0, py0, b);
    return;
  }
  setmaxnreg_consumer();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  Consumer c{smem, full, empty, 0, warp, lane};
  const Patch t{base, b, py0, px0, H, W, warp, lane / 4, lane % 4};
  const float* bias = p.bias;

  mbar_wait(win_bar, 0);
  if (wg == 1) turn_pass(wg);  // the first turn is warpgroup 0's
  stage<T, NF, GC, 1>(c, bias, wg, CEpi<T, NF, GC, 1>{t});
  consumers_sync();
  stage<T, NF, GC, 2>(c, bias + GC, wg, CEpi<T, NF, GC, 2>{t});
  consumers_sync();
  stage<T, NF, GC, 3>(c, bias + 2 * GC, wg, CEpi<T, NF, GC, 3>{t});
  consumers_sync();
  stage<T, NF, GC, 4>(c, bias + 3 * GC, wg, CEpi<T, NF, GC, 4>{t});
  consumers_sync();
  stage<T, NF, GC, 5>(c, bias + 4 * GC, wg,
                      OutEpi<T, TS, NF>{t, static_cast<const TS*>(p.x), static_cast<const TS*>(p.u),
                                        static_cast<TS*>(p.out), p.shadow});
}

// ---------------------------------------------------------------------------
// Host side: the window's tensor map, cached; launch
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
  int B, H, W, nf, tile;
  CUtensorMap map;
};
constexpr int kMapCache = 16;
MapEntry g_maps[kMapCache];
int g_maps_next = 0;
std::mutex g_maps_lock;

// The window map of a [B, H, W, nf] bf16 plane: boxes of [1, T+10, T+10, nf]
// in the planes' swizzle, zero outside the tensor. Returns a cudaError_t.
int window_map(const void* xs, int B, int H, int W, int nf, int tile, CUtensorMap* map) {
  std::lock_guard<std::mutex> guard(g_maps_lock);
  for (const MapEntry& e : g_maps) {
    if (e.ptr == xs && e.B == B && e.H == H && e.W == W && e.nf == nf && e.tile == tile) {
      *map = e.map;
      return 0;
    }
  }
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  const int S0 = tile + 2 * kHalo;
  const cuuint64_t dims[4] = {cuuint64_t(nf), cuuint64_t(W), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(nf) * 2, cuuint64_t(W) * nf * 2, cuuint64_t(H) * W * nf * 2};
  const cuuint32_t box[4] = {cuuint32_t(nf), cuuint32_t(S0), cuuint32_t(S0), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  MapEntry& e = g_maps[g_maps_next];
  const CUresult r = encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(xs), dims, strides,
                            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            nf == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    e.ptr = nullptr;
    return int(cudaErrorInvalidValue);
  }
  e.ptr = xs; e.B = B; e.H = H; e.W = W; e.nf = nf; e.tile = tile;
  *map = e.map;
  g_maps_next = (g_maps_next + 1) % kMapCache;
  return 0;
}

template <int T, typename TS, int NF, int GC>
int launch(const CUtensorMap& map, Params p, int B, cudaStream_t stream) {
  constexpr int smem = Layout<T, NF, GC>::bytes;
  static_assert(smem <= 232448, "shared memory of one block");
  const cudaError_t err =
      cudaFuncSetAttribute(rdb_kernel<T, TS, NF, GC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  p.patches_x = (p.W + T - 1) / T;
  const int patches_y = (p.H + T - 1) / T;
  rdb_kernel<T, TS, NF, GC><<<dim3(p.patches_x * patches_y, B), kThreads, smem, stream>>>(map, p);
  return int(cudaGetLastError());
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
  if (nf == 64 && gc == 32) return launch_tile<TS, 64, 32>(map, p, B, tile, s);
  if (nf == 32 && gc == 16) return launch_tile<TS, 32, 16>(map, p, B, tile, s);
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
  return state_bf16 ? launch_shape<__nv_bfloat16>(map, p, B, nf, gc, tile, s)
                    : launch_shape<float>(map, p, B, nf, gc, tile, s);
}

const char* rdb_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
