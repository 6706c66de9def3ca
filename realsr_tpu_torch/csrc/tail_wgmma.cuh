// The fused packed-phase tail on wgmma in its two forms (K6: up1 + up2 +
// HRconv + conv_last from the long skip's sum; K7: HRconv + conv_last), for
// either operand type: bf16 (instances in tail_kernel.cu, whose header
// describes the design) or float32 with the split 3xTF32 product
// (tail_tf32.cu). The operand type OP sets the planes' bytes (bf16: 128-byte
// pixels; float32: two 32-channel sub-planes of 128-byte pixels, hopper.cuh::
// chunk_offset_f32), the k-step (k16, or k8 with A split into tf32 hi and lo
// in registers and B as the hi and lo slices of pack_tail_params' "w0t" /
// "w2t" / "w1t" / "w9t") and so each stage's chunk length (Plan::KC); the
// stages, the ring, the persistent walk over patches and the window's
// prefetch are one code.

#pragma once

#include "hopper.cuh"

namespace {

constexpr int kNF = 64;
constexpr int kOut = 3;
constexpr int kW9 = 32;        // conv_last's W9 columns: 9 taps x 3 outputs, padded
// registers a stage's accumulators and one chunk's A fragments may take per
// thread: more makes ptxas spill and serialize the wgmmas (C7512)
constexpr int kAccA = 192;
constexpr int kLoaders = 96;   // producer threads that load the windows

// The kernel's forms (FORM), by its input and the stages before HRconv
constexpr int kK7 = 0;  // P2, the sixteen 4x phases [B, H, W, 16 * 64]
constexpr int kK6 = 1;  // fea, the long skip's sum [B, H, W, 64]: up1, then up2

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Bytes of a 64-channel plane of P pixels of OP: bf16 128-byte pixels;
// float32 two sub-planes of 32 channels, each padded to 1,024 bytes
template <typename OP>
__host__ __device__ constexpr int plane_bytes(int P) {
  return sizeof(OP) == 2 ? P * 128 : 2 * sub_plane_bytes(P);
}

// Byte offset of (pixel, 16-byte chunk) in a 64-channel plane of P pixels
template <typename OP, int P>
__device__ __forceinline__ uint32_t plane_offset(int pix, int chunk) {
  if constexpr (sizeof(OP) == 2) {
    return chunk_offset<kNF>(pix, chunk);
  } else {
    return chunk_offset_f32<kNF, P>(pix, chunk);
  }
}

// The regions of a TH x TW patch (TH, TW even: P2's sub-phases then follow
// the 4x image's parity). K6 computes the 2x window as up1's output y1 over
// YH x YW base pixels, each pixel the four phases (2x rows 2i - 1 and 2i,
// columns alike), from fea with up1's 2x2 taps, FH x FW pixels.
template <int TH, int TW>
struct Geo {
  static_assert(TH % 2 == 0 && TW % 2 == 0, "even patch sides");
  static constexpr int ZH = TH + 2, ZW = TW + 2, PZ = ZH * ZW;    // z: conv_last's halo
  static constexpr int PH = TH + 4, PW = TW + 4, PP = PH * PW;    // P2: HRconv's on top
  static constexpr int QH = PH / 2, QW = PW / 2, PQ = QH * QW;    // one up2 sub-phase
  static constexpr int XH = QH + 2, XW = QW + 2, PX = XH * XW;    // the 2x window
  static constexpr int YH = XH / 2 + 1, YW = XW / 2 + 1, PY = YH * YW;  // y1 over it
  static constexpr int FH = YH + 1, FW = YW + 1, PF = FH * FW;    // fea under y1
  static constexpr int ZT = (PZ + 63) / 64, UT = (PQ + 63) / 64, YT = (PY + 63) / 64;  // 64-row tiles
};

// K6: the fea window, the 2x window, z, P2, a ring of two 32 KB slots. K7: z
// and two P2 buffers (the window of the next patch lands in one while the
// consumers work in the other), two 16 KB slots. Planes of OP.
template <int TH, int TW, int FORM, typename OP>
struct Layout {
  using G = Geo<TH, TW>;
  static constexpr bool UP2 = FORM == kK6;
  static constexpr int bufs = UP2 ? 1 : 2;  // window buffers
  static constexpr int slots = 2;           // weight ring slots
  static constexpr int slot = UP2 ? 32768 : 16384;
  static constexpr int p2_bytes = plane_bytes<OP>(G::PP);
  static constexpr int x2 = UP2 ? plane_bytes<OP>(G::PF) : 0;  // the 2x window
  static constexpr int z = x2 + (UP2 ? plane_bytes<OP>(G::PX) : 0);
  static constexpr int p2 = z + plane_bytes<OP>(G::PZ);
  static constexpr int ring = p2 + bufs * p2_bytes;
  static constexpr int bars = ring + slots * slot;
  static constexpr int bytes = bars + 8 * (2 * slots + 2 * bufs);
  static_assert(G::PZ * kW9 * 4 <= p2_bytes, "T fits the P2 region");
  // window buffer j (K6: the fea window), and
  // the P2 region of a patch in buffer j
  __host__ __device__ static constexpr int win(int j) { return UP2 ? 0 : p2 + j * p2_bytes; }
  __host__ __device__ static constexpr int p2_of(int j) { return p2 + (UP2 ? 0 : j * p2_bytes); }
};

// A GEMM stage of one warpgroup: MF whole 64-row tiles and MH (0 or 1) half
// tile (N / 2 of the columns), N columns, STEPS k-steps whose B slices are
// SLICE bytes, taken KC steps a chunk (one ring slot of SLOT bytes, one
// wait, fence and commit; the accumulators and the chunk's A fragments, A
// registers per m-tile and step, within kAccA).
template <int MF_, int MH_, int N_, int STEPS_, int SLICE_, int SLOTS_, int SLOT_, int A_>
struct Plan {
  static constexpr int MF = MF_, MH = MH_, MA = MF_ + MH_, N = N_, STEPS = STEPS_, SLICE = SLICE_;
  static constexpr int SLOTS = SLOTS_, SLOT = SLOT_;  // the ring
  static constexpr int ACC = MF * N / 2 + MH * N / 4;
  static constexpr int KC = cmin(SLOT / SLICE, (kAccA - ACC) / (A_ * MA));
  static_assert(KC > 0, "the accumulators leave room for A");
};

// The stages' plans: up1 N = 256 slices (4 phases x 64, 128 columns each
// warpgroup), K = 4 taps x 64; up2 N = 128 slices (64 columns each
// warpgroup), K = 4 taps x 64; HRconv K = 576, N = 64; conv_last's W9
// product K = 64, N = 32. A k-step (OperandSteps) is k16 of one slice (bf16)
// or k8 of two (tf32 hi and lo).
template <int TH, int TW, int FORM, typename OP>
struct Plans {
  using G = Geo<TH, TW>;
  using OS = OperandSteps<OP>;
  static constexpr int S = Layout<TH, TW, FORM, OP>::slots, SB = Layout<TH, TW, FORM, OP>::slot;
  using Up1 = Plan<G::YT, 0, 128, 4 * kNF / OS::K, 256 * 32 * OS::SLICES, S, SB, OS::A>;
  using Up2 = Plan<G::UT, 0, 64, 4 * kNF / OS::K, 128 * 32 * OS::SLICES, S, SB, OS::A>;
  using Hr = Plan<G::ZT / 2, G::ZT % 2, 64, 9 * kNF / OS::K, 64 * 32 * OS::SLICES, S, SB, OS::A>;
  using Last = Plan<G::ZT / 2, G::ZT % 2, kW9, kNF / OS::K, kW9 * 32 * OS::SLICES, S, SB, OS::A>;
};

// Everything a consumer thread carries from stage to stage.
struct Consumer {
  uint32_t smem;   // the planes
  uint32_t ring;   // the weight ring
  uint32_t full;   // the ring's "landed" barriers (8 bytes each)
  uint32_t empty;  // the ring's "free" barriers
  int s;           // the next ring step
  int wg, warp, lane;
};

// One stage's GEMM for one warpgroup on a plane of PP pixels of OP. Row r of
// m-tile m gathers its A from `plane` at pixel pix0[m] + (tap / KS) * PITCH
// + tap % KS for tap = step / (64 / K) (K runs over taps, then K-channel
// blocks, as the weights were packed).
template <class P, int KS, int PITCH, typename OP, int PP>
struct Gemm {
  using OS = OperandSteps<OP>;
  static constexpr int SHIFT = OS::K == 16 ? 2 : 3;  // log2 of the k-steps per tap
  Consumer& c;
  const uint32_t plane;
  float acc[P::MF > 0 ? P::MF : 1][P::N / 2];
  float half[P::MH > 0 ? P::N / 4 : 1];  // the shared tile, columns wg * N / 2 ...
  int pix0[P::MA];
  uint32_t a[P::KC][P::MA][OS::A];

  // bias: per column, or nullptr for zeros; row(m): this lane's ldmatrix
  // pixel of m-tile m (m == MF: the shared tile)
  template <typename Row>
  __device__ __forceinline__ Gemm(Consumer& c_, uint32_t plane_, const float* __restrict__ bias, const Row& row)
      : c(c_), plane(plane_) {
    const int tig = c.lane % 4;
#pragma unroll
    for (int j = 0; j < P::N / 8; ++j) {
      const float b0 = bias ? __ldg(bias + j * 8 + tig * 2) : 0.f;
      const float b1 = bias ? __ldg(bias + j * 8 + tig * 2 + 1) : 0.f;
#pragma unroll
      for (int m = 0; m < P::MF; ++m) {
        acc[m][4 * j] = b0; acc[m][4 * j + 1] = b1; acc[m][4 * j + 2] = b0; acc[m][4 * j + 3] = b1;
      }
    }
    if constexpr (P::MH > 0) {
#pragma unroll
      for (int j = 0; j < P::N / 16; ++j) {
        const int col = c.wg * (P::N / 2) + j * 8 + tig * 2;
        const float b0 = bias ? __ldg(bias + col) : 0.f, b1 = bias ? __ldg(bias + col + 1) : 0.f;
        half[4 * j] = b0; half[4 * j + 1] = b1; half[4 * j + 2] = b0; half[4 * j + 3] = b1;
      }
    }
#pragma unroll
    for (int m = 0; m < P::MA; ++m) pix0[m] = row(m);
    fence_all();
  }

  __device__ __forceinline__ void fence_all() {
#pragma unroll
    for (int m = 0; m < P::MF; ++m) fence_regs(acc[m]);
    if constexpr (P::MH > 0) fence_regs(half);
  }

  // A of k-step `step`: bf16 as ldmatrix gives it; float32 split into tf32
  // hi (r[m][0..3]) and lo (r[m][4..7])
  __device__ __forceinline__ void gather(int step, uint32_t (&r)[P::MA][OS::A]) {
    const int tap = step >> SHIFT, off = (tap / KS) * PITCH + tap % KS;
    const int chunk = 2 * (step & ((1 << SHIFT) - 1)) + (c.lane >> 4);
#pragma unroll
    for (int m = 0; m < P::MA; ++m) {
      const uint32_t addr = plane + plane_offset<OP, PP>(pix0[m] + off, chunk);
      if constexpr (OS::A == 4) {
        ldmatrix_x4(addr, r[m]);
      } else {
        uint32_t v[4];
        ldmatrix_x4(addr, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(v[i], r[m][i], r[m][4 + i]);
      }
    }
  }

  // K k-steps from step0: wait for their weights, gather all their A, issue
  // their products behind one fence, and free the slot once they are done.
  // col: this warpgroup's first B column. float32: the split product
  // A_lo B_hi + A_hi B_lo + A_hi B_hi, small terms first, from the step's hi
  // slice and the lo slice after it.
  template <int K>
  __device__ __forceinline__ void chunk(int step0, int col) {
    const int slot = c.s % P::SLOTS;
    mbar_wait(c.full + 8 * slot, (c.s / P::SLOTS) & 1);
#pragma unroll
    for (int k = 0; k < K; ++k) gather(step0 + k, a[k]);
    wg_fence();
    const uint64_t desc = b_desc(c.ring + slot * P::SLOT) + col * 2;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if constexpr (OS::SLICES == 1) {
#pragma unroll
        for (int m = 0; m < P::MF; ++m) Wgmma<P::N>::run(acc[m], a[k][m], desc + k * (P::SLICE / 16));
        if constexpr (P::MH > 0)
          Wgmma<P::N / 2>::run(half, a[k][P::MF], desc + k * (P::SLICE / 16) + c.wg * P::N);
      } else {
        const uint64_t hi = desc + k * (P::SLICE / 16), lo = hi + P::SLICE / 32;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const int ia = p == 0 ? 4 : 0;
          const uint64_t b = p == 1 ? lo : hi;
#pragma unroll
          for (int m = 0; m < P::MF; ++m) WgmmaTf32<P::N>::run(acc[m], &a[k][m][ia], b);
          if constexpr (P::MH > 0) WgmmaTf32<P::N / 2>::run(half, &a[k][P::MF][ia], b + c.wg * P::N);
        }
      }
    }
    wg_commit();
    wg_wait<0>();
    if (c.lane == 0) mbar_arrive(c.empty + 8 * slot);
    ++c.s;
  }

  __device__ __forceinline__ void run(int col = 0) {
#pragma unroll 1
    for (int i = 0; i < P::STEPS / P::KC; ++i) chunk<P::KC>(i * P::KC, col);
    if constexpr (P::STEPS % P::KC > 0) chunk<P::STEPS % P::KC>(P::STEPS - P::STEPS % P::KC, col);
    fence_all();
  }

  // epi(row0 of this thread's first row in the tile, accumulators, first
  // column) for each of this warpgroup's tiles; `split`: the tiles
  // alternate between the warpgroups
  template <typename Epi>
  __device__ __forceinline__ void each_tile(bool split, const Epi& epi) const {
    const int base = c.warp * 16 + c.lane / 4;
#pragma unroll
    for (int m = 0; m < P::MF; ++m) epi((split ? c.wg + 2 * m : m) * 64 + base, acc[m], 0);
    if constexpr (P::MH > 0) epi((2 * P::MF) * 64 + base, half, c.wg * (P::N / 2));
  }
};

// This lane's ldmatrix row of tile `tile`, clamped to the region's n rows
__device__ __forceinline__ int lane_row(const Consumer& c, int tile, int n) {
  return min(tile * 64 + c.warp * 16 + (c.lane & 15), n - 1);
}

struct Params {
  const void* x;     // the form's input (kK6: fea, kK7: P2), of OP
  const char* w0;    // up1: the k-steps of N = 256, wgmma order
  const float* b0;   // [256]: up1's bias for each phase
  const char* w2;    // up2: 2 passes x its k-steps of N = 128
  const float* b2;   // [64]
  const char* w1;    // HRconv: the k-steps of N = 64
  const float* b1;   // [64]
  const char* w9;    // conv_last W9: the k-steps of N = 32
  const float* b3;   // [8], the first 3 used
  float* out;        // [B, 4H, 4W, 3]
  int B, H, W, patches_x, patches;  // patches of one tile
};

// Where a patch lies
struct Patch {
  int b, Y0, X0;  // tile; the patch's first 4x row and column
};

__device__ __forceinline__ Patch patch_of(const Params& p, int i, int TH, int TW) {
  const int r = i % p.patches;
  return {i / p.patches, (r / p.patches_x) * TH, (r % p.patches_x) * TW};
}

// The producer's weight chunks of one stage, in the order the consumers take them
template <class P>
__device__ __forceinline__ void produce_stage(const char* src, uint32_t ring, uint32_t full, uint32_t empty,
                                              int& s) {
#pragma unroll 1
  for (int done = 0; done < P::STEPS; done += P::KC, ++s) {
    const int slot = s % P::SLOTS, bytes = cmin(P::KC, P::STEPS - done) * P::SLICE;
    if (s >= P::SLOTS) mbar_wait(empty + 8 * slot, ((s / P::SLOTS) - 1) & 1);
    mbar_expect_tx(full + 8 * slot, bytes);
    bulk_copy(ring + slot * P::SLOT, src + done * P::SLICE, bytes, full + 8 * slot);
  }
}

// The first base row of y1 over the 2x window that starts at 2x row r (y1
// row i holds 2x rows 2i - 1 and 2i); alike for columns
__device__ __forceinline__ int y1_first(int r) { return (r + 1) >> 1; }

// One patch's window by the loader threads (tid = 0 .. kLoaders - 1), by
// cp.async into the swizzled plane at `win` (no registers held, so all of a
// thread's copies are in flight at once), with zeros outside the tile: K6 the
// fea pixels under y1, rows and columns from y1_first(Y0 / 2 - 2) - 1 (up1's
// zero padding); K7 P2 with its 2-pixel halo. `full` counts this thread
// once its copies landed. The borders are per chunk, not TMA's zero fill
// past the tensor: K7's phases are channel groups.
template <int TH, int TW, int FORM, typename OP>
__device__ __forceinline__ void load_window(const Params& p, const Patch& t, uint32_t win, uint32_t full,
                                            int tid) {
  using G = Geo<TH, TW>;
  constexpr int E = 16 / int(sizeof(OP));  // values a 16-byte chunk holds
  constexpr int chunks = kNF / E;
  const OP* x = static_cast<const OP*>(p.x);
  const int H = p.H, W = p.W;
  if constexpr (FORM == kK6) {
    // (four unrolled copies spilled 12 bytes, float32 28, in the
    // producer's 40 registers)
    const int r0 = y1_first(t.Y0 / 2 - 2) - 1, c0 = y1_first(t.X0 / 2 - 2) - 1;
#pragma unroll 2
    for (int idx = tid; idx < G::PF * chunks; idx += kLoaders) {
      const int pix = idx / chunks, ch = idx % chunks;
      const int r = r0 + pix / G::FW, c = c0 + pix % G::FW;
      const bool in = r >= 0 && r < H && c >= 0 && c < W;
      const size_t o = in ? ((size_t(t.b) * H + r) * W + c) * kNF + ch * E : 0;
      cp_async_16(win + plane_offset<OP, G::PF>(pix, ch), x + o, in);
    }
  } else {
    // float32's 16 chunks a pixel: four unrolled copies spill (16 bytes) in
    // the producer's 40 registers, two do not and take the same time
    constexpr int unroll = sizeof(OP) == 2 ? 4 : 2;
#pragma unroll(unroll)
    for (int idx = tid; idx < G::PP * chunks; idx += kLoaders) {
      const int pix = idx / chunks, ch = idx % chunks;
      const int Y = t.Y0 - 2 + pix / G::PW, X = t.X0 - 2 + pix % G::PW;
      const bool in = Y >= 0 && Y < 4 * H && X >= 0 && X < 4 * W;
      const size_t o = in ? ((size_t(t.b) * H + (Y >> 2)) * W + (X >> 2)) * (16 * kNF) +
                                ((Y & 3) * 4 + (X & 3)) * kNF + ch * E
                          : 0;
      cp_async_16(win + plane_offset<OP, G::PP>(pix, ch), x + o, in);
    }
  }
  cp_async_arrive(full);
}

// Byte offset of f32 column `col` of z pixel q in T: 128-byte rows, the
// 16-byte chunks XOR-swizzled by the row
__device__ __forceinline__ uint32_t t_offset(int q, int col) {
  return uint32_t(q) * 128 + (uint32_t((col >> 2) ^ (q & 7)) << 4) + (col & 3) * 4;
}

// lrelu'd values of one accumulator row, NJ groups of 8 columns, into
// pixel `pix` of a 64-channel plane of PP pixels of OP (zero when outside
// the image), columns col0 ...
template <typename OP, int PP, int NJ>
__device__ __forceinline__ void store_row(unsigned char* plane, int pix, bool inside, const float* acc, int h,
                                          int col0, int tig) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
    if constexpr (sizeof(OP) == 2) {
      *reinterpret_cast<uint32_t*>(plane + chunk_offset<kNF>(pix, col0 / 8 + j) + tig * 4) =
          inside ? pack_bf16x2(lrelu(v0), lrelu(v1)) : 0u;
    } else {
      const int col = col0 + 8 * j + 2 * tig;
      *reinterpret_cast<float2*>(plane + chunk_offset_f32<kNF, PP>(pix, col >> 2) + (col & 3) * 4) =
          inside ? make_float2(lrelu(v0), lrelu(v1)) : make_float2(0.f, 0.f);
    }
  }
}

// The consumers' work on one patch whose window is in buffer j. win_empty:
// where each consumer warp reports that it no longer reads the window.
template <int TH, int TW, int FORM, typename OP>
__device__ __forceinline__ void consume(Consumer& c, unsigned char* base, const Params& p, const Patch& t,
                                        int j, uint32_t win_empty) {
  using G = Geo<TH, TW>;
  using L = Layout<TH, TW, FORM, OP>;
  using S = Plans<TH, TW, FORM, OP>;
  const int p2 = L::p2_of(j);
  const int H4 = 4 * p.H, W4 = 4 * p.W, tig = c.lane % 4;
  auto inside = [&](int Y, int X) { return Y >= 0 && Y < H4 && X >= 0 && X < W4; };

  if constexpr (FORM == kK6) {
    // up1: y1 pixel (yy, yx) reads fea window pixels (yy + s, yx + t); this
    // warpgroup computes phases (a = wg, b = 0, 1), 2x pixels (2 (i0 + yy) -
    // a, 2 (j0 + yx) - b), and writes those inside the 2x window (zero
    // outside the 2x image: up2's padding)
    Gemm<typename S::Up1, 2, G::FW, OP, G::PF> g(c, c.smem + L::win(0), p.b0, [&](int m) {
      const int q = lane_row(c, m, G::PY);
      return (q / G::YW) * G::FW + q % G::YW;
    });
    g.run(c.wg * 128);
    if (c.lane == 0) mbar_arrive(win_empty);
    const int R0 = t.Y0 / 2 - 2, C0 = t.X0 / 2 - 2, i0 = y1_first(R0), j0 = y1_first(C0);
    g.each_tile(false, [&](int q0, const auto& acc, int) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int q = q0 + 8 * h;
        // opaque, so that the row's y1 pixel is worked out here: hoisted out
        // of the walk over patches, it stayed live through HRconv and
        // spilled 8 bytes at 12 x 28
        asm volatile("" : "+r"(q));
        if (q >= G::PY) continue;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int r2 = 2 * (i0 + q / G::YW) - c.wg, c2 = 2 * (j0 + q % G::YW) - b;
          const int wr = r2 - R0, wc = c2 - C0;
          if (wr < 0 || wr >= G::XH || wc < 0 || wc >= G::XW) continue;
          store_row<OP, G::PX, kNF / 8>(base + L::x2, wr * G::XW + wc,
                                        r2 >= 0 && r2 < 2 * p.H && c2 >= 0 && c2 < 2 * p.W, acc + 32 * b, h, 0,
                                        tig);
        }
      }
    });
    consumers_sync();

    // up2, pass cp: this warpgroup's sub-phase (cp, d = wg); P2 region
    // pixel (2 qy + cp, 2 qx + d) reads window pixels (qy + cp + s, qx + d + t)
#pragma unroll 1
    for (int cp = 0; cp < 2; ++cp) {
      const int d = c.wg;
      Gemm<typename S::Up2, 2, G::XW, OP, G::PX> g(c, c.smem + L::x2, p.b2, [&](int m) {
        const int q = lane_row(c, m, G::PQ);
        return (q / G::QW + cp) * G::XW + q % G::QW + d;
      });
      g.run(c.wg * 64);
      // (the other warpgroup no longer reads the last patch's T in P2: both
      // passed the sync after up1)
      g.each_tile(false, [&](int q0, const auto& acc, int) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = q0 + 8 * h;
          if (q >= G::PQ) continue;
          const int py = 2 * (q / G::QW) + cp, px = 2 * (q % G::QW) + d;
          store_row<OP, G::PP, sizeof(acc) / 16>(base + p2, py * G::PW + px,
                                                 inside(t.Y0 - 2 + py, t.X0 - 2 + px), acc, h, 0, tig);
        }
      });
    }
    consumers_sync();
  }

  {  // HRconv: z pixel (zy, zx) reads P2 region pixels (zy + ky, zx + kx)
    Gemm<typename S::Hr, 3, G::PW, OP, G::PP> g(c, c.smem + p2, p.b1, [&](int m) {
      const int q = lane_row(c, m < S::Hr::MF ? c.wg + 2 * m : G::ZT - 1, G::PZ);
      return (q / G::ZW) * G::PW + q % G::ZW;
    });
    g.run();
    g.each_tile(true, [&](int q0, const auto& acc, int col0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = q0 + 8 * h;
        if (q >= G::PZ) continue;
        store_row<OP, G::PZ, sizeof(acc) / 16>(base + L::z, q, inside(t.Y0 - 1 + q / G::ZW, t.X0 - 1 + q % G::ZW),
                                               acc, h, col0, tig);
      }
    });
  }
  consumers_sync();

  {  // conv_last, W9-packed: T[q][tap * 3 + o] = z[q] . W9, into the P2 region
    Gemm<typename S::Last, 1, 0, OP, G::PZ> g(c, c.smem + L::z, nullptr, [&](int m) {
      return lane_row(c, m < S::Last::MF ? c.wg + 2 * m : G::ZT - 1, G::PZ);
    });
    g.run();
    g.each_tile(true, [&](int q0, const auto& acc, int col0) {
      constexpr int NR = sizeof(acc) / sizeof(float);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = q0 + 8 * h;
        if (q >= G::PZ) continue;
#pragma unroll
        for (int j = 0; j < NR / 4; ++j) {
          const int col = col0 + 8 * j + 2 * tig;
          *reinterpret_cast<float2*>(base + p2 + t_offset(q, col)) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    });
  }
  consumers_sync();

  // each output pixel: b3 + its nine shifted T rows, in tap order
  const float bias[kOut] = {__ldg(p.b3), __ldg(p.b3 + 1), __ldg(p.b3 + 2)};
  const int tid = c.wg * 128 + c.warp * 32 + c.lane;
#pragma unroll 1
  for (int o = tid; o < TH * TW; o += kConsumers * 128) {
    const int oy = o / TW, ox = o % TW, Y = t.Y0 + oy, X = t.X0 + ox;
    if (Y >= H4 || X >= W4) continue;
    float sum[kOut] = {bias[0], bias[1], bias[2]};
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int q = (oy + tap / 3) * G::ZW + ox + tap % 3;
#pragma unroll
      for (int e = 0; e < kOut; ++e)
        sum[e] += *reinterpret_cast<const float*>(base + p2 + t_offset(q, tap * kOut + e));
    }
    float* dst = p.out + ((size_t(t.b) * H4 + Y) * W4 + X) * kOut;
#pragma unroll
    for (int e = 0; e < kOut; ++e) dst[e] = sum[e];
  }
  if constexpr (FORM == kK7) {
    if (c.lane == 0) mbar_arrive(win_empty);
  }
}

// Grid: min(patches, SMs) persistent blocks; block i takes patches i,
// i + gridDim.x, ... of all B tiles.
template <int TH, int TW, int FORM, typename OP>
__global__ void __launch_bounds__(kThreads, 1) tail_kernel(const Params p) {
  using L = Layout<TH, TW, FORM, OP>;
  using S = Plans<TH, TW, FORM, OP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t smem = smem_u32(smem_raw);
  const uint32_t full = smem + L::bars, empty = full + 8 * L::slots;
  // per window buffer: "landed" (the loaders) and "free" (the consumer warps)
  const uint32_t win_full = empty + 8 * L::slots, win_empty = win_full + 8 * L::bufs;
  const int total = p.B * p.patches;

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::slots; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers * 4);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < L::bufs; ++i) {
      mbar_init(win_full + 8 * i, kLoaders);
      mbar_init(win_empty + 8 * i, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    setmaxnreg_producer();
    const int tid = threadIdx.x - kConsumers * 128;
    if (tid == 0) {
      // the weights, patch after patch, in the order the stages take them
      int s = 0;
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        if constexpr (FORM == kK6) {
          produce_stage<typename S::Up1>(p.w0, smem + L::ring, full, empty, s);
          produce_stage<typename S::Up2>(p.w2, smem + L::ring, full, empty, s);
          produce_stage<typename S::Up2>(p.w2 + S::Up2::STEPS * S::Up2::SLICE, smem + L::ring, full, empty, s);
        }
        produce_stage<typename S::Hr>(p.w1, smem + L::ring, full, empty, s);
        produce_stage<typename S::Last>(p.w9, smem + L::ring, full, empty, s);
      }
    } else if (tid >= 32) {
      // patch k's window into buffer k % bufs, once the consumers are done
      // with the patch that used it before
      int k = 0;
      for (int i = blockIdx.x; i < total; i += gridDim.x, ++k) {
        const int j = k % L::bufs, u = k / L::bufs;
        if (u > 0) mbar_wait(win_empty + 8 * j, (u - 1) & 1);
        load_window<TH, TW, FORM, OP>(p, patch_of(p, i, TH, TW), smem + L::win(j), win_full + 8 * j, tid - 32);
      }
    }
    return;
  }
  setmaxnreg_consumer();

  const int wg = int(threadIdx.x) / 128;
  Consumer c{smem, smem + L::ring, full, empty, 0, wg, int(threadIdx.x / 32) % 4, int(threadIdx.x % 32)};
  int k = 0;
#pragma unroll 1
  for (int i = blockIdx.x; i < total; i += gridDim.x, ++k) {
    const int j = k % L::bufs;
    mbar_wait(win_full + 8 * j, (k / L::bufs) & 1);
    consume<TH, TW, FORM, OP>(c, smem_raw, p, patch_of(p, i, TH, TW), j, win_empty + 8 * j);
  }
}

// The persistent grid of TH x TW patches over B tiles of H x W base pixels
template <int TH, int TW, int FORM, typename OP>
int launch(Params p, int sms, cudaStream_t stream) {
  constexpr int smem = Layout<TH, TW, FORM, OP>::bytes;
  static_assert(smem <= 232448, "shared memory of one block");
  const cudaError_t err =
      cudaFuncSetAttribute(tail_kernel<TH, TW, FORM, OP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  p.patches_x = (4 * p.W + TW - 1) / TW;
  p.patches = p.patches_x * ((4 * p.H + TH - 1) / TH);
  const int grid = cmin(p.B * p.patches, sms);
  tail_kernel<TH, TW, FORM, OP><<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

// The launch's checks and parameters; tile(p) launches the instance of the
// source for the form and patch shape. Returns a cudaError_t.
template <class Tile>
int tail_launch_with(const void* x, const void* w0, const void* b0, const void* w2, const void* b2, const void* w1,
                     const void* b1, const void* w9, const void* b3, void* out, int B, int H, int W, int form,
                     int th, int tw, const Tile& tile) {
  if (B < 1 || H < 1 || W < 1 || H > (1 << 20) || W > (1 << 20)) return int(cudaErrorInvalidValue);
  if (form < kK7 || form > kK6) return int(cudaErrorInvalidValue);
  if (form == kK6 && (w0 == nullptr || b0 == nullptr || w2 == nullptr || b2 == nullptr))
    return int(cudaErrorInvalidValue);
  if (int64_t(B) * ((4 * int64_t(H) + th - 1) / th) * ((4 * int64_t(W) + tw - 1) / tw) > (1ll << 31) - 1)
    return int(cudaErrorInvalidValue);
  const Params p{x, static_cast<const char*>(w0), static_cast<const float*>(b0), static_cast<const char*>(w2),
                 static_cast<const float*>(b2), static_cast<const char*>(w1), static_cast<const float*>(b1),
                 static_cast<const char*>(w9), static_cast<const float*>(b3), static_cast<float*>(out), B, H, W, 0, 0};
  return tile(p);
}

}  // namespace
