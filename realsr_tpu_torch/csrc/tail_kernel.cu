// Fused packed-phase tail for Hopper (sm_90a) on wgmma: up2 + HRconv +
// conv_last.
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
// Bound: operations. Per base pixel the tail is 16 * 64 * (256 + 576) +
// 16 * 3 * 576 = 879,616 MACs against 512 B of P1 read and 192 B written:
// ~2,500 flop per byte, far above the card's ~295. P2 and z (64 channels at
// 4x resolution) never leave the SM.
//
// Design (one persistent block per SM, 384 threads: two consumer warpgroups
// and a producer warpgroup, setmaxnreg as in rdb_wgmma.cu; helpers in
// hopper.cuh). The block walks TH x TW patches of the 4x output. Its shared
// memory holds, as bf16 pixel-major planes with the 16-byte channel chunks
// XOR-swizzled by pixel (ldmatrix reads 8 pixels of a chunk conflict-free):
//   the 2x window of the patch (K6 only), (TH/2 + 4) x (TW/2 + 4);
//   z with conv_last's 1-pixel halo, (TH + 2) x (TW + 2);
//   P2 with HRconv's halo on top, (TH + 4) x (TW + 4); after HRconv it
//   holds conv_last's f32 partial sums T (K7: two P2 buffers, one of them
//   the next patch's window);
//   a ring of two weight slots (K6 32 KB, K7 16 KB).
// - Each stage is a GEMM on wgmma with register A: a tap's 64 rows are
//   shifted pixels of a plane with another row pitch (a gather no
//   descriptor describes), so each warp's ldmatrix.x4 fragment of 16 pixels
//   x 16 channels goes to wgmma as it is. B comes from the ring through a
//   descriptor: the weights are packed at load as k16 slices in wgmma's
//   K-major layout (ops/tail_kernel.py::pack_tail_params) and streamed once
//   per patch by one producer thread with cp.async.bulk and mbarriers, never
//   once per warp.
//   up2: two passes (c = 0, 1), the warpgroups taking sub-phases d = 0 and
//   1, M = the sub-phase's (TH/2 + 2) x (TW/2 + 2) pixels, K = 4 taps x 64,
//   N = 64 each of one N = 128 slice [k2[c][0] | k2[c][1]].
//   HRconv: M = the z region, K = 576, N = 64; the 64-row tiles alternate
//   between the warpgroups, an odd last one split by columns.
//   conv_last in the W9-packed form of the TPU kernel: one K = 64 product
//   per z pixel with N = 32 (9 taps x 3 outputs, padded), T = z . W9 in f32;
//   each output pixel then sums its nine shifted T rows.
//   Every m-tile count is a compile-time constant, so ptxas keeps the wgmma
//   pipeline asynchronous; a stage's accumulators and a chunk's A fragments
//   stay within 192 registers, so it does not spill. The warpgroups issue
//   their products independently: rdb_wgmma.cu's turns (named barriers)
//   measured slower here (tools/tail_wgmma_ablation.py).
// - Three producer warps load the next patch's window by cp.async (zero
//   fill outside the tile) while the consumers work on the current patch:
//   K6's 2x window once up2 is done with it, K7's P2 into the other buffer.
// - The patch shape is a template parameter: ops/tail_kernel.py::
//   tail_geometry picks it per chunk shape (8 x 148^2: 12 x 28).
// The code, shared with the float32 instances (tail_tf32.cu), is in
// tail_wgmma.cuh; this source holds the bf16 instances.

#include "groups.cuh"
#include "tail_wgmma.cuh"

namespace {

template <bool UP2>
int launch_tile(const Params& p, int th, int tw, int sms, cudaStream_t s) {
  if (th == 16 && tw == 16) return launch<16, 16, UP2, __nv_bfloat16>(p, sms, s);
  if (th == 12 && tw == 28) return launch<12, 28, UP2, __nv_bfloat16>(p, sms, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The fused tail over B tiles of H x W base pixels (nf = 64, 3 outputs, bf16
// operands). with_up2 = 1: x is P1 (K6); 0: x is P2 and w2, b2 are unused
// (K7). Weights in wgmma order (ops/tail_kernel.py::pack_tail_params); th x
// tw: the 4x patch shape (16 x 16 or 12 x 28); sms: the persistent blocks at
// most. Returns the cudaError_t of the launch.
int tail_launch(const void* x, const void* w2, const void* b2, const void* w1, const void* b1,
                const void* w9, const void* b3, void* out, int B, int H, int W, int with_up2, int th, int tw,
                int sms, void* stream) {
  if (sms < 1) return int(cudaErrorInvalidValue);
  return tail_launch_with(x, w2, b2, w1, b1, w9, b3, out, B, H, W, with_up2, th, tw, [&](const Params& p) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef GROUP_K6
    if (with_up2) return launch_tile<true>(p, th, tw, sms, s);
#endif
#ifdef GROUP_K7
    if (!with_up2) return launch_tile<false>(p, th, tw, sms, s);
#endif
    return int(cudaErrorInvalidValue);
  });
}

const char* tail_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
