// Fused packed-phase tail for Hopper (sm_90a) with float32 operands: K6 and
// K7 of a float32 engine, on wgmma with a split TF32 product.
//
// Replaces realsr_tpu/ops/tail_kernel.py::_tail_kernel and the up1 conv
// before it in tail_kernel.cu's two forms (K6 from fea with up1 inside, K7)
// where the operands are float32 and the products run at
// Precision.HIGHEST: the JAX package's float32 Pallas engine ends on this
// kernel tail (realsr_tpu/engine.py's packed-tail upgrade checks nf and
// out_ch, not the dtype). The arithmetic is tail_kernel.cu's with X2, P2, z
// and every operand in float32 (no rounding to bf16) and every product
// split as float32 K1's (rdb_tf32.cu): the weights as tf32 hi + lo, rounded
// to nearest on the host (ops/tail_kernel.py::pack_tail_params, "w0t" /
// "w2t" / "w1t" / "w9t": per k8 step the hi slice, then the lo slice), the
// activations in registers, hi by truncation and lo as it is
// (hopper.cuh::split_tf32), each product A_lo B_hi + A_hi B_lo + A_hi B_hi
// summed in f32.
//
// Bound: operations. Per 4x output pixel K6 is 59,072 MACs (K7 38,592),
// three tf32 products each at 495 TFLOP/s: 2.01 ms (K6) and 1.31 ms (K7)
// at 8 x 148^2 (165.6 and 108.2 GMAC), against 0.335 / 0.219 ms for the
// bf16 instances.
//
// Design: tail_kernel.cu's (persistent blocks walking TH x TW patches of the
// 4x output, two consumer warpgroups running up2 / HRconv / conv_last as
// wgmma GEMMs with register A, the weights streamed through a ring by
// cp.async.bulk, producer warps loading the next patch's window while the
// consumers work) on float32 planes (tail_wgmma.cuh):
// - Each 64-channel plane is two 32-channel sub-planes of 128-byte pixels,
//   as float32 K1's window (hopper.cuh::chunk_offset_f32): ldmatrix.x4 on
//   the b16 view gives each warp's m16k8 tf32 fragment, and a k8 slice of B
//   has a bf16 k16 slice's bytes, so the stages' descriptors are the bf16
//   instances'.
// - The planes take twice the bytes, which shrinks the patch: at the bf16
//   instances' 12 x 28 the planes alone would take 287 KB. The patch shapes
//   are 10 x 14 (K6 219,184 B with the fea window, K7 213,056 B with two P2
//   buffers) and 8 x 16; 10 x 14 makes z exactly
//   three 64-row tiles and each up2 sub-phase (7 x 9) one, so at 8 x 148^2
//   it issues up2, HRconv and conv_last 1.562x their MACs (K7 1.425x)
//   against the bf16 instances' 1.474x (1.418x) at 12 x 28. up1's y1 (5 x 6
//   pixels) fills half of its one 64-row tile: K6 issues 1.976x its MACs
//   (bf16 1.595x).
//   ops/tail_kernel.py::tail_tf32_geometry picks the shape.
// - The layout keeps room for the next window: K6's persistent blocks load
//   the fea window once up1 is done with the current one, K7's into its
//   second P2 buffer, as the bf16 instances do.
// - A's hi and lo double its registers and the k8 steps double the chunks;
//   Plan::KC keeps each stage's accumulators + A within kAccA (up1 2 steps a
//   chunk, up2 4, HRconv 8, conv_last 8).
// A source of its own, so that nvcc builds it beside the others.

#include "groups.cuh"
#include "tail_wgmma.cuh"

namespace {

template <int FORM>
int launch_tile(const Params& p, int th, int tw, int sms, cudaStream_t s) {
  if (th == 10 && tw == 14) return launch<10, 14, FORM, float>(p, sms, s);
  if (th == 8 && tw == 16) return launch<8, 16, FORM, float>(p, sms, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The fused tail over B tiles of H x W base pixels with float32 operands
// (nf = 64, 3 outputs) in form `form`, as tail_kernel.cu's tail_launch: x
// is fea (1, K6) or P2 (0, K7), float32; the weights
// the tf32 hi/lo k8 slices of pack_tail_params ("w0t", "w2t", "w1t",
// "w9t"); th x tw: the 4x patch shape (10 x 14 or 8 x 16); sms: the
// persistent blocks at most. Returns the cudaError_t of the launch.
int tail_tf32_launch(const void* x, const void* w0, const void* b0, const void* w2, const void* b2, const void* w1,
                     const void* b1, const void* w9, const void* b3, void* out, int B, int H, int W, int form,
                     int th, int tw, int sms, void* stream) {
  if (sms < 1) return int(cudaErrorInvalidValue);
  return tail_launch_with(x, w0, b0, w2, b2, w1, b1, w9, b3, out, B, H, W, form, th, tw, [&](const Params& p) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef GROUP_K6
    if (form == kK6) return launch_tile<kK6>(p, th, tw, sms, s);
#endif
#ifdef GROUP_K7
    if (form == kK7) return launch_tile<kK7>(p, th, tw, sms, s);
#endif
    return int(cudaErrorInvalidValue);
  });
}

const char* tail_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
