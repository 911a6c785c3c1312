// Residual dense block (RDB) on a row-extended feature buffer, forward
// and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels torchsr_tpu/ops/pallas/rdb.py:299
// (_rdb_fwd_kernel_ext) and rdb.py:594 (_rdb_bwd_kernel_ext), selected
// there by TORCHSR_RDB_EXT=1 on shapes that pass _ext_eligible (:406:
// H*W <= 4096 and W % 16 == 0).  The math is that of csrc/rdb_fwd.cu and
// csrc/rdb_bwd.cu (five dense 3x3 SAME convs, C_in = 64 + 32 i, C_out 32
// or 64; bias, LeakyReLU(0.2) on convs 1-4, x + scale * conv5; the
// backward from g and the saved post-activation buffer, LeakyReLU' from
// its sign, dW and db in f32); what differs is the layout.
//
// Layout.  The TPU kernel keeps one image per grid step in a (H*W + 2W)
// row buffer with W zero rows at each end, so the three dy operands of a
// conv are row-offset views (0, W, 2W) of one store and no row needs a
// mask.  Here the whole batch is one such buffer in device memory:
// (B, H + 2, W, C) NHWC, each image between a zero pad row above and one
// below.  Every kernel below reads and writes the image rows only (the
// halo boxes and copies zero-fill rows outside the image), so the
// row-extended variants compute B1's and B2's bits with the layout's row
// stride and offset: image b's row y is buffer row b (H + 2) + 1 + y.
//
// Forward, bf16 (AMP): the six launches of csrc/rdb_fwd_sm90.cuh (B1's
// kernels).  Its prep launch zeroes the pad rows; conv 1 copies x into
// channels [0, 64) of the data rows; the halo boxes and the stores cover
// the image rows only, so pad rows are never read or computed, and the
// block equals B1's bit for bit.
//
// Forward, f32: the six launches of csrc/rdb_fwd_tf32_sm90.cuh (B1's
// f32 kernels, 3xTF32 on wgmma), so that B7 equals B1 bit for bit in f32
// too: the prep zeroes the pad rows and conv 1 copies x into the data
// rows.
//
// Backward, bf16 (AMP): the eight launches of csrc/rdb_bwd_sm90.cuh (B2's
// kernels).  DY = [dy_0 | ... | dy_4] takes the same
// (B, H + 2, W, 192) layout, its pad rows zeroed by the prep launch; the
// halo staging zero-fills rows outside the image (cp.async), so pad rows
// are never read.  The TPU kernel's row-offset scatter of dx3 = dy @ W^T
// into a padded f32 dF (rdb.py:594) becomes each slot's gather conv over
// DY, and no dF exists.
//
// Backward, f32 (--disable-amp): the eight launches of
// csrc/rdb_bwd_tf32_sm90.cuh (B2's f32 kernels, 3xTF32 on wgmma), so
// that B8 equals B2 bit for bit on the data rows: DY's pad rows are
// zeroed by the prep and never read.
//
// Bound on this card (H100 SXM).  Forward at the serving shape (16, 64,
// 64, 64): 31.4 GFLOP, 0.0318 ms at 989 TFLOP/s bf16 (0.190 ms as three
// TF32 products at 495 TFLOP/s in f32); its bytes (x in, out) 16.8 MB
// bf16, 0.005 ms: compute-bound, as B1.  Backward at the training shape
// (64, 32, 32, 64): 62.8 GFLOP, 0.0635 ms bf16 (0.381 ms as three TF32
// products in f32) against 0.013 ms of bytes (0.025 in f32).

#include "rdb_bwd_sm90.cuh"
#include "rdb_bwd_tf32_sm90.cuh"
#include "rdb_fwd_sm90.cuh"
#include "rdb_fwd_tf32_sm90.cuh"
#include "rdb_mma.cuh"

extern "C" {

// The bf16 block forward into the (B, H + 2, W, 192) buffer `feat`: the
// six launches of csrc/rdb_fwd_sm90.cuh on the row-extended layout
// (x into the data rows, pad rows zeroed, out (B, H, W, 64) unpadded);
// arguments as rdb_fwd.cu's rdb_fwd_bf16_launch.  Returns the
// cudaError_t of the first failed launch (0 on success), as every entry
// point below.
int rdb_ext_fwd_bf16_launch(const void* x, void* feat, void* out,
                            const void* wptr, const void* wstride, int w_f32,
                            const void* bptr, void* wpack, int B, int H,
                            int W, float scale, int device, void* stream) {
  return rdb_fwd_sm90::launch_fwd_entry(
      x, feat, out, static_cast<const void* const*>(wptr),
      static_cast<const long long*>(wstride), w_f32,
      static_cast<const void* const*>(bptr), wpack, B, H, W, 1, scale,
      device, stream);
}

// The f32 block forward (3xTF32) into the (B, H + 2, W, 192) buffer
// `feat`: the six launches of csrc/rdb_fwd_tf32_sm90.cuh on the
// row-extended layout (x into the data rows, pad rows zeroed, out (B, H,
// W, 64) unpadded); arguments as rdb_fwd.cu's rdb_fwd_tf32_launch.
int rdb_ext_fwd_tf32_launch(const void* x, void* feat, void* out,
                            const void* wptr, const void* wstride,
                            const void* bptr, void* wpack, int B, int H,
                            int W, float scale, int device, void* stream) {
  return rdb_fwd_tf32::launch_fwd_entry(
      x, feat, out, static_cast<const void* const*>(wptr),
      static_cast<const long long*>(wstride),
      static_cast<const void* const*>(bptr), wpack, B, H, W, 1, scale,
      device, stream);
}

// The bf16 block backward on the (B, H + 2, W, 192) buffer `feat`: the
// eight launches of csrc/rdb_bwd_sm90.cuh on the row-extended layout, DY
// in the same layout with its pad rows zero; arguments as
// rdb_bwd.cu's rdb_bwd_bf16_launch.
int rdb_ext_bwd_bf16_launch(const void* g, const void* feat, const void* wptr,
                            const void* wstride, int w_f32, void* dy,
                            void* dx, void* wpack, void* dw_part,
                            void* db_part, void* dw, void* db, int B, int H,
                            int W, float scale, int nblocks, int P,
                            int g_conv, int g_dx, int g_wgrad, int device,
                            void* stream) {
  return rdb_bwd_sm90::launch_bwd_entry(
      g, feat, static_cast<const void* const*>(wptr),
      static_cast<const long long*>(wstride), w_f32, dy, dx, wpack, dw_part,
      db_part, dw, db, B, H, W, 1, scale, nblocks, P, g_conv, g_dx, g_wgrad,
      device, stream);
}

// The f32 block backward (3xTF32) on the (B, H + 2, W, 192) buffer
// `feat`: the eight launches of csrc/rdb_bwd_tf32_sm90.cuh on the
// row-extended layout, DY in the same layout with its pad rows zero;
// arguments as rdb_bwd.cu's rdb_bwd_tf32_launch.
int rdb_ext_bwd_tf32_launch(const void* g, const void* feat, const void* wptr,
                            const void* wstride, void* dy, void* dx,
                            void* wpack, void* dw_part, void* db_part,
                            void* dw, void* db, int B, int H, int W,
                            float scale, int nb_dy, int P, int g_conv,
                            int g_dx, int g_wgrad, int device, void* stream) {
  return rdb_bwd_tf32::launch_bwd_entry(
      g, feat, static_cast<const void* const*>(wptr),
      static_cast<const long long*>(wstride), dy, dx, wpack, dw_part,
      db_part, dw, db, B, H, W, 1, scale, nb_dy, P, g_conv, g_dx, g_wgrad,
      device, stream);
}

const char* rdb_ext_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
