// K1-TC — the flat ÷2^k decimator on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel sdrangel_tpu/pallas/decimator.py:165
// decimate_cascade_fused_mxu (the matrix-unit form of the fused decimator):
// the order-64 half-band ÷2^k cascade folded into one filter split into
// r = 2^k polyphase legs (r, t_leg), on the i16 cen path.
//
// Contract (as K1's i16 path): ext is [carried raw tail | block], (N, 2)
// int16 interleaved I/Q with N = T + r·(t_leg − 1); output m (of T/r) is
//     y[m] = Σ_t Σ_j legs[j, t] · ext[r·(m + t) + j] / 32768.
//
// Form. With the polyphase planes P[w, j] = ext[r·w + j] (one (W × r)
// matrix each for I and Q), Z = P @ legs is a dense (W × r) @ (r × t_leg)
// product and y[m] = Σ_t Z[m + t, t] is a skewed diagonal sum. The product
// carries all r·t_leg MACs of an output on the tensor cores
// (mma.sync.m16n8k8 TF32, f32 accumulation); the diagonal sum costs t_leg
// adds per output from shared memory.
//
// Precision, route (a) of the two that keep float32 fidelity. TF32 keeps 11
// significant bits, so each int16 sample is split as 256·hi + lo
// (−128 ≤ hi < 128, 0 ≤ lo < 256), both exact in TF32 with the 1/32768
// scale folded in (hi/128 and lo/32768 are exact), and each leg as a TF32
// hi part plus a TF32 remainder. Three passes — hi·hi, hi·lo, lo·hi — go into
// one f32 accumulator. The dropped lo·lo term is below
// (255/32768)·2^−11·Σ|h_eq| = 7.5e-6 at ÷64 (Σ|h_eq| = 1.97) in the worst
// case and ~1e-7 on random full-scale input, inside the Pallas kernel's
// 2e-5 tolerance. Route (b), FP64 DMMA, is exact but its peak is 67 TFLOP/s
// against TF32's 495 (three passes: 165), so (a) has the lower bound.
//
// Block work. A block owns kTileOut = 128 consecutive outputs and stages
// their window, 200 plane rows of r int16 pairs, in shared memory once.
// Warp n owns taps 8n .. 8n+7 (one n8 tile; t_leg ≤ 64 is zero-padded to
// 64), keeps its legs as B fragments in registers, and computes the
// 135 plane rows its taps reach for the block's outputs (9 m16 tiles)
// into a private Z area. Each warp then sums its 8 diagonals per output;
// the 8 warps' partial sums are added in a fixed order, so the result does
// not depend on the launch (streamed blocks equal one long block bit for
// bit).
//
// What bounds it on an H100: at the 2^25-sample gear block (÷64) the three
// passes are 25.4 GFLOP of TF32, 0.051 ms at the 495 TFLOP/s dense peak,
// against 0.041 ms to read 134 MB and write 4 MB at 3.35 TB/s: operations
// bound it, by a little. This first form uses mma.sync without a pipeline
// (the window is loaded, then used); wgmma, TMA and double-buffered windows
// are later work. Shared memory: 54 KB of window + 83 KB of Z at r = 64,
// one block per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTapsPad = 64;                    // t_leg ≤ 64, zero-padded
constexpr int kWarps = kTapsPad / 8;            // one warp per 8-tap n tile
constexpr int kThreads = kWarps * 32;
constexpr int kTileOut = 128;                   // outputs per block
constexpr int kMTiles = (kTileOut + 7 + 15) / 16;  // m16 tiles a warp computes
constexpr int kWarpRows = kMTiles * 16;         // Z rows of one warp
constexpr int kRows = 8 * (kWarps - 1) + kWarpRows;  // plane rows the block stages
constexpr int kZStride = 9;                     // 8 taps + 1: conflict-free diagonal reads
constexpr int kZWarp = 2 * kWarpRows * kZStride;  // floats of one warp's Z (I and Q)
static_assert(kThreads == 2 * kTileOut, "the final sum maps one thread to each (output, I/Q)");
static_assert(kTileOut % 32 == 0, "each lane sums kTileOut / 32 outputs");
static_assert(2 * kTileOut <= kZWarp, "partial sums reuse the warp's Z area");

template <int kLog2>
struct Geom {
  static constexpr int r = 1 << kLog2;
  static constexpr int kSteps = (r + 7) / 8;    // k8 steps over the legs
  static constexpr int kPadK = kSteps * 8;
  // +4 pairs per row: fragment loads (8 rows × 4 columns) hit 32 banks
  static constexpr int kXStride = kPadK + 4;
  static constexpr size_t kSmem =
      static_cast<size_t>(kRows) * kXStride * sizeof(short2) +
      static_cast<size_t>(kWarps) * kZWarp * sizeof(float);
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a (16×8, row) · b (8×8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// int16 sample → (hi/128, lo/32768), both exact TF32 bit patterns
__device__ __forceinline__ void split(int v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(static_cast<float>(v >> 8) * (1.0f / 128.0f));
  lo = __float_as_uint(static_cast<float>(v & 0xff) * (1.0f / 32768.0f));
}

template <int kLog2>
__global__ void __launch_bounds__(kThreads)
flat_decimate_tc_kernel(const short2* __restrict__ ext, long long n_in,
                        const float* __restrict__ legs, int t_leg, long long n_out,
                        float* __restrict__ out) {
  using G = Geom<kLog2>;
  extern __shared__ float4 smem[];
  short2* sh_x = reinterpret_cast<short2*>(smem);  // [kRows][kXStride]
  float* sh_z = reinterpret_cast<float*>(sh_x + kRows * G::kXStride);  // [kWarps][kZWarp]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int tq = lane & 3;   // thread in group
  const long long m0 = static_cast<long long>(blockIdx.x) * kTileOut;
  const long long base = m0 * G::r;  // first sample of plane row 0

  // the window: plane rows m0 .. m0+kRows-1, zero past r and past the input
  for (int s = threadIdx.x; s < kRows * G::kPadK; s += kThreads) {
    const int w = s / G::kPadK;
    const int j = s - w * G::kPadK;
    short2 v = make_short2(0, 0);
    if (j < G::r) {
      const long long idx = base + static_cast<long long>(w) * G::r + j;
      if (idx < n_in) v = ext[idx];
    }
    sh_x[w * G::kXStride + j] = v;
  }

  // this warp's legs as B fragments: b0 = legs[j = 8ks + tq][t], b1 at j + 4
  const int t_b = warp * 8 + g;
  uint32_t b_hi[G::kSteps][2], b_lo[G::kSteps][2];
#pragma unroll
  for (int ks = 0; ks < G::kSteps; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = ks * 8 + tq + 4 * h;
      const float l = (j < G::r && t_b < t_leg) ? legs[j * t_leg + t_b] : 0.0f;
      b_hi[ks][h] = to_tf32(l);
      b_lo[ks][h] = to_tf32(l - __uint_as_float(b_hi[ks][h]));
    }
  }
  __syncthreads();

  // Z rows of this warp: local row lr is plane row 8·warp + lr (the rows its
  // taps reach for outputs 0..kTileOut-1), column c is tap 8·warp + c
  float* zi = sh_z + warp * kZWarp;
  float* zq = zi + kWarpRows * kZStride;
#pragma unroll 1
  for (int mt = 0; mt < kMTiles; ++mt) {
    float acc_i[4] = {0.f, 0.f, 0.f, 0.f};
    float acc_q[4] = {0.f, 0.f, 0.f, 0.f};
    const short2* x0 = sh_x + (8 * warp + 16 * mt + g) * G::kXStride + tq;
    const short2* x1 = x0 + 8 * G::kXStride;
#pragma unroll
    for (int ks = 0; ks < G::kSteps; ++ks) {
      // A fragment: a0 (g, tq), a1 (g+8, tq), a2 (g, tq+4), a3 (g+8, tq+4)
      const short2 s[4] = {x0[8 * ks], x1[8 * ks], x0[8 * ks + 4], x1[8 * ks + 4]};
      uint32_t ai_hi[4], ai_lo[4], aq_hi[4], aq_lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split(s[e].x, ai_hi[e], ai_lo[e]);
        split(s[e].y, aq_hi[e], aq_lo[e]);
      }
      mma_tf32(acc_i, ai_hi, b_hi[ks][0], b_hi[ks][1]);
      mma_tf32(acc_i, ai_hi, b_lo[ks][0], b_lo[ks][1]);
      mma_tf32(acc_i, ai_lo, b_hi[ks][0], b_hi[ks][1]);
      mma_tf32(acc_q, aq_hi, b_hi[ks][0], b_hi[ks][1]);
      mma_tf32(acc_q, aq_hi, b_lo[ks][0], b_lo[ks][1]);
      mma_tf32(acc_q, aq_lo, b_hi[ks][0], b_hi[ks][1]);
    }
    // C fragment: c0 (g, 2tq), c1 (g, 2tq+1), c2 (g+8, 2tq), c3 (g+8, 2tq+1)
    const int r0 = (16 * mt + g) * kZStride + 2 * tq;
    const int r1 = r0 + 8 * kZStride;
    zi[r0] = acc_i[0];
    zi[r0 + 1] = acc_i[1];
    zi[r1] = acc_i[2];
    zi[r1 + 1] = acc_i[3];
    zq[r0] = acc_q[0];
    zq[r0 + 1] = acc_q[1];
    zq[r1] = acc_q[2];
    zq[r1 + 1] = acc_q[3];
  }
  __syncwarp();

  // this warp's share of output m: Σ_c Z[m + c][c]
  float part_i[kTileOut / 32], part_q[kTileOut / 32];
#pragma unroll
  for (int k = 0; k < kTileOut / 32; ++k) {
    const int m = lane + 32 * k;
    float si = 0.f, sq = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      si += zi[(m + c) * kZStride + c];
      sq += zq[(m + c) * kZStride + c];
    }
    part_i[k] = si;
    part_q[k] = sq;
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kTileOut / 32; ++k) {
    const int m = lane + 32 * k;
    zi[2 * m] = part_i[k];
    zi[2 * m + 1] = part_q[k];
  }
  __syncthreads();

  // the warps' shares in a fixed order: thread → (output m, plane p)
  const int m = threadIdx.x >> 1;
  const int p = threadIdx.x & 1;
  float y = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) y += sh_z[w * kZWarp + 2 * m + p];
  if (m0 + m < n_out) out[(m0 + m) * 2 + p] = y;
}

template <int kLog2>
cudaError_t launch(const void* ext, long long n_in, const float* legs, int t_leg,
                   long long n_out, void* out, cudaStream_t stream) {
  auto kernel = flat_decimate_tc_kernel<kLog2>;
  const size_t smem = Geom<kLog2>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (n_out + kTileOut - 1) / kTileOut;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const short2*>(ext), n_in, legs, t_leg, n_out, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs at r = 2^log2 (for error reports).
long long sdr_flat_decimate_tc_smem_bytes(int r) {
  switch (r) {
    case 2: return static_cast<long long>(Geom<1>::kSmem);
    case 4: return static_cast<long long>(Geom<2>::kSmem);
    case 8: return static_cast<long long>(Geom<3>::kSmem);
    case 16: return static_cast<long long>(Geom<4>::kSmem);
    case 32: return static_cast<long long>(Geom<5>::kSmem);
    case 64: return static_cast<long long>(Geom<6>::kSmem);
    default: return -1;
  }
}

// ext: (n_in, 2) int16; legs: (r, t_leg) float32, r in {2, ..., 64},
// t_leg ≤ 64; out: (n_out, 2) float32. Launches on `stream` and returns
// cudaGetLastError() of the launch (0 on success).
int sdr_flat_decimate_tc(const void* ext, long long n_in, const float* legs, int r,
                         int t_leg, void* out, long long n_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_leg < 1 || t_leg > kTapsPad) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (r) {
    case 2: err = launch<1>(ext, n_in, legs, t_leg, n_out, out, s); break;
    case 4: err = launch<2>(ext, n_in, legs, t_leg, n_out, out, s); break;
    case 8: err = launch<3>(ext, n_in, legs, t_leg, n_out, out, s); break;
    case 16: err = launch<4>(ext, n_in, legs, t_leg, n_out, out, s); break;
    case 32: err = launch<5>(ext, n_in, legs, t_leg, n_out, out, s); break;
    case 64: err = launch<6>(ext, n_in, legs, t_leg, n_out, out, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
