// K1 — the flat ÷2^k decimator for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels sdrangel_tpu/pallas/decimator.py
// decimate_cascade_fused (VPU form) and decimate_cascade_fused_mxu (matrix-unit
// form): the whole order-64 half-band ÷2^k cascade folded into one composed
// filter h_eq = h ∗ h↑2 ∗ …, split into r = 2^k polyphase legs (r, t_leg).
//
// Contract: ext is [carried tail | block] as interleaved (N, 2) I/Q, with
// N = T + r·(t_leg − 1); output m (of T/r) is
//     y[m] = Σ_t Σ_j legs[j, t] · ext[r·(m + t) + j]
//          = Σ_i h[i] · ext[r·m + i],   h[i] = legs[i mod r, i div r],
// a stride-r FIR of L = r·t_leg taps over contiguous input. Real legs act on
// I and Q alike; complex legs (inf/sup placements) give
//     y_re = Lr·x_re − Li·x_im,   y_im = Li·x_re + Lr·x_im.
// int16 input is scaled by `scale` while it is staged (the i16 ingest
// 1/32768 fused in), so the card reads the 4 B/sample capture once.
//
// What bounds it on an H100: at ÷64 each complex input sample costs
// 2·63 = 126 FMA against 4 bytes read (~63 FLOP/B, above the ~20 FLOP/B FP32
// ridge), so the arithmetic, and before it the shared-memory loads that feed
// it, bound the kernel, not HBM. The design keeps every operand in shared
// memory and avoids bank conflicts:
//   * a block owns kTileOut consecutive outputs; it stages their whole input
//     window (r·(kTileOut−1) + L samples, as float2) and the taps once;
//   * warp lanes run over the tap index i, so at each step the 32 lanes read
//     32 consecutive float2 samples (conflict-free) — "one thread per output"
//     would put a whole warp on one bank at r = 64;
//   * each warp accumulates kOutPerWarp outputs at once, so one tap load from
//     shared memory feeds kOutPerWarp sample loads and FMAs;
//   * the 32 lane partial sums of an output are combined with __shfl_xor_sync.
// Shared memory is ~80 KB (real legs) / ~97 KB (complex legs) at r = 64, so
// the launch raises the dynamic shared-memory limit past 48 KB.
// Left for later work: the tensor-core form (the counterpart of the MXU
// kernel, needing a 3xTF32 split to keep f32 fidelity) and the staged cascade
// with L2-resident intermediates (~3.7x fewer MACs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOutPerWarp = 8;
constexpr int kTileOut = kWarps * kOutPerWarp;  // outputs per block

__device__ __forceinline__ float2 load_sample(const short2* p, long long i, float scale) {
  short2 v = p[i];
  return make_float2(static_cast<float>(v.x) * scale, static_cast<float>(v.y) * scale);
}

__device__ __forceinline__ float2 load_sample(const float2* p, long long i, float) {
  return p[i];
}

template <typename In, bool kComplex>
__global__ void __launch_bounds__(kThreads)
flat_decimate_kernel(const In* __restrict__ ext, long long n_in,
                     const float* __restrict__ legs_re,
                     const float* __restrict__ legs_im, int r, int t_leg,
                     int n_taps_pad, long long n_out, float scale,
                     float2* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int win = r * (kTileOut - 1) + n_taps_pad;
  float2* sh_x = reinterpret_cast<float2*>(smem);
  float* sh_hr = reinterpret_cast<float*>(sh_x + win);
  float* sh_hi = sh_hr + n_taps_pad;  // used only with complex legs

  const long long m0 = static_cast<long long>(blockIdx.x) * kTileOut;
  const long long base = m0 * r;
  for (int s = threadIdx.x; s < win; s += kThreads) {
    const long long idx = base + s;
    sh_x[s] = idx < n_in ? load_sample(ext, idx, scale) : make_float2(0.f, 0.f);
  }
  const int n_taps = r * t_leg;
  for (int i = threadIdx.x; i < n_taps_pad; i += kThreads) {
    float hr = 0.f, hi = 0.f;
    if (i < n_taps) {
      const int t = i / r;
      const int j = i - t * r;
      hr = legs_re[j * t_leg + t];
      if (kComplex) hi = legs_im[j * t_leg + t];
    }
    sh_hr[i] = hr;
    if (kComplex) sh_hi[i] = hi;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc_re[kOutPerWarp], acc_im[kOutPerWarp];
#pragma unroll
  for (int b = 0; b < kOutPerWarp; ++b) acc_re[b] = acc_im[b] = 0.f;

  // this warp's outputs: local index o = warp + kWarps·b, input offset o·r
  const float2* xw = sh_x + warp * r;
  const int out_stride = kWarps * r;
  for (int i = lane; i < n_taps_pad; i += 32) {
    const float hr = sh_hr[i];
    const float hi = kComplex ? sh_hi[i] : 0.f;
#pragma unroll
    for (int b = 0; b < kOutPerWarp; ++b) {
      const float2 v = xw[b * out_stride + i];
      if (kComplex) {
        acc_re[b] = fmaf(hr, v.x, fmaf(-hi, v.y, acc_re[b]));
        acc_im[b] = fmaf(hi, v.x, fmaf(hr, v.y, acc_im[b]));
      } else {
        acc_re[b] = fmaf(hr, v.x, acc_re[b]);
        acc_im[b] = fmaf(hr, v.y, acc_im[b]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kOutPerWarp; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc_re[b] += __shfl_xor_sync(0xffffffffu, acc_re[b], off);
      acc_im[b] += __shfl_xor_sync(0xffffffffu, acc_im[b], off);
    }
  }
#pragma unroll
  for (int b = 0; b < kOutPerWarp; ++b) {
    const long long m = m0 + warp + kWarps * b;
    if (lane == b && m < n_out) out[m] = make_float2(acc_re[b], acc_im[b]);
  }
}

template <typename In, bool kComplex>
cudaError_t launch(const void* ext, long long n_in, const float* legs_re,
                   const float* legs_im, int r, int t_leg, long long n_out,
                   float scale, void* out, cudaStream_t stream) {
  const int n_taps_pad = (r * t_leg + 31) / 32 * 32;
  const int win = r * (kTileOut - 1) + n_taps_pad;
  const size_t smem = static_cast<size_t>(win) * sizeof(float2) +
                      static_cast<size_t>(n_taps_pad) * sizeof(float) * (kComplex ? 2 : 1);
  auto kernel = flat_decimate_kernel<In, kComplex>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (n_out + kTileOut - 1) / kTileOut;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const In*>(ext), n_in, legs_re, legs_im, r, t_leg, n_taps_pad,
      n_out, scale, static_cast<float2*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sdr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one launch needs, in bytes (for error reports).
long long sdr_flat_decimate_smem_bytes(int r, int t_leg, int complex_legs) {
  const long long n_taps_pad = (static_cast<long long>(r) * t_leg + 31) / 32 * 32;
  const long long win = static_cast<long long>(r) * (kTileOut - 1) + n_taps_pad;
  return win * 8 + n_taps_pad * 4 * (complex_legs ? 2 : 1);
}

// ext: (n_in, 2) int16 (in_is_i16 != 0) or float32; legs: (r, t_leg) float32,
// legs_im null for real legs; out: (n_out, 2) float32. Launches on `stream`
// and returns cudaGetLastError() of the launch (0 on success).
int sdr_flat_decimate(int in_is_i16, const void* ext, long long n_in,
                      const float* legs_re, const float* legs_im, int r, int t_leg,
                      float scale, void* out, long long n_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_is_i16) {
    err = legs_im ? launch<short2, true>(ext, n_in, legs_re, legs_im, r, t_leg, n_out, scale, out, s)
                  : launch<short2, false>(ext, n_in, legs_re, legs_im, r, t_leg, n_out, scale, out, s);
  } else {
    err = legs_im ? launch<float2, true>(ext, n_in, legs_re, legs_im, r, t_leg, n_out, scale, out, s)
                  : launch<float2, false>(ext, n_in, legs_re, legs_im, r, t_leg, n_out, scale, out, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
