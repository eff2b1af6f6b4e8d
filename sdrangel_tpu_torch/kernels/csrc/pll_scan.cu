// K-PLL — the per-sample phase-locked loops for Hopper (sm_90a).
//
// Replaces the lax.scan recurrences of sdrangel_tpu/dsp/phaselock.py (no
// Pallas kernel; XLA ran them as a serial scan): pll_run (:33-62, the
// 2nd-order loop of synchronous AM), ref_pll_run (:79-130, PhaseLockComplex's
// active-PI biquad with the ±2π register rescaling) and pilot_pll_run
// (:150-215, the 19 kHz 4th-order pilot loop of broadcast FM stereo).
//
// Contract: x (C, T) row-major — complex64 as float2 for the two complex
// loops, float32 for the pilot loop; out (C, T) of the same layout (the
// carrier e^{jθ} as float2, or the pilot loop's pre-update phases as
// float32); state (S, C) float32, read at the start and written back at
// the end (S = 2, 4, 8: the JAX state tuples' fields in order).
//
// What bounds it: neither bytes nor operations. Sample n+1's loop phase
// needs sample n's, so a channel is one serial chain of T steps, each a
// dependent sincos → complex multiply → atan2 → loop-filter update. The
// kernel runs one thread per channel with the whole loop state in registers
// and walks the block in order; the input is read kUnroll samples ahead
// into registers, so the global-load latency overlaps the previous chunk's
// math and the chain waits on arithmetic latency alone. The time is T times
// the latency of one step's critical path, whatever the channel count up to
// a warp's worth per scheduler (chip_smoke.py phase 9a reads that path from
// the built kernel's SASS and times the kernel beside it). The hot loop has
// no per-sample bounds check, so its only branches are the math's own slow
// paths (sincosf's large-argument reduction, fmodf's long division, the
// division's special cases).
//
// Numbers: every add, multiply and divide is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn), which nvcc never contracts
// into an FMA, so the kernel rounds where the plain PyTorch loop and the
// JAX scan round; sincosf and atan2f are CUDA's accurate (not fast-math)
// forms, within 1–2 ulp of the CPU's libm, and these last-ulp differences
// go round the loop (agreement, not bit equality, is the contract). jnp.mod
// is a floor-mod built on the exact fmod; floor_mod does the same.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kUnroll = 8;
constexpr float kPi = 3.14159274101257324f;     // float32(π), as JAX's weak-typed np.pi
constexpr float kTwoPi = 6.28318548202514648f;  // float32(2π)

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// jnp.mod(x, y) for y > 0: the exact fmod, moved into [0, y)
__device__ __forceinline__ float floor_mod(float x, float y) {
  const float r = fmodf(x, y);
  return r < 0.0f ? add(r, y) : r;
}

// arg(x · conj(e^{jθ})) from x and (cos θ, sin θ)
__device__ __forceinline__ float phase_error(float2 x, float c, float s) {
  const float re = add(mul(x.x, c), mul(x.y, s));
  const float im = sub(mul(x.y, c), mul(x.x, s));
  return atan2f(im, re);
}

// The next kUnroll samples of a row (zero past its end), issued before the
// current chunk's math so their latency hides behind it.
template <typename T>
__device__ __forceinline__ void load_chunk(T (&dst)[kUnroll], const T* __restrict__ row,
                                           long long base, long long n) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) dst[u] = base + u < n ? row[base + u] : T{};
}

// Walks one row: step(sample, index) for each sample in order. The whole
// chunks run with no per-sample bounds check (the hot loop's only branches
// are the math's own slow paths); the ragged end reads its samples directly.
template <typename T, typename Step>
__device__ __forceinline__ void walk(const T* __restrict__ row, long long n, Step&& step) {
  const long long whole = n / kUnroll * kUnroll;
  T cur[kUnroll];
  load_chunk(cur, row, 0, n);
  for (long long base = 0; base < whole; base += kUnroll) {
    T next[kUnroll];
    load_chunk(next, row, base + kUnroll, n);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) step(cur[u], base + u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = next[u];
  }
  for (long long i = whole; i < n; ++i) step(row[i], i);
}

// pll_run: ref = e^{jθ}; err = arg(x·conj(ref)); f += g2·err;
// θ = mod(θ + f + g1·err + π, 2π) − π. Emits ref before the update.
__global__ void __launch_bounds__(kThreads) pll_kernel(
    const float2* __restrict__ x, float2* __restrict__ out, float* __restrict__ state, int channels,
    long long n, float g1, float g2) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= channels) return;
  float phase = state[c], freq = state[channels + c];
  float2* row_out = out + c * n;
  walk(x + c * n, n, [&](float2 xi, long long i) {
    float s, co;
    sincosf(phase, &s, &co);
    row_out[i] = make_float2(co, s);
    const float err = phase_error(xi, co, s);
    freq = add(freq, mul(g2, err));
    phase = add(add(phase, freq), mul(g1, err));
    phase = sub(floor_mod(add(phase, kPi), kTwoPi), kPi);
  });
  state[c] = phase;
  state[channels + c] = freq;
}

// ref_pll_run: y = e^{jφ} (emitted first); the active-PI biquad on
// arg(x·conj(y)); registers rescaled so φ wraps by 2π (phaselockcomplex.cpp).
__global__ void __launch_bounds__(kThreads) ref_pll_kernel(
    const float2* __restrict__ x, float2* __restrict__ out, float* __restrict__ state, int channels,
    long long n, float b0, float b1, float b2, float a1, float a2) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= channels) return;
  float v0 = state[c], v1 = state[channels + c], v2 = state[2 * channels + c];
  float phi = state[3 * channels + c];
  float2* row_out = out + c * n;
  walk(x + c * n, n, [&](float2 xi, long long i) {
    float s, co;
    sincosf(phi, &s, &co);
    row_out[i] = make_float2(co, s);
    const float dphi = phase_error(xi, co, s);
    const float v2n = v1, v1n = v0;
    const float v0n = sub(sub(dphi, mul(v1n, a1)), mul(v2n, a2));
    float phin = add(add(mul(v0n, b0), mul(v1n, b1)), mul(v2n, b2));
    const float safe = phin == 0.0f ? 1.0f : phin;
    float scale = 1.0f;
    if (phin > kTwoPi) {
      scale = __fdiv_rn(sub(phin, kTwoPi), safe);
      phin = sub(phin, kTwoPi);
    } else if (phin < -kTwoPi) {
      scale = __fdiv_rn(add(phin, kTwoPi), safe);
      phin = add(phin, kTwoPi);
    }
    v0 = mul(v0n, scale);
    v1 = mul(v1n, scale);
    v2 = mul(v2n, scale);
    phi = phin;
  });
  state[c] = v0;
  state[channels + c] = v1;
  state[2 * channels + c] = v2;
  state[3 * channels + c] = phi;
}

// pilot_pll_run: the I/Q phase detector through the 2-pole lowpass, the
// clamped-arctan error, the 1st-order loop filter and the clamped
// frequency; emits the pre-update phase (phaselock.cpp:24-230).
__global__ void __launch_bounds__(kThreads) pilot_pll_kernel(
    const float* __restrict__ x, float* __restrict__ out, float* __restrict__ state, int channels,
    long long n, float pb0, float pa1, float pa2, float lf_b0, float lf_b1, float w_lo,
    float w_hi) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= channels) return;
  float r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = state[k * channels + c];
  float phase = r[0], freq = r[1], i1 = r[2], i2 = r[3], q1 = r[4], q2 = r[5], x1 = r[6],
        lock = r[7];
  float* row_out = out + c * n;
  walk(x + c * n, n, [&](float xi, long long i) {
    row_out[i] = phase;
    float ps, pc;
    sincosf(phase, &ps, &pc);
    const float fi = sub(sub(mul(pb0, mul(ps, xi)), mul(pa1, i1)), mul(pa2, i2));
    const float fq = sub(sub(mul(pb0, mul(pc, xi)), mul(pa1, q1)), mul(pa2, q2));
    i2 = i1;
    i1 = fi;
    q2 = q1;
    q1 = fq;
    const float err = fi > fabsf(fq) ? __fdiv_rn(fq, fmaxf(fi, 1e-20f))
                                     : (fq > 0.0f ? 1.0f : -1.0f);
    lock = add(mul(0.999f, lock), mul(0.001f, fi));
    freq = fminf(fmaxf(add(add(freq, mul(lf_b0, err)), mul(lf_b1, x1)), w_lo), w_hi);
    x1 = err;
    phase = floor_mod(add(phase, freq), kTwoPi);
  });
  const float w[8] = {phase, freq, i1, i2, q1, q2, x1, lock};
#pragma unroll
  for (int k = 0; k < 8; ++k) state[k * channels + c] = w[k];
}

unsigned grid(int channels) { return static_cast<unsigned>((channels + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() of the launch
// (0 on success). x, out: (channels, n) rows; state: (S, channels) float32,
// updated in place.
int sdr_pll_run(const void* x, void* out, float* state, int channels, long long n, float g1,
                float g2, void* stream) {
  pll_kernel<<<grid(channels), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(out), state, channels, n, g1, g2);
  return static_cast<int>(cudaGetLastError());
}

int sdr_ref_pll_run(const void* x, void* out, float* state, int channels, long long n, float b0,
                    float b1, float b2, float a1, float a2, void* stream) {
  ref_pll_kernel<<<grid(channels), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(out), state, channels, n, b0, b1, b2,
      a1, a2);
  return static_cast<int>(cudaGetLastError());
}

int sdr_pilot_pll_run(const float* x, float* out, float* state, int channels, long long n,
                      float pb0, float pa1, float pa2, float lf_b0, float lf_b1, float w_lo,
                      float w_hi, void* stream) {
  pilot_pll_kernel<<<grid(channels), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, state, channels, n, pb0, pa1, pa2, lf_b0, lf_b1, w_lo, w_hi);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
