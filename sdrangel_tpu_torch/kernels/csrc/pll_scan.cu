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
// the end (S = 2, 4, 8: the JAX state tuples' fields in order). pll_run
// also takes two (T, C) float32 scratch arrays from its caller.
//
// What bounds it: neither bytes nor operations. Sample n+1's loop phase
// needs sample n's, so a channel is one serial chain of T steps, and the
// time is T times the latency of one step's critical path, whatever the
// channel count up to a warp's worth per scheduler (chip_smoke.py phase 9a
// reads that path from the built kernel's SASS and times the kernel beside
// it). Each serial kernel runs one thread per channel with the whole loop
// state in registers and walks the block in order; its input is read a
// chunk of samples ahead into registers, so the global-load latency
// overlaps the previous chunk's math and the chain waits on arithmetic
// latency alone. The hot loop has no per-sample bounds check, so its only
// branches are the math's own slow paths.
//
// pll_run is split so that the chain holds only the loop's own arithmetic.
// For x != 0, arg(x · conj(e^{jθ})) = wrap(arg x − θ): arg x depends on the
// input alone and the carrier e^{jθ[n]} on the phase sequence alone, so
// three launches on one stream do the work —
//   pll_detect_kernel   one thread per sample: θx = atan2f(x) into a (T, C)
//                       scratch (the chain's lanes then read consecutive
//                       addresses), an exact zero marked by kZeroMark;
//   pll_chain_kernel    one thread per channel: per step one subtract, the
//                       update's multiplies and adds and the subtract of π,
//                       the wrap and the floor-mod proven idle for a chunk
//                       of samples off the chain (a chunk where they act,
//                       as θ crosses ±π, runs again with compare and
//                       select, fmodf only beyond [−2π, 4π)); each
//                       pre-update θ to a second (T, C) scratch;
//   pll_carrier_kernel  one thread per sample: sincosf(θ[n]) into out.
// An exact-zero sample is the one input where the identity is false (the
// signs of the rotated zero's products make the error 0 or ±π, not −θ); the
// chain sends its chunk through the old detector on the slow path. The
// parallel passes move about
// 1.6 MB at 1 × 49,152, microseconds against the chain's milliseconds, so
// one launch with warp specialization would buy nothing at these channel
// counts. ref_pll_run and pilot_pll_run keep sincos on their chains:
// ref_pll_run is the test-only parity mode, whose K = 1000 loop would turn
// a detector that rounds differently into a different parity result, and
// the pilot loop multiplies x by sin θ and cos θ before a lowpass, which
// the identity does not take off.
//
// Numbers: every add, multiply and divide is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn), which nvcc never contracts
// into an FMA, so the kernels round where the plain PyTorch loops and the
// JAX scans round; sincosf and atan2f are CUDA's accurate (not fast-math)
// forms, the functions torch.sin, torch.cos and torch.atan2 use on the card
// (kernel and plain loop are bit-equal there) and within 1–2 ulp of the
// CPU's libm, and these last-ulp differences go round the loop (agreement,
// not bit equality, is the contract against the CPU and JAX). jnp.mod is a
// floor-mod built on the exact fmod; floor_mod does the same, and
// pll_run's fast path equals it bit for bit where it applies.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kUnroll = 8;
// pll_chain_kernel's chunk: 16 steps of ~50 cycles cover an L2 hit's latency (32
// ran faster at one channel but slower at 16, with twice the registers)
constexpr int kChainUnroll = 16;
constexpr int kSampleThreads = 256;  // pll_run's per-sample passes
constexpr float kZeroMark = 4.0f;    // θx of an exact-zero sample: outside atan2f's [−π, π]
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

// pll_run, split: (a) the phase detector's arg x, (b) the loop, (c) the
// carrier. The loop: err = wrap(arg x − θ) (the old detector on an exact
// zero); f += g2·err; θ = mod(θ + f + g1·err + π, 2π) − π; the carrier is
// e^{jθ} of the phase before each update.

// (a) θx[t][c] = atan2f(x[c][t]), or kZeroMark where x[c][t] == 0 exactly
__global__ void __launch_bounds__(kSampleThreads) pll_detect_kernel(
    const float2* __restrict__ x, float* __restrict__ theta_x, int channels, long long n) {
  const long long t = static_cast<long long>(blockIdx.x) * kSampleThreads + threadIdx.x;
  if (t >= n) return;
  for (int c = blockIdx.y; c < channels; c += gridDim.y) {
    const float2 v = x[c * n + t];
    theta_x[t * channels + c] = v.x == 0.0f && v.y == 0.0f ? kZeroMark : atan2f(v.y, v.x);
  }
}

// wrap(θx − θ) into [−π, π]: both candidates are computed before the
// select, so it compiles to compares and selects, not branches
__device__ __forceinline__ float wrapped_error(float tx, float phase) {
  const float e = sub(tx, phase);
  const float down = sub(e, kTwoPi), up = add(e, kTwoPi);
  return e > kPi ? down : (e < -kPi ? up : e);
}

// floor_mod(a, 2π) for a in (−2π, 4π), by compares and selects: on [0, 2π)
// it is a; on [2π, 4π) a − 2π, exact by Sterbenz and so fmodf's value; on
// (−2π, 0) fmodf returns a and floor_mod adds 2π. Bit-equal to floor_mod
// there; `near` says whether a lies there.
__device__ __forceinline__ bool near(float a) { return a > -kTwoPi && a < 2.0f * kTwoPi; }
__device__ __forceinline__ float mod_two_pi_near(float a) {
  const float up = add(a, kTwoPi), down = sub(a, kTwoPi);
  return a < 0.0f ? up : (a < kTwoPi ? a : down);
}

// The loop's update: f += g2·err; returns a = θ + f + g1·err + π, the
// floor-mod's argument (θ' = mod(a, 2π) − π)
__device__ __forceinline__ float advance(float err, float phase, float& freq, float g1, float g2) {
  freq = add(freq, mul(g2, err));
  return add(add(add(phase, freq), mul(g1, err)), kPi);
}

// m[0] = the largest of m[0 .. 2W), as a tree of maxima (no predicate
// chain), unrolled at compile time so that m stays in registers
template <int W>
__device__ __forceinline__ void fold_max(float (&m)[kChainUnroll]) {
#pragma unroll
  for (int u = 0; u < W; ++u) m[u] = fmaxf(m[u], m[u + W]);
  if constexpr (W > 1) fold_max<W / 2>(m);
}

// One chunk of non-zero samples through the loop from registers, each
// pre-update θ to out[u·stride]. kSelect false: the wrap and the floor-mod
// left out; true if they would have returned their arguments at every step
// (|err| ≤ π, a in [0, 2π)). kSelect true: both by compare and select; true
// if every a lay in (−2π, 4π). Maxima and minima off the chain keep the
// record; where the pass returns false, its state and stores are void.
template <bool kSelect>
__device__ __forceinline__ bool chunk_pass(const float (&tx)[kChainUnroll], float* out, int stride,
                                           float& phase, float& freq, float g1, float g2) {
  float err_max = 0.0f, a_min = 0.0f, a_max = 0.0f;
#pragma unroll
  for (int u = 0; u < kChainUnroll; ++u) {
    out[u * stride] = phase;
    const float err = kSelect ? wrapped_error(tx[u], phase) : sub(tx[u], phase);
    const float a = advance(err, phase, freq, g1, g2);
    phase = sub(kSelect ? mod_two_pi_near(a) : a, kPi);
    err_max = fmaxf(err_max, fabsf(err));
    a_min = fminf(a_min, a);
    a_max = fmaxf(a_max, a);
  }
  return kSelect ? a_min > -kTwoPi && a_max < 2.0f * kTwoPi
                 : err_max <= kPi && a_min >= 0.0f && a_max < kTwoPi;
}

// (b) one thread per channel over θx (T, C), writing each pre-update θ to
// theta (T, C): lanes of a warp are channels, on consecutive addresses.
// Compares cost the chain most: a compare feeding a select or a predicated
// add waits far longer than an add or a multiply (a chain of 13 links, two
// of them compares, modelled at 52 cycles, ran at 124.5 a step on an H100 in
// chip_smoke.py phase 9a). The wrap and the floor-mod change nothing except
// while θ crosses ±π, so each chunk of kChainUnroll samples runs at the
// cheapest of three tiers that holds, from its first sample each time:
//   1. adds and multiplies alone (chunk_pass<false>), the hot path;
//   2. the wrap and the floor-mod by compare and select (chunk_pass<true>),
//      for a chunk where θ crossed ±π;
//   3. sample by sample (exact_step): the old detector on an exact zero
//      (sincosf and the rotated product's atan2f) and fmodf beyond
//      [−2π, 4π) (a state far outside the loop's range).
// Tiers 2 and 3 run inside a loop over the tiers, off the hot path. The
// next chunk's θx is read into registers while this one runs.
__global__ void __launch_bounds__(kThreads) pll_chain_kernel(
    const float* __restrict__ theta_x, const float2* __restrict__ x, float* __restrict__ theta,
    float* __restrict__ state, int channels, long long n, float g1, float g2) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= channels) return;
  const float* col = theta_x + c;
  float* col_out = theta + c;
  float phase = state[c], freq = state[channels + c];
  const auto exact_step = [&](long long i) {
    const float tx = col[i * channels];
    float err;
    if (tx == kZeroMark) {
      float s, co;
      sincosf(phase, &s, &co);
      err = phase_error(x[c * n + i], co, s);
    } else {
      err = wrapped_error(tx, phase);
    }
    col_out[i * channels] = phase;
    const float a = advance(err, phase, freq, g1, g2);
    phase = sub(near(a) ? mod_two_pi_near(a) : floor_mod(a, kTwoPi), kPi);
  };
  const auto load = [&](float (&dst)[kChainUnroll], long long base) {
    const float* src = col + base * channels;
#pragma unroll
    for (int u = 0; u < kChainUnroll; ++u) dst[u] = src[u * channels];
  };
  const long long whole = n / kChainUnroll * kChainUnroll;
  float cur[kChainUnroll];
  if (whole > 0) load(cur, 0);
  for (long long base = 0; base < whole; base += kChainUnroll) {
    float next[kChainUnroll];  // the last chunk again at the end: read, not used
    load(next, base + kChainUnroll < whole ? base + kChainUnroll : base);
    float* out = col_out + base * channels;
    const float phase0 = phase, freq0 = freq;
    float m[kChainUnroll];
#pragma unroll
    for (int u = 0; u < kChainUnroll; ++u) m[u] = cur[u];
    fold_max<kChainUnroll / 2>(m);
    const bool zero = m[0] >= kZeroMark;  // θx is kZeroMark or within [−π, π]
    bool held = !zero && chunk_pass<false>(cur, out, channels, phase, freq, g1, g2);
#pragma unroll 1
    for (int tier = zero ? 3 : 2; !held; ++tier) {
      phase = phase0;
      freq = freq0;
      if (tier == 2) {
        held = chunk_pass<true>(cur, out, channels, phase, freq, g1, g2);
      } else {
#pragma unroll 1
        for (int u = 0; u < kChainUnroll; ++u) exact_step(base + u);
        held = true;
      }
    }
#pragma unroll
    for (int u = 0; u < kChainUnroll; ++u) cur[u] = next[u];
  }
  for (long long i = whole; i < n; ++i) exact_step(i);
  state[c] = phase;
  state[channels + c] = freq;
}

// (c) out[c][t] = e^{jθ[t][c]}
__global__ void __launch_bounds__(kSampleThreads) pll_carrier_kernel(
    const float* __restrict__ theta, float2* __restrict__ out, int channels, long long n) {
  const long long t = static_cast<long long>(blockIdx.x) * kSampleThreads + threadIdx.x;
  if (t >= n) return;
  for (int c = blockIdx.y; c < channels; c += gridDim.y) {
    float s, co;
    sincosf(theta[t * channels + c], &s, &co);
    out[c * n + t] = make_float2(co, s);
  }
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
// updated in place. sdr_pll_run launches its three kernels in turn and
// stops at the first refused; theta_x and theta are (n, channels) float32
// scratch.
int sdr_pll_run(const void* x, void* out, float* state, float* theta_x, float* theta,
                int channels, long long n, float g1, float g2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* in = static_cast<const float2*>(x);
  const dim3 samples(static_cast<unsigned>((n + kSampleThreads - 1) / kSampleThreads),
                     static_cast<unsigned>(channels < 65535 ? channels : 65535));
  if (n > 0) {
    pll_detect_kernel<<<samples, kSampleThreads, 0, s>>>(in, theta_x, channels, n);
    if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  }
  pll_chain_kernel<<<grid(channels), kThreads, 0, s>>>(theta_x, in, theta, state, channels, n,
                                                       g1, g2);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  if (n > 0) {
    pll_carrier_kernel<<<samples, kSampleThreads, 0, s>>>(theta, static_cast<float2*>(out),
                                                          channels, n);
  }
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
