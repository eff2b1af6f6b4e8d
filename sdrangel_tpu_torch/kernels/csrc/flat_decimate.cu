// K1 — the flat ÷2^k decimator for Hopper (sm_90a), on the FP32 cores.
//
// Replaces the Pallas TPU kernel sdrangel_tpu/pallas/decimator.py:94
// decimate_cascade_fused (VPU form): the whole order-64 half-band ÷2^k
// cascade folded into one composed filter h_eq = h ∗ h↑2 ∗ …, split into
// r = 2^k polyphase legs (r, t_leg), 2 ≤ r ≤ 64.
//
// Contract: ext = [carried tail | block], interleaved (N, 2) I/Q, given as
// two pointers — tail (r·(t_leg − 1) pairs, a whole number of plane rows)
// and block (T pairs) — so a caller never copies the block to put the tail
// in front of it; N = T + r·(t_leg − 1). Output m (of T/r) is
//     y[m] = Σ_j Σ_t legs[j, t] · x_j[m + t],   x_j[w] = ext[r·w + j],
// the polyphase form of a stride-r FIR of r·t_leg taps. Real legs act on I
// and Q alike; complex legs (inf/sup placements) give
//     y_re = Lr·x_re − Li·x_im,   y_im = Li·x_re + Lr·x_im.
// int16 input is staged as it is (short2) and converted in registers; the
// 1/32768 of the i16 ingest is folded into the staged legs (a power of two,
// so every product is the same as scaling the sample), and the card reads
// the 4 B/sample capture once.
//
// What bounds it on an H100: operations. At ÷64 each output costs
// 2·64·63 FMA (4·64·63 with complex legs) against 4·64 bytes read, ~63
// FLOP/B, far above the ~20 FLOP/B FP32 ridge. The product block (160,000
// outputs) is 2.58 GFLOP, 0.0385 ms at 67 TFLOP/s. The design keeps the
// FP32 pipes fed from registers:
//   * a thread owns kOut = 16 consecutive outputs of one polyphase leg j
//     (two legs in turn at r = 64) and keeps their 2·kOut I/Q partial sums
//     and a window of kOut plane samples in registers; per tap it loads one
//     tap and one new sample from shared memory and issues 2·kOut FMA
//     (4·kOut with complex legs) — the window slides through a register
//     ring unrolled by kOut, so no register moves;
//   * lanes run over the legs (kLegLanes = min(r, 32)) and, for r < 32,
//     over kGroups = 32/r output groups; the sum over legs is a recursive
//     halving across the leg lanes (__shfl_xor_sync), after which each lane
//     holds finished sums and the warp stores 32 consecutive floats;
//   * every output is summed the same way wherever it lies in a tile —
//     taps ascending per leg, the legs of a thread in turn, then the same
//     lane tree — so streamed blocks equal one long block bit for bit;
//   * shared memory holds a block's window of plane rows, filled with
//     cp.async (16-byte copies; 8- or 4-byte ones where the tail's or the
//     block's address allows no more; zero-fill past the input), with one
//     unused row after every kOut rows: a warp's lanes then read 32
//     different banks at every ratio (at r < 16 the output groups, kOut·r
//     samples apart, would otherwise share banks), and the legs transposed
//     to [t][j] with a pitch of r + 1 (conflict-free both to write and to
//     read), zero-padded to a multiple of kOut taps.
// Per tap and thread: 1 sample and 1 tap load for 32 FMA (real legs), so
// the shared-memory traffic of the product block is ~0.3 GB against the
// 5.2 GB of the lanes-over-taps form it replaces.
// Shared memory at r = 64: 34 KB of window (int16; 69 KB float32) plus
// 17 KB of legs (33 KB complex): 51 KB to 102 KB, 2 to 4 blocks of 4 warps
// per SM. Each block stages its own window and legs, then computes: the
// resident blocks overlap one another's loads with their math.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kOut = 16;  // consecutive outputs of one thread and leg
static_assert(2 * kOut >= 32, "the sum over 32 leg lanes leaves a value in each lane");

template <typename In, int kLog2, bool kComplex>
struct Variant {
  using Input = In;
  using Tap = std::conditional_t<kComplex, float2, float>;
  static constexpr bool kCplx = kComplex;
  static constexpr int r = 1 << kLog2;
  static constexpr int kLegLanes = r < 32 ? r : 32;   // lanes over the legs
  static constexpr int kGroups = 32 / kLegLanes;      // output groups of a warp
  static constexpr int kLegIters = r / kLegLanes;     // legs of a thread
  static constexpr int kTileOut = kWarps * kGroups * kOut;
  static constexpr int kVals = 2 * kOut / kLegLanes;  // finished sums of a lane
  static constexpr int kTapPitch = r + 1;
  static constexpr int kRowBytes = r * static_cast<int>(sizeof(In));
  static constexpr int kChunk = kRowBytes < 16 ? kRowBytes : 16;  // bytes per copy
  static constexpr int kChunksPerRow = kRowBytes / kChunk;

  static int taps_pad(int t_leg) { return (t_leg + kOut - 1) / kOut * kOut; }
  // plane rows of a tile's window, and their slots (one unused slot after
  // every kOut rows)
  __host__ __device__ static int rows(int t_pad) { return kTileOut + t_pad - 1; }
  __host__ __device__ static int slots(int t_pad) {
    return rows(t_pad) + (rows(t_pad) - 1) / kOut;
  }
  static size_t smem_bytes(int t_pad) {
    return static_cast<size_t>(slots(t_pad)) * kRowBytes +
           static_cast<size_t>(t_pad) * kTapPitch * sizeof(Tap);
  }
};

__device__ __forceinline__ float2 to_float2(short2 v) {
  return make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
}
__device__ __forceinline__ float2 to_float2(float2 v) { return v; }

// y += h · v for output k: I and Q with real legs, re and im with complex
__device__ __forceinline__ void mac(float& y0, float& y1, float h, float2 v) {
  y0 = fmaf(h, v.x, y0);
  y1 = fmaf(h, v.y, y1);
}
__device__ __forceinline__ void mac(float& y0, float& y1, float2 h, float2 v) {
  y0 = fmaf(-h.y, v.y, fmaf(h.x, v.x, y0));
  y1 = fmaf(h.y, v.x, fmaf(h.x, v.y, y1));
}

// cp.async of N bytes; src_bytes = 0 fills the destination with zeros
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const char* src, uint32_t src_bytes) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(N), "r"(src_bytes) : "memory");
  }
}

// one copy of kChunk bytes as copies of the widest size `align` allows
template <int kChunk>
__device__ __forceinline__ void copy_chunk(uint32_t dst, const char* src, bool valid, int align) {
  if (kChunk == 16 && align >= 16) {
    cp_async<16>(dst, src, valid ? 16 : 0);
  } else if (kChunk >= 8 && align >= 8) {
#pragma unroll
    for (int o = 0; o < kChunk; o += 8) cp_async<8>(dst + o, src + o, valid ? 8 : 0);
  } else {
#pragma unroll
    for (int o = 0; o < kChunk; o += 4) cp_async<4>(dst + o, src + o, valid ? 4 : 0);
  }
}

__device__ __forceinline__ int alignment(const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : 4;
}

// the sum over kLanes leg lanes by recursive halving: at each step a lane
// keeps half of its kN values, adds its partner's share of that half and
// sends the other half; lane jl ends with values [kN'·jl, kN'·(jl + 1))
template <int kLanes, int kN>
__device__ __forceinline__ void reduce_legs(float (&acc)[2 * kOut], int jl) {
  if constexpr (kLanes > 1) {
    constexpr int o = kLanes / 2;
    constexpr int half = kN / 2;
    const bool upper = (jl & o) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? acc[i] : acc[half + i];
      const float keep = upper ? acc[half + i] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    reduce_legs<o, half>(acc, jl);
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
flat_decimate_kernel(const typename V::Input* __restrict__ tail, long long tail_rows,
                     const typename V::Input* __restrict__ block, long long block_rows,
                     const float* __restrict__ legs_re, const float* __restrict__ legs_im,
                     int t_leg, int t_pad, float scale, long long n_out,
                     float* __restrict__ out) {
  using In = typename V::Input;
  using Tap = typename V::Tap;
  constexpr int r = V::r;
  extern __shared__ float4 smem[];
  In* sh_x = reinterpret_cast<In*>(smem);                        // [slots][r]
  Tap* sh_h = reinterpret_cast<Tap*>(sh_x + V::slots(t_pad) * r);  // [t_pad][r + 1]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * V::kTileOut;

  // the window: plane rows row0 + [0, rows) of ext, row w at slot w + w/kOut
  {
    const int rows = V::rows(t_pad);
    const int n_tail = static_cast<int>(max(0LL, min(static_cast<long long>(rows),
                                                     tail_rows - row0)));
    const int n_valid = static_cast<int>(max(0LL, min(static_cast<long long>(rows),
                                                      tail_rows + block_rows - row0)));
    const char* tail_base = reinterpret_cast<const char*>(tail) + row0 * V::kRowBytes;
    const char* block_base = reinterpret_cast<const char*>(block) + (row0 - tail_rows) * V::kRowBytes;
    const int align_tail = alignment(tail);
    const int align_block = alignment(block);
    const uint32_t x_base = static_cast<uint32_t>(__cvta_generic_to_shared(sh_x));
    for (int i = tid; i < rows * V::kChunksPerRow; i += kThreads) {
      const int w = i / V::kChunksPerRow;
      const int off = w * V::kRowBytes + (i % V::kChunksPerRow) * V::kChunk;
      const bool in_tail = w < n_tail;
      const bool valid = w < n_valid;
      const char* src = valid ? (in_tail ? tail_base : block_base) + off
                              : reinterpret_cast<const char*>(block);
      copy_chunk<V::kChunk>(x_base + static_cast<uint32_t>((w / kOut) * V::kRowBytes + off),
                            src, valid, in_tail ? align_tail : align_block);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // the legs, transposed to [t][j], scaled, zero from t_leg to t_pad
  for (int j = warp; j < r; j += kWarps) {
    for (int t = lane; t < t_pad; t += 32) {
      const bool live = t < t_leg;
      const float hr = live ? legs_re[j * t_leg + t] * scale : 0.f;
      if constexpr (V::kCplx) {
        const float hi = live ? legs_im[j * t_leg + t] * scale : 0.f;
        sh_h[t * V::kTapPitch + j] = make_float2(hr, hi);
      } else {
        sh_h[t * V::kTapPitch + j] = hr;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int jl = lane & (V::kLegLanes - 1);  // leg lane
  const int ol = lane / V::kLegLanes;        // output group within the warp
  const int g0 = (warp * V::kGroups + ol) * kOut;  // the group's first output in the tile
  const In* xg = sh_x + (g0 + g0 / kOut) * r + jl;
  const Tap* hg = sh_h + jl;
  float acc[2 * kOut];
#pragma unroll
  for (int v = 0; v < 2 * kOut; ++v) acc[v] = 0.f;

#pragma unroll
  for (int li = 0; li < V::kLegIters; ++li) {
    const In* xs = xg + 32 * li;  // leg j = jl + 32·li
    const Tap* hs = hg + 32 * li;
    // win[u % kOut] holds plane sample x_j[g0 + u] (u rows from the group's first)
    float2 win[kOut];
#pragma unroll
    for (int u = 0; u < kOut - 1; ++u) win[u] = to_float2(xs[u * r]);
#pragma unroll 1
    for (int tc = 0; tc < t_pad; tc += kOut) {
      const In* xc = xs + (tc + tc / kOut) * r;
      const Tap* hc = hs + tc * V::kTapPitch;
#pragma unroll
      for (int tt = 0; tt < kOut; ++tt) {
        constexpr int kLast = kOut - 1;
        const int u = tt + kLast;  // the new sample, rows from the chunk's first
        win[u % kOut] = to_float2(xc[(u + u / kOut) * r]);
        const Tap h = hc[tt * V::kTapPitch];
#pragma unroll
        for (int k = 0; k < kOut; ++k) mac(acc[2 * k], acc[2 * k + 1], h, win[(tt + k) % kOut]);
      }
    }
  }

  reduce_legs<V::kLegLanes, 2 * kOut>(acc, jl);
  // lane jl holds values v = kVals·jl + i, v = 2·(output − first) + plane
  const long long m0 = row0 + g0;
#pragma unroll
  for (int i = 0; i < V::kVals; ++i) {
    const int v = V::kVals * jl + i;
    if (m0 + v / 2 < n_out) out[2 * m0 + v] = acc[i];
  }
}

template <typename V>
cudaError_t prepare(int t_leg, size_t* smem, int* blocks_per_sm) {
  *smem = V::smem_bytes(V::taps_pad(t_leg));
  auto kernel = flat_decimate_kernel<V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
  if (err != cudaSuccess || blocks_per_sm == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, *smem);
}

template <typename V>
cudaError_t launch(const void* tail, long long tail_pairs, const void* block,
                   long long block_pairs, const float* legs_re, const float* legs_im,
                   int t_leg, float scale, void* out, long long n_out, cudaStream_t stream) {
  constexpr int r = V::r;
  if (tail_pairs % r || block_pairs % r || tail_pairs / r != t_leg - 1)
    return cudaErrorInvalidValue;
  if (n_out <= 0) return cudaSuccess;
  size_t smem = 0;
  cudaError_t err = prepare<V>(t_leg, &smem, nullptr);
  if (err != cudaSuccess) return err;
  const long long blocks = (n_out + V::kTileOut - 1) / V::kTileOut;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  using In = typename V::Input;
  flat_decimate_kernel<V><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const In*>(tail), tail_pairs / r, static_cast<const In*>(block),
      block_pairs / r, legs_re, legs_im, t_leg, V::taps_pad(t_leg), scale, n_out,
      static_cast<float*>(out));
  return cudaGetLastError();
}

// f(Variant<In, log2 r, complex legs>{}) for the variant the arguments name
template <typename In, bool kComplex, typename F>
cudaError_t by_ratio(int r, F&& f) {
  switch (r) {
    case 2: return f(Variant<In, 1, kComplex>{});
    case 4: return f(Variant<In, 2, kComplex>{});
    case 8: return f(Variant<In, 3, kComplex>{});
    case 16: return f(Variant<In, 4, kComplex>{});
    case 32: return f(Variant<In, 5, kComplex>{});
    case 64: return f(Variant<In, 6, kComplex>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t dispatch(int in_is_i16, int r, int complex_legs, F&& f) {
  if (in_is_i16) {
    return complex_legs ? by_ratio<short2, true>(r, f) : by_ratio<short2, false>(r, f);
  }
  return complex_legs ? by_ratio<float2, true>(r, f) : by_ratio<float2, false>(r, f);
}

}  // namespace

extern "C" {

const char* sdr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block, in bytes (−1 for a ratio K1 does not take).
long long sdr_flat_decimate_smem_bytes(int in_is_i16, int r, int t_leg, int complex_legs) {
  long long bytes = -1;
  dispatch(in_is_i16, r, complex_legs, [&](auto v) {
    bytes = static_cast<long long>(decltype(v)::smem_bytes(decltype(v)::taps_pad(t_leg)));
    return cudaSuccess;
  });
  return bytes;
}

// Blocks of the variant resident on one SM of the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after the shared-memory
// opt-in); a negative CUDA error code on failure.
int sdr_flat_decimate_blocks_per_sm(int in_is_i16, int r, int t_leg, int complex_legs) {
  int n = 0;
  const cudaError_t err = dispatch(in_is_i16, r, complex_legs, [&](auto v) {
    size_t smem = 0;
    return prepare<decltype(v)>(t_leg, &smem, &n);
  });
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// tail: (tail_pairs, 2), tail_pairs = r·(t_leg − 1); block: (block_pairs, 2),
// a multiple of r; int16 (in_is_i16 != 0) or float32, each starting on an
// I/Q pair boundary. legs: (r, t_leg) float32, r in {2, ..., 64}, legs_im
// null for real legs; out: (n_out, 2) float32, n_out = block_pairs / r.
// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success).
int sdr_flat_decimate(int in_is_i16, const void* tail, long long tail_pairs, const void* block,
                      long long block_pairs, const float* legs_re, const float* legs_im, int r,
                      int t_leg, float scale, void* out, long long n_out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(in_is_i16, r, legs_im != nullptr, [&](auto v) {
    return launch<decltype(v)>(tail, tail_pairs, block, block_pairs, legs_re, legs_im, t_leg,
                               scale, out, n_out, s);
  }));
}

}  // extern "C"
