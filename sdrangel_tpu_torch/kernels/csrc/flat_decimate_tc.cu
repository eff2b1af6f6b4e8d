// K1-TC — the flat ÷2^k decimator on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel sdrangel_tpu/pallas/decimator.py:165
// decimate_cascade_fused_mxu (the matrix-unit form of the fused decimator):
// the order-64 half-band ÷2^k cascade folded into one filter split into
// r = 2^k polyphase legs (r, t_leg), on the i16 cen path.
//
// Contract (as K1's i16 path): the input is [carried raw tail | block],
// int16 interleaved I/Q, given as two pointers — tail (r·(t_leg − 1) pairs)
// and block (T pairs) — so a caller never copies the block to put the tail
// in front of it. With ext = [tail | block], output m (of T/r) is
//     y[m] = Σ_t Σ_j legs[j, t] · ext[r·(m + t) + j] / 32768.
//
// Form. With the polyphase planes P[w, j] = ext[r·w + j] (one (W × r)
// matrix each for I and Q), Z = P @ legs is a dense (W × r) @ (r × t_leg)
// product and y[m] = Σ_t Z[m + t, t] is a skewed diagonal sum. Plane row w
// lies wholly in the tail (w < t_leg − 1) or wholly in the block, because
// the tail is a whole number of rows. The product runs on the tensor cores
// (mma.sync.m16n8k8 TF32, f32 accumulation).
//
// Precision (route (a) of PR 2's two): TF32 keeps 11 significant bits, so
// each int16 sample is split as 256·hi + lo (−128 ≤ hi < 128, 0 ≤ lo < 256)
// and each leg as a TF32 part plus a TF32 remainder; three passes — hi·hi,
// hi·lo, lo·hi — go into one f32 accumulator. The exact power-of-two scales
// are folded into the B fragments (tf32(l)/128 and remainder/128), and the
// A values are hi and lo/256, each made by one byte permute into a float's
// mantissa and one add: no conversion instruction, two B sets. Every
// product equals PR 2's exactly. The dropped lo·lo term is below
// (255/32768)·2^−11·Σ|h_eq| = 7.5e-6 at ÷64 (Σ|h_eq| = 1.97) in the worst
// case and ~1e-7 on random full-scale input, inside the Pallas kernel's
// 2e-5 tolerance.
//
// What bounds it on an H100: bytes. At the 2^25-sample gear block (÷64) the
// function reads 134 MB and writes 4 MB, 0.041 ms at 3.35 TB/s; its work,
// one TF32 pass of 2·r·t_leg FLOP per output and plane plus the diagonal
// sum, is 0.018 ms at the 495 TFLOP/s dense peak. The three passes (25.4
// GFLOP) and the m16/n16 padding are this design's cost: ~0.05 ms of
// mma.sync at the peak, and ~0.06 ms of issued instructions (split, MMAs,
// diagonal sums) at 4 a clock per SM. Measured (chip_smoke.py phase 2b, an
// H100 80GB HBM3 at 700 W): 0.20–0.22 ms, ~19 % of the byte bound, so
// neither bytes nor issue bound it now; what is left is latency this
// design does not hide — each warp's 4 accumulator chains take 24
// dependent MMAs per m16 step, with 12 warps per SM (no profiler counter
// confirms it). wgmma from shared memory, with the A split once per stage,
// is the next step.
//
// Design.
// - A block walks a run of consecutive 128-output tiles (the launcher sizes
//   the run from n_out, the SM count and the blocks resident per SM, so
//   the grid is one wave). Its 4 warps each own 16 taps (2 n8 tiles; t_leg
//   ≤ 64 is zero-padded to 64) and keep their legs as B fragments in
//   registers: each split A fragment feeds 12 MMAs.
// - The window is a ring of 3 stages of 64 plane rows in shared memory,
//   filled with cp.async (16-byte copies; 8- or 4-byte ones, chosen in the
//   kernel, where the tail's or the block's address allows no more, and
//   zero-fill past the input). While a chunk of 4 m16 steps computes from
//   two stages, the next stage loads; the history rows that consecutive
//   tiles share stay in the ring, so each row is read from memory ~once.
//   Rows are kXStride = r + 4 pairs apart (16-byte aligned, and 8 rows × 4
//   columns of a fragment load hit 32 banks).
// - Step s of a warp multiplies plane rows 16s + 16·warp + [0, 16) by its
//   16 taps, and sums the tile's diagonals at once through a per-warp 16×17
//   staging area: output 16(s−1) + b gets taps 16−b..15 and is complete;
//   output 16s + b gets taps 0..15−b and is carried to step s + 1 in a
//   register. Each output's taps are summed in ascending order, then the
//   4 warps' shares in a fixed order, so the result does not depend on
//   where a launch or a tile starts: streamed blocks equal one long block
//   bit for bit.
// - Shared memory at r = 64: 52 KB of ring + 9 KB of staging + 8 KB of
//   double-buffered warp shares = 69 KB, so 3 blocks of 4 warps reside on
//   an SM.
// wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTapsPad = 64;                   // t_leg ≤ 64, zero-padded
constexpr int kWarpTaps = 16;                  // two n8 tiles per warp
constexpr int kWarps = kTapsPad / kWarpTaps;
constexpr int kThreads = kWarps * 32;
constexpr int kTileOut = 128;                  // outputs per tile
constexpr int kStepsPerTile = kTileOut / 16;   // m16 steps per tile
constexpr int kStageRows = 64;                 // plane rows per ring stage
constexpr int kStages = 3;
constexpr int kRingRows = kStages * kStageRows;
constexpr int kStepsPerChunk = kStageRows / 16;
constexpr int kZStride = 17;                   // 16 taps + 1: conflict-free diagonals
constexpr int kZPlane = 16 * kZStride;
constexpr int kZWarp = 2 * kZPlane;            // floats of one warp's staging (I and Q)
constexpr int kPart = 2 * kTileOut;            // floats of one warp's shares of a tile
constexpr int kMinBlocks = 3;                  // resident blocks per SM at r = 64
static_assert(kWarps * kWarpTaps == kTapsPad, "the warps cover the padded taps");
static_assert(kStageRows >= 16 * kWarps, "a chunk's rows lie in two stages");
static_assert(kStepsPerTile % kStepsPerChunk == 0 && kStepsPerTile / kStepsPerChunk == 2,
              "a tile is two chunks: the sums of tile τ are read at chunk 2τ + 3");
static_assert(kRingRows % 16 == 0, "an m16 tile never wraps the ring");
static_assert(kTileOut == kThreads, "the tile sum maps one output (I and Q) to a thread");

template <int kLog2>
struct Geom {
  static constexpr int r = 1 << kLog2;
  static constexpr int kSteps = (r + 7) / 8;    // k8 steps over the legs
  static constexpr int kPadK = kSteps * 8;
  // +4 pairs per row: fragment loads (8 rows × 4 columns) hit 32 banks
  static constexpr int kXStride = kPadK + 4;
  static constexpr int kRowBytes = 4 * r;
  static constexpr int kChunk = kRowBytes < 16 ? kRowBytes : 16;  // bytes per copy slot
  static constexpr int kChunksPerRow = kRowBytes / kChunk;
  static constexpr size_t kSmem =
      static_cast<size_t>(kRingRows) * kXStride * sizeof(short2) +
      static_cast<size_t>(kWarps) * kZWarp * sizeof(float) +
      static_cast<size_t>(2) * kWarps * kPart * sizeof(float);
  static_assert((kXStride * sizeof(short2)) % 16 == 0, "ring rows are 16-byte aligned");
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

// one I/Q pair (I in the low half) → hi and lo/256 of I and of Q, exact
// TF32 values: the byte goes into the low mantissa byte of 2^23 (hi, with
// its sign bit flipped to bias it by 128) or of 2^15 (lo), and the offset
// is subtracted
__device__ __forceinline__ void split_pair(uint32_t w, uint32_t& hi_i, uint32_t& lo_i,
                                           uint32_t& hi_q, uint32_t& lo_q) {
  const uint32_t t = w ^ 0x80008000u;
  hi_i = __float_as_uint(__uint_as_float(__byte_perm(t, 0x4B000000u, 0x7651)) - 8388736.0f);
  lo_i = __float_as_uint(__uint_as_float(__byte_perm(t, 0x47000000u, 0x7650)) - 32768.0f);
  hi_q = __float_as_uint(__uint_as_float(__byte_perm(t, 0x4B000000u, 0x7653)) - 8388736.0f);
  lo_q = __float_as_uint(__uint_as_float(__byte_perm(t, 0x47000000u, 0x7652)) - 32768.0f);
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// one copy slot of kChunk bytes as copies of the widest size `align` allows
template <int kChunk>
__device__ __forceinline__ void copy_chunk(uint32_t dst, const char* src, bool valid, int align) {
  if (kChunk == 16 && align >= 16) {
    cp_async<16>(dst, src, valid ? 16 : 0);
  } else if (align >= 8) {
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

template <int kLog2>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flat_decimate_tc_kernel(const short2* __restrict__ tail, long long tail_rows,
                        const short2* __restrict__ block, long long block_rows,
                        const float* __restrict__ legs, int t_leg, long long n_out,
                        int run_tiles, float* __restrict__ out) {
  using G = Geom<kLog2>;
  extern __shared__ float4 smem[];
  short2* ring = reinterpret_cast<short2*>(smem);                    // [kRingRows][kXStride]
  float* sh_z = reinterpret_cast<float*>(ring + kRingRows * G::kXStride);  // [kWarps][kZWarp]
  float* sh_part = sh_z + kWarps * kZWarp;                           // [2][kWarps][kPart]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group
  const int tq = lane & 3;   // thread in group
  const long long n_tiles = (n_out + kTileOut - 1) / kTileOut;
  const long long tile0 = static_cast<long long>(blockIdx.x) * run_tiles;
  const int tiles = static_cast<int>(min(static_cast<long long>(run_tiles), n_tiles - tile0));
  const long long row0 = tile0 * kTileOut;  // plane row of ring row 0 (and output 0 of the run)
  const int n_steps = kStepsPerTile * tiles + 1;
  const int n_chunks = (n_steps + kStepsPerChunk - 1) / kStepsPerChunk;
  const int n_stages = n_chunks;  // chunk c reads stages c and c + 1 (the last only c)
  const int align_tail = alignment(tail);
  const int align_block = alignment(block);
  const uint32_t ring_base = static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  // columns j ≥ r of a row (r < 8 only) are never copied: zero them once
  if (G::r < G::kPadK) {
    for (int s = tid; s < kRingRows * (G::kPadK - G::r); s += kThreads) {
      const int w = s / (G::kPadK - G::r);
      ring[w * G::kXStride + G::r + s % (G::kPadK - G::r)] = make_short2(0, 0);
    }
  }

  auto load_stage = [&](int q) {
    const int slot_row = (q % kStages) * kStageRows;
    for (int i = tid; i < kStageRows * G::kChunksPerRow; i += kThreads) {
      const int row = i / G::kChunksPerRow;
      const int ch = i % G::kChunksPerRow;
      const long long p = row0 + static_cast<long long>(q) * kStageRows + row;
      const short2* src = block;
      int align = align_block;
      bool valid = false;
      if (p < tail_rows) {
        src = tail + p * G::r;
        align = align_tail;
        valid = true;
      } else if (p - tail_rows < block_rows) {
        src = block + (p - tail_rows) * G::r;
        valid = true;
      }
      const uint32_t dst = ring_base +
          static_cast<uint32_t>(((slot_row + row) * G::kXStride) * sizeof(short2) + ch * G::kChunk);
      copy_chunk<G::kChunk>(dst, reinterpret_cast<const char*>(src) + ch * G::kChunk, valid,
                            align);
    }
  };

  // this warp's legs as B fragments, the scales folded in:
  // b[ks][nt][h] = legs[j = 8ks + tq + 4h][t = 16·warp + 8nt + g]
  uint32_t b_hi[G::kSteps][2][2], b_lo[G::kSteps][2][2];
#pragma unroll
  for (int ks = 0; ks < G::kSteps; ++ks) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = ks * 8 + tq + 4 * h;
        const int t = warp * kWarpTaps + nt * 8 + g;
        const float l = (j < G::r && t < t_leg) ? legs[j * t_leg + t] : 0.0f;
        const uint32_t hi = to_tf32(l);
        const float rem = __uint_as_float(to_tf32(l - __uint_as_float(hi)));
        b_hi[ks][nt][h] = __float_as_uint(__uint_as_float(hi) * (1.0f / 128.0f));
        b_lo[ks][nt][h] = __float_as_uint(rem * (1.0f / 128.0f));
      }
    }
  }

  // the warps' shares of tile τ of the run, added in a fixed order
  auto store_tile = [&](int tile) {
    const float* part = sh_part + (tile & 1) * kWarps * kPart;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = tid + k * kThreads;  // 2·(output in tile) + plane
      float y = part[i];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) y += part[w * kPart + i];
      const long long m = (tile0 + tile) * kTileOut + (i >> 1);
      if (m < n_out) out[2 * m + (i & 1)] = y;
    }
  };

  float* zw = sh_z + warp * kZWarp;
  const int zp = lane >> 4;   // the plane this lane sums (0 = I, 1 = Q)
  const int zb = lane & 15;   // the output within the m16 tile this lane sums
  float carry = 0.f;          // output 16s + zb's share of taps 0..15−zb

  load_stage(0);
  cp_async_commit();
  if (n_stages > 1) load_stage(1);
  cp_async_commit();
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // every warp is done with chunk c − 1: stage c − 1's slot is free
    if (c + 2 < n_stages) load_stage(c + 2);
    cp_async_commit();
    cp_async_wait<1>();  // stages ≤ c + 1 of this thread have landed
    __syncthreads();     // ... and of every thread
    // tile τ completes at step 8τ + 8 (chunk 2τ + 2); its shares are read
    // here, and the buffer is written again only from chunk 2τ + 4 on
    if (c >= 3 && (c & 1)) store_tile((c - 3) >> 1);
#pragma unroll 1
    for (int s = c * kStepsPerChunk; s < min(n_steps, (c + 1) * kStepsPerChunk); ++s) {
      float acc[2][2][4] = {};  // [plane][nt][C fragment]
      const int lr = (16 * s + kWarpTaps * warp) % kRingRows;
      const uint32_t* x0 = reinterpret_cast<const uint32_t*>(ring) + (lr + g) * G::kXStride + tq;
      const uint32_t* x1 = x0 + 8 * G::kXStride;
#pragma unroll
      for (int ks = 0; ks < G::kSteps; ++ks) {
        // A fragment: a0 (g, tq), a1 (g+8, tq), a2 (g, tq+4), a3 (g+8, tq+4)
        const uint32_t w[4] = {x0[8 * ks], x1[8 * ks], x0[8 * ks + 4], x1[8 * ks + 4]};
        uint32_t hi[2][4], lo[2][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_pair(w[e], hi[0][e], lo[0][e], hi[1][e], lo[1][e]);
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            mma_tf32(acc[pl][nt], hi[pl], b_hi[ks][nt][0], b_hi[ks][nt][1]);
            mma_tf32(acc[pl][nt], hi[pl], b_lo[ks][nt][0], b_lo[ks][nt][1]);
            mma_tf32(acc[pl][nt], lo[pl], b_hi[ks][nt][0], b_hi[ks][nt][1]);
          }
        }
      }
      // C fragment: c0 (g, 2tq), c1 (g, 2tq+1), c2 (g+8, 2tq), c3 (g+8, 2tq+1)
#pragma unroll
      for (int pl = 0; pl < 2; ++pl) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float* z = zw + pl * kZPlane + g * kZStride + nt * 8 + 2 * tq;
          z[0] = acc[pl][nt][0];
          z[1] = acc[pl][nt][1];
          z[8 * kZStride] = acc[pl][nt][2];
          z[8 * kZStride + 1] = acc[pl][nt][3];
        }
      }
      __syncwarp();
      // row zb + tap of this m16 tile: for tap ≥ 16 − zb it finishes output
      // 16(s−1) + zb, else it starts output 16s + zb; taps ascend in both
      const float* z = zw + zp * kZPlane;
      float fin = carry, start = 0.f;
#pragma unroll
      for (int tap = 0; tap < 16; ++tap) {
        const float v = z[((zb + tap) & 15) * kZStride + tap];
        if (zb + tap >= 16) {
          fin += v;
        } else {
          start += v;
        }
      }
      if (s > 0) {
        const int m = 16 * (s - 1) + zb;  // output of the run
        const int tile = m / kTileOut;
        sh_part[((tile & 1) * kWarps + warp) * kPart + 2 * (m % kTileOut) + zp] = fin;
      }
      carry = start;
      __syncwarp();
    }
  }
  __syncthreads();
  store_tile(tiles - 1);
}

template <int kLog2>
cudaError_t prepare(int* blocks_per_sm) {
  auto kernel = flat_decimate_tc_kernel<kLog2>;
  const int smem = static_cast<int>(Geom<kLog2>::kSmem);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess || blocks_per_sm == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
}

template <int kLog2>
cudaError_t launch(const void* tail, long long tail_pairs, const void* block,
                   long long block_pairs, const float* legs, int t_leg, long long n_out,
                   void* out, cudaStream_t stream) {
  constexpr int r = Geom<kLog2>::r;
  if (tail_pairs % r || block_pairs % r) return cudaErrorInvalidValue;
  if (n_out <= 0) return cudaSuccess;
  // resident blocks per SM × SMs of each device, queried at its first launch
  static int slots_of[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (slots_of[device] == 0) {
    int per_sm = 0, sms = 0;
    if ((err = prepare<kLog2>(&per_sm)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    slots_of[device] = per_sm * sms;
  } else if ((err = prepare<kLog2>(nullptr)) != cudaSuccess) {
    return err;
  }
  // one wave: every resident block walks a run of consecutive tiles
  const long long n_tiles = (n_out + kTileOut - 1) / kTileOut;
  const long long slots = slots_of[device];
  const long long run = (n_tiles + slots - 1) / slots;
  const long long blocks = (n_tiles + run - 1) / run;
  if (run > 0x7fffffffLL / kTileOut) return cudaErrorInvalidConfiguration;
  flat_decimate_tc_kernel<kLog2><<<static_cast<unsigned>(blocks), kThreads,
                                   Geom<kLog2>::kSmem, stream>>>(
      static_cast<const short2*>(tail), tail_pairs / r, static_cast<const short2*>(block),
      block_pairs / r, legs, t_leg, n_out, static_cast<int>(run), static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at r = 2^log2 (−1 for another r).
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

// Blocks of the r = 2^log2 kernel resident on one SM of the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); a negative CUDA error
// code on failure, −1 for another r.
int sdr_flat_decimate_tc_blocks_per_sm(int r) {
  int n = 0;
  cudaError_t err;
  switch (r) {
    case 2: err = prepare<1>(&n); break;
    case 4: err = prepare<2>(&n); break;
    case 8: err = prepare<3>(&n); break;
    case 16: err = prepare<4>(&n); break;
    case 32: err = prepare<5>(&n); break;
    case 64: err = prepare<6>(&n); break;
    default: return -1;
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// tail: (tail_pairs, 2) int16, tail_pairs = r·(t_leg − 1) (a whole number of
// plane rows); block: (block_pairs, 2) int16, a multiple of r; both start on
// an I/Q pair boundary (any 4-byte alignment). legs: (r, t_leg) float32,
// r in {2, ..., 64}, t_leg ≤ 64; out: (n_out, 2) float32,
// n_out = (tail_pairs + block_pairs)/r − (t_leg − 1). Launches on `stream`
// and returns cudaGetLastError() of the launch (0 on success).
int sdr_flat_decimate_tc(const void* tail, long long tail_pairs, const void* block,
                         long long block_pairs, const float* legs, int r, int t_leg, void* out,
                         long long n_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_leg < 1 || t_leg > kTapsPad) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (r) {
    case 2: err = launch<1>(tail, tail_pairs, block, block_pairs, legs, t_leg, n_out, out, s); break;
    case 4: err = launch<2>(tail, tail_pairs, block, block_pairs, legs, t_leg, n_out, out, s); break;
    case 8: err = launch<3>(tail, tail_pairs, block, block_pairs, legs, t_leg, n_out, out, s); break;
    case 16: err = launch<4>(tail, tail_pairs, block, block_pairs, legs, t_leg, n_out, out, s); break;
    case 32: err = launch<5>(tail, tail_pairs, block, block_pairs, legs, t_leg, n_out, out, s); break;
    case 64: err = launch<6>(tail, tail_pairs, block, block_pairs, legs, t_leg, n_out, out, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
