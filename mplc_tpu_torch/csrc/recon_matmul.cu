// K1, the fused reconstruction contraction, for Hopper (sm_90a).
//
//   out[b, :] = init[:] + sum_k wn[b, k] * d[k, :]      (fp32 in, fp32 out)
//
// Replaces mplc_tpu/ops/recon_kernel.py::_recon_matmul_kernel (the Pallas
// TPU kernel behind _fused_contract, pallas_call at :130). wn is [B, K] (the
// renormalized round weights of B coalitions, K = rounds x partners), d is
// [K, D] (the recorded per-round per-partner parameter deltas), init is
// [D], out is [B, D]; all row-major and contiguous.
//
// What bounds it on an H100 SXM: at the main path's shape (K = 200,
// D = 1,199,882) one launch must read d (0.960 GB) and init (4.8 MB) and
// write out (B x 4.8 MB): 1.272 GB at B = 64, 0.380 ms at 3.35 TB/s, and
// 1.041 GB at B = 16, 0.311 ms. The products, 2*B*K*D = 30.7 GFLOP at
// B = 64, cost 0.458 ms on the fp32 CUDA cores (67 TFLOP/s), more than the
// bytes; as three TF32 products on the tensor cores (3 x 30.7 GFLOP at
// 494.7 TFLOP/s) they cost 0.186 ms, less. So the design puts the products
// on the tensor cores and makes the kernel bound by memory: its job is to
// stream d once, at the memory rate, whatever the batch width.
//
// 1. Products in 3xTF32, accurate to fp32. Each operand is split as
//    x_hi = the TF32 value nearest x (ties away from zero: the bits of
//    cvt.rna.tf32.f32, made with two integer instructions, since the cvt
//    itself cost 0.16 ms at B = 64) and x_lo = x - x_hi (exact in fp32; the
//    tensor cores read it as TF32 by dropping its low 13 bits), and
//    mma.sync m16n8k8 (TF32 in, fp32 accumulate) sums a_lo*b_hi + a_hi*b_lo
//    + a_hi*b_hi. The dropped a_lo*b_lo is about 2^-22 of each product. One
//    TF32 product alone keeps about 3 decimal digits and breaks the parity
//    tolerance with the plain fp32 version (rtol 1e-4 / atol 1e-5) on
//    standard-normal inputs; the main path's own inputs (round weights
//    summing to 1, deltas near 1e-3) would not show it, so the checks that
//    can are on standard-normal inputs: the cuda tests and chip_smoke.py
//    hold K1 there against the exact (float64) sum, at K = 200 and every
//    tile width (tests/test_torch_recon_kernel.py emulates each design on
//    the CPU). Each warp splits the d values of its own columns once, as it
//    reads their fragments; wn is split by every warp that reads it (16
//    values a thread per k8 step at B = 64). Splitting wn once instead, in
//    shared memory or before the kernel, measured slower.
//    The tensor cores round each MMA's sum toward zero. Chained over all of
//    K = 200 that biased error reached 1.1e-4 and failed the tolerance, so
//    each k8 step's MMAs start from the error carried by a compensated
//    (Kahan) sum and the step's sum joins the fp32 accumulator in a
//    compensated add (3 FADDs an element a step): the result lies within
//    about 7e-6 of the exact sum at K = 200, where the plain fp32 product
//    (cuBLAS) lies within about 3e-5.
// 2. d streamed by cp.async through a ring of STAGES stages in shared
//    memory: the copies of step k + STAGES - 1 are in flight while the MMAs
//    of step k run (commit_group / wait_group, one barrier a step). Copies
//    are 8 bytes when D is even and d and out are 8-byte aligned (the main
//    path: every row of d then starts 8-byte aligned), else 4 bytes; the C
//    entry point picks from D and the pointers. wn goes through the same
//    ring in 4-byte copies (51.2 KB per launch at B = 64, served from L2).
// 3. Coalition tiles that follow the batch width: the kernel is templated
//    on MT, the number of m16 fragments a block holds, and the entry point
//    picks MT = 1, 2 or 4 for B <= 16, <= 32 or more; past 64 the rows tile
//    over blockIdx.y. Each block reads its 128-column strip of d once for
//    all of its rows, so a narrow batch does a quarter of the MMAs of a
//    64-wide one and costs what its bytes cost.
// 4. The epilogue adds init to the accumulators, so a coalition whose
//    weights are all zero gets init + 0 = init, bit for bit. The kernel
//    masks its ragged B, K and D edges itself (cp.async zero-fill, masked
//    stores): nothing is padded or copied.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's [kernels] lines,
// and PERF.md for every design step and how it was timed): 0.36 ms at B = 16,
// 1.15x its bound, and 0.90 ms at B = 64, 2.4x, against 1.50 and 1.6 ms
// for the CUDA-core kernel this one replaced and 0.53 and 1.09 ms for
// torch.addmm. At MT = 4 the kernel is bound by instruction issue, not by
// memory: its main loop issues about 470 instructions a thread per stage
// for 48 MMAs, most of them the compensated adds and the splits. Design
// steps, B = 16 / B = 64 in ms: MMAs chained over K with cvt.rna 0.38 /
// 0.91 (fails the tolerance); each k8 step from zero 0.36 / 0.81 (fails
// in 1 element of 2.56 million); with Kahan adds 0.38 / 1.14; cheaper
// copy addressing and unrounded lo 0.36 / 1.04; the step's MMAs seeded
// with the carried error 0.36 / 0.90.
//
// Fragments (PTX ISA, m16n8k8 .tf32; g = lane / 4, t = lane % 4): A takes
// a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]; B takes
// b0 = B[t][g], b1 = B[t+4][g]; C holds c0,c1 = C[g][2t, 2t+1] and
// c2,c3 = C[g+8][2t, 2t+1]. The sum over a k8 step does not care which
// recorded row feeds which k slot as long as A and B agree, so slot t reads
// row 2t and slot t+4 row 2t+1: a0 and a2 are then one 8-byte load. The
// strides are padded for conflict-free fragment reads: wn rows to
// A_STRIDE = BK + 8 (8-byte loads, 16 lanes a phase: g*24 + 2t covers 32
// banks), d rows to B_STRIDE = BN + 4 (rows 2t and 2t+1: 8t + g covers 32).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BN = 128;                    // parameter columns per block
constexpr int BK = 16;                     // recorded rows per stage
constexpr int STAGES = 4;                  // depth of the cp.async ring
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;        // 256
constexpr int WARP_COLS = BN / WARPS;      // 16 columns per warp
constexpr int NT = WARP_COLS / 8;          // n8 fragments per warp
constexpr int A_STRIDE = BK + 8;           // wn tile row, in floats
constexpr int B_STRIDE = BN + 4;           // d tile row, in floats

static_assert(BK % 8 == 0 && STAGES >= 2, "tiling");

template <int MT>
struct Tile {
  static constexpr int BM = 16 * MT;                   // coalition rows per block
  static constexpr int A_FLOATS = BM * A_STRIDE;
  static constexpr int STAGE_FLOATS = A_FLOATS + BK * B_STRIDE;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
  static constexpr int A_COPIES = BM * BK / THREADS;   // per thread per stage
  static_assert(BM * BK % THREADS == 0 && THREADS % BK == 0, "wn staging");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES from src to shared dst; zero-filled when !valid (src is then not
// read, and may point anywhere)
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(dst), "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// x rounded to TF32 to nearest, ties away from zero: the bits of
// cvt.rna.tf32.f32, from two full-rate integer instructions
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo: hi the TF32 value nearest x, lo = x - hi (exact in fp32),
// which the tensor cores read as TF32 by dropping its low 13 bits
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a * b for one m16n8k8 fragment: TF32 A (row) and B (col), fp32 C
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// VEC floats per copy of d: 2 when D is even and d and out are 8-byte
// aligned, else 1
template <int MT, int VEC>
__global__ void __launch_bounds__(THREADS, 2)   // two blocks per SM
recon_matmul_kernel(const float* __restrict__ wn, const float* __restrict__ d,
                    const float* __restrict__ init, float* __restrict__ out,
                    int B, int K, long long D) {
  using T = Tile<MT>;
  constexpr int COPIES_PER_ROW = BN / VEC;
  constexpr int B_ROW_STEP = THREADS / COPIES_PER_ROW;
  constexpr int B_COPIES = BK / B_ROW_STEP;          // per thread per stage
  constexpr int A_ROW_STEP = THREADS / BK;
  static_assert(THREADS % COPIES_PER_ROW == 0 && BK % B_ROW_STEP == 0, "d staging");

  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.y * T::BM;
  const long long col0 = static_cast<long long>(blockIdx.x) * BN;

  // this thread's copies: wn rows a_row + i*A_ROW_STEP at column a_k of the
  // step; d rows b_row + i*B_ROW_STEP at columns b_col .. b_col + VEC - 1.
  // The sources advance by one step per call; calls come in step order
  const int a_row = tid / BK, a_k = tid % BK;
  const int b_row = tid / COPIES_PER_ROW, b_col = (tid % COPIES_PER_ROW) * VEC;
  const int a_rows = B - row0 - a_row;      // copy i is in when i*A_ROW_STEP < a_rows
  const bool b_col_ok = col0 + b_col < D;   // D even when VEC = 2: both in
  const long long a_step = static_cast<long long>(A_ROW_STEP) * K;
  const long long b_step = static_cast<long long>(B_ROW_STEP) * D;
  const float* a_src = wn + static_cast<long long>(row0 + a_row) * K + a_k;
  const float* b_src = d + static_cast<long long>(b_row) * D + col0 + b_col;
  const uint32_t stage0 = smem_addr(smem);

  auto load_stage = [&](int slot, int k0) {
    const uint32_t a_dst = stage0 + (slot * T::STAGE_FLOATS + a_row * A_STRIDE + a_k) * 4;
    const bool a_k_ok = k0 + a_k < K;
    const float* src = a_src;
#pragma unroll
    for (int i = 0; i < T::A_COPIES; ++i, src += a_step)
      cp_async<4>(a_dst + i * A_ROW_STEP * A_STRIDE * 4, src,
                  a_k_ok && i * A_ROW_STEP < a_rows);
    const uint32_t b_dst = stage0 +
        (slot * T::STAGE_FLOATS + T::A_FLOATS + b_row * B_STRIDE + b_col) * 4;
    const int b_rows = b_col_ok ? K - k0 - b_row : 0;   // copy i is in when i*B_ROW_STEP < b_rows
    src = b_src;
#pragma unroll
    for (int i = 0; i < B_COPIES; ++i, src += b_step)
      cp_async<4 * VEC>(b_dst + i * B_ROW_STEP * B_STRIDE * 4, src, i * B_ROW_STEP < b_rows);
    a_src += BK;
    b_src += BK * D;
  };

  // compensated (Kahan) sums: acc + err is the running sum, err the part
  // of it that acc could not hold
  float acc[MT][NT][4], err[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = err[mt][nt][j] = 0.0f;

  const int steps = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s, s * BK);
    cp_async_commit();
  }

  const int wcol = warp * WARP_COLS;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();   // this step's copies have landed ...
    __syncthreads();               // ... for every thread, and the slot
                                   // refilled below is no longer read
    const int next = step + STAGES - 1;
    if (next < steps) load_stage(next % STAGES, next * BK);
    cp_async_commit();

    const float* As = smem + (step % STAGES) * T::STAGE_FLOATS;
    const float* Bs = As + T::A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t b_hi[NT][2], b_lo[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* p = Bs + (kk + 2 * t) * B_STRIDE + wcol + nt * 8 + g;
        split(p[0], b_hi[nt][0], b_lo[nt][0]);
        split(p[B_STRIDE], b_hi[nt][1], b_lo[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* p = As + (mt * 16 + g) * A_STRIDE + kk + 2 * t;
        const float2 top = *reinterpret_cast<const float2*>(p);
        const float2 bot = *reinterpret_cast<const float2*>(p + 8 * A_STRIDE);
        uint32_t a_hi[4], a_lo[4];
        split(top.x, a_hi[0], a_lo[0]);
        split(bot.x, a_hi[1], a_lo[1]);
        split(top.y, a_hi[2], a_lo[2]);
        split(bot.y, a_hi[3], a_lo[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // the tensor cores round their sums toward zero: started from the
          // carried error, not from acc, one k8 step's sum stays small, and
          // it joins acc in a compensated fp32 add (3 FADDs)
          float part[4] = {err[mt][nt][0], err[mt][nt][1], err[mt][nt][2],
                           err[mt][nt][3]};
          mma_tf32(part, a_lo, b_hi[nt]);
          mma_tf32(part, a_hi, b_lo[nt]);
          mma_tf32(part, a_hi, b_hi[nt]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float s = acc[mt][nt][j] + part[j];
            err[mt][nt][j] = part[j] - (s - acc[mt][nt][j]);
            acc[mt][nt][j] = s;
          }
        }
      }
    }
  }

  // epilogue: out = init + acc. Element j of fragment (mt, nt) sits at row
  // mt*16 + g (+8 for j >= 2), column wcol + nt*8 + 2t (+1 for odd j)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const long long c = col0 + wcol + nt * 8 + 2 * t;
    if (c >= D) continue;
    const bool second = c + 1 < D;
    const float i0 = init[c];
    const float i1 = second ? init[c + 1] : 0.0f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + mt * 16 + g + 8 * h;
        if (r >= B) continue;
        float* o = out + static_cast<long long>(r) * D + c;
        const float v0 = i0 + (acc[mt][nt][2 * h] + err[mt][nt][2 * h]);
        const float v1 = i1 + (acc[mt][nt][2 * h + 1] + err[mt][nt][2 * h + 1]);
        if (VEC == 2) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);   // D even: aligned
        } else {
          o[0] = v0;
          if (second) o[1] = v1;
        }
      }
    }
  }
}

template <int MT, int VEC>
cudaError_t launch(const float* wn, const float* d, const float* init, float* out,
                   int B, int K, long long D, cudaStream_t stream) {
  constexpr int smem = Tile<MT>::SMEM_BYTES;
  auto kernel = recon_matmul_kernel<MT, VEC>;
  // past 48 KB a block's shared memory must be asked for
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((D + BN - 1) / BN),
                  static_cast<unsigned>((B + Tile<MT>::BM - 1) / Tile<MT>::BM));
  kernel<<<grid, THREADS, smem, stream>>>(wn, d, init, out, B, K, D);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_width(const float* wn, const float* d, const float* init,
                         float* out, int B, int K, long long D, cudaStream_t stream) {
  if (B <= 16) return launch<1, VEC>(wn, d, init, out, B, K, D, stream);
  if (B <= 32) return launch<2, VEC>(wn, d, init, out, B, K, D, stream);
  return launch<4, VEC>(wn, d, init, out, B, K, D, stream);
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int recon_matmul_f32(const float* wn, const float* d,
                                const float* init, float* out, int B, int K,
                                long long D, cudaStream_t stream) {
  // 8-byte copies of d and stores of out need every row of both 8-byte
  // aligned: D even and both base pointers 8-byte aligned
  const bool pairs = D % 2 == 0 && reinterpret_cast<uintptr_t>(d) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const cudaError_t err =
      pairs ? launch_width<2>(wn, d, init, out, B, K, D, stream)
            : launch_width<1>(wn, d, init, out, B, K, D, stream);
  return static_cast<int>(err);
}
