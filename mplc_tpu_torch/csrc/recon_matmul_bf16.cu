// K1-bf16, the fused reconstruction contraction on bf16 operands, for
// Hopper (sm_90a).
//
//   out[b, :] = init[:] + sum_k wn[b, k] * d[k, :]
//   (wn, d bf16; init, out fp32; products and sums in fp32)
//
// Replaces mplc_tpu/ops/recon_kernel.py::_recon_matmul_kernel (the Pallas
// TPU kernel behind _fused_contract) as the JAX package instantiates it
// under precision="bf16": bf16 WN and deltas, preferred_element_type fp32,
// an fp32 output. wn is [B, K] (the renormalized round weights of B
// coalitions, K = rounds x partners), d is [K, D] (the recorded per-round
// per-partner parameter deltas), init is [D], out is [B, D]; all row-major
// and contiguous. A bf16 x bf16 product is exact in fp32, so the result is
// the fp32 sum of the same terms as the plain version's, in another order.
//
// What bounds it on an H100: at the main path's shape (B = 64, K = 200,
// D = 1,199,882) one launch does 2*B*K*D = 30.7 GFLOP and must move
// d 0.480 GB + out 0.307 GB + init 4.8 MB + wn 25.6 KB = 0.792 GB, 39 FLOP
// per byte: far below the bf16 tensor-core ridge (989 TFLOP/s over
// 3.35 TB/s = 295), so it is bound by memory: 0.236 ms, against 0.031 ms of
// tensor-core work. On the CUDA cores (fp32 FMA, 67 TFLOP/s) the same work
// would take 0.46 ms, twice the bound, so the products go to the tensor
// cores (mma.sync m16n8k16, bf16 in, fp32 accumulate) and the kernel's job
// is to stream d once at the memory rate.
//
// Design. A 2-D grid covers (D tiles, B tiles); one block owns a BM x BN
// output tile with BM = 64, every coalition of a batch, so d is read from
// device memory exactly once per batch. The K axis (the TPU kernel's
// sequential grid axis) is a loop inside the block: per step the block
// stages a BM x BK slice of wn and a BK x BN slice of d in shared memory,
// while the next step's slice is already being loaded into registers
// (register double-buffering). Each of the 8 warps owns 16 columns of the
// tile (two n8 fragments) for all 64 rows (four m16 fragments): 8 MMAs per
// k16 step, fp32 accumulators in registers. A fragments are 32-bit loads
// of consecutive k (wn rows padded to 72 for conflict-free reads); B
// fragments pack two consecutive-k values of one column from two 16-bit
// loads. d is loaded as bf16 pairs (4 bytes) when D is even (every row is
// then 4-byte aligned), else one value at a time. The kernel masks its
// ragged B, K and D edges itself (zero fill): nothing is padded or copied.
// init is added in the epilogue, so a coalition whose weights are all zero
// gets init + 0 = init, bit for bit.
//
// The rows of d are only 4-byte aligned (D = 1,199,882 is not a multiple
// of 8), so 16-byte loads are out and the rate at which d streams is set
// by how many 4-byte loads are in flight. BK = 64 gives each thread 16 of
// them per step, and 128 registers (no spills) let two blocks, 16 warps,
// share each SM. On the H100 this measured about twice the bound, faster
// than 32-row steps or one block per SM; 16-byte staging (TMA, or
// realigned cp.async) is the next step towards the bound.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 64;                     // coalition rows per block
constexpr int BN = 128;                    // parameter columns per block
constexpr int BK = 64;                     // recorded rows staged per step
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;        // 256
constexpr int WARP_COLS = BN / WARPS;      // 16 columns per warp
constexpr int MT = BM / 16;                // m16 fragments per warp
constexpr int NT = WARP_COLS / 8;          // n8 fragments per warp
constexpr int A_STRIDE = BK + 8;           // 72: conflict-free A fragments
constexpr int B_STRIDE = BN + 8;           // 136: conflict-free B fragments
constexpr int A_PER_THREAD = BM * BK / THREADS;          // 16 values
constexpr int B_PAIRS_PER_THREAD = BK * BN / 2 / THREADS;  // 16 pairs
constexpr int PAIRS_PER_ROW = BN / 2;                    // 64
constexpr int A_ROW_STEP = THREADS / BK;                 // 4
constexpr int B_ROW_STEP = THREADS / PAIRS_PER_ROW;      // 4

static_assert(THREADS % BK == 0 && THREADS % PAIRS_PER_ROW == 0 &&
              BM * BK % THREADS == 0 && BK * BN / 2 % THREADS == 0, "tiling");

// D = A * B + D for one m16n8k16 fragment: bf16 A (row) and B (col), fp32 D
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16 values travel as their raw 16 bits: the kernel only moves them
// into the tensor cores, which read them as bf16
template <bool kPairs>
__global__ void __launch_bounds__(THREADS, 2)   // two blocks per SM
recon_matmul_bf16_kernel(const uint16_t* __restrict__ wn,
                         const uint16_t* __restrict__ d,
                         const float* __restrict__ init,
                         float* __restrict__ out, int B, int K, long long D) {
  __shared__ __align__(16) uint16_t As[BM][A_STRIDE];   // wn tile [row][k]
  __shared__ __align__(16) uint16_t Bs[BK][B_STRIDE];   // d tile [k][col]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int group = lane / 4, quad = lane % 4;  // fragment row / k-pair
  const int row0 = blockIdx.y * BM;
  const long long col0 = static_cast<long long>(blockIdx.x) * BN;

  // THREADS is a whole number of the staged slices' row widths, so each
  // thread stages one k column of wn and one column pair of d, in rows
  // A_ROW_STEP and B_ROW_STEP apart
  const int a_row = tid / BK, a_k = tid % BK;   // consecutive threads: consecutive k
  const int b_k = tid / PAIRS_PER_ROW, b_pair = tid % PAIRS_PER_ROW;
  const long long b_col = col0 + 2 * b_pair;
  const bool b_col_ok = b_col < D;

  uint16_t a_next[A_PER_THREAD];
  uint32_t b_next[B_PAIRS_PER_THREAD];

  // global -> registers: the slice of wn and d at recorded row k0
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const int gr = row0 + a_row + i * A_ROW_STEP, gk = k0 + a_k;
      a_next[i] = (gr < B && gk < K) ? wn[static_cast<long long>(gr) * K + gk] : 0;
    }
    const uint16_t* p = d + static_cast<long long>(k0 + b_k) * D + b_col;
#pragma unroll
    for (int i = 0; i < B_PAIRS_PER_THREAD; ++i, p += B_ROW_STEP * D) {
      uint32_t v = 0;
      if (b_col_ok && k0 + b_k + i * B_ROW_STEP < K) {
        if (kPairs) {
          v = *reinterpret_cast<const uint32_t*>(p);   // D even: b_col + 1 < D
        } else {
          v = p[0];
          if (b_col + 1 < D) v |= static_cast<uint32_t>(p[1]) << 16;
        }
      }
      b_next[i] = v;
    }
  };
  // registers -> shared memory
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) As[a_row + i * A_ROW_STEP][a_k] = a_next[i];
#pragma unroll
    for (int i = 0; i < B_PAIRS_PER_THREAD; ++i)
      *reinterpret_cast<uint32_t*>(&Bs[b_k + i * B_ROW_STEP][2 * b_pair]) = b_next[i];
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;

  load(0);
  store();
  __syncthreads();

  const int wcol = warp * WARP_COLS;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);               // in flight during the MMAs below
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = mt * 16 + group;
        const int c = kk + 2 * quad;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][c]);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c]);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][c + 8]);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wcol + nt * 8 + group;
        const int k = kk + 2 * quad;
        b[nt][0] = Bs[k][n] | (static_cast<uint32_t>(Bs[k + 1][n]) << 16);
        b[nt][1] = Bs[k + 8][n] | (static_cast<uint32_t>(Bs[k + 9][n]) << 16);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

  // epilogue: out = init + acc. Fragment element j of (mt, nt) sits at row
  // mt*16 + group (+8 for j >= 2), column wcol + nt*8 + 2*quad (+1 for odd j)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const long long c = col0 + wcol + nt * 8 + 2 * quad;
    if (c >= D) continue;
    const bool second = c + 1 < D;
    const float i0 = init[c];
    const float i1 = second ? init[c + 1] : 0.0f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + mt * 16 + group + 8 * h;
        if (r >= B) continue;
        float* o = out + static_cast<long long>(r) * D + c;
        const float v0 = i0 + acc[mt][nt][2 * h];
        const float v1 = i1 + acc[mt][nt][2 * h + 1];
        if (kPairs) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);   // D even: aligned
        } else {
          o[0] = v0;
          if (second) o[1] = v1;
        }
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
// wn and d point to bf16 data.
extern "C" int recon_matmul_bf16(const void* wn, const void* d,
                                 const float* init, float* out, int B, int K,
                                 long long D, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((D + BN - 1) / BN),
                  static_cast<unsigned>((B + BM - 1) / BM));
  const auto* wn16 = static_cast<const uint16_t*>(wn);
  const auto* d16 = static_cast<const uint16_t*>(d);
  // pairs of d (4 bytes) and of out (8 bytes) are aligned when D is even
  // and the buffers are
  const bool pairs = D % 2 == 0 && reinterpret_cast<uintptr_t>(d) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 8 == 0;
  if (pairs) {
    recon_matmul_bf16_kernel<true><<<grid, THREADS, 0, stream>>>(wn16, d16, init,
                                                                 out, B, K, D);
  } else {
    recon_matmul_bf16_kernel<false><<<grid, THREADS, 0, stream>>>(wn16, d16, init,
                                                                  out, B, K, D);
  }
  return static_cast<int>(cudaGetLastError());
}
