// K1, the fused reconstruction contraction, for Hopper (sm_90a).
//
//   out[b, :] = init[:] + sum_k wn[b, k] * d[k, :]      (fp32 in, fp32 sum)
//
// Replaces mplc_tpu/ops/recon_kernel.py::_recon_matmul_kernel (the Pallas
// TPU kernel behind _fused_contract). wn is [B, K] (the renormalized round
// weights of B coalitions, K = rounds x partners), d is [K, D] (the
// recorded per-round per-partner parameter deltas), init is [D], out is
// [B, D]; all row-major and contiguous.
//
// What bounds it on an H100: at the main path's shape (B = 64, K = 200,
// D = 1,199,882) one launch does 2*B*K*D = 30.7 GFLOP and must move
// K*D*4 + B*D*4 = 1.27 GB, 24 FLOP per byte: just above the card's fp32
// ridge (67 TFLOP/s over 3.35 TB/s = 20), so it is bound by the fp32
// CUDA-core rate (0.46 ms), with memory (0.38 ms) close behind. Tensor cores
// are not used: TF32 would break the parity bound (rtol 1e-4) with the
// plain fp32 version.
//
// Design. The TPU kernel's sequential K grid axis becomes a loop inside the
// block. A 2-D grid covers (D tiles, B tiles); one block owns a BM x BN
// output tile with BM = 64, every coalition of a batch, so d is read from
// device memory exactly once per batch. Per K step the block stages a
// BK x BM slice of wn (transposed) and a BK x BN slice of d in shared
// memory; each of the 256 threads keeps a TM x TN tile of fp32 accumulators
// in registers, seeded from init, and does TM*TN FMAs per staged k from
// one broadcast float4 pair (its TM rows of wn) and TN conflict-free loads
// (its TN columns of d, 32 apart, so a warp reads 32 consecutive floats).
// The kernel masks its ragged B, K and D edges itself: nothing is padded
// and nothing is copied. A coalition whose weights are all zero gets
// init + 0 * d = init, bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;                     // coalition rows per block
constexpr int BN = 128;                    // parameter columns per block
constexpr int BK = 16;                     // recorded rows staged per step
constexpr int TM = 8;                      // rows per thread
constexpr int TN = 4;                      // columns per thread
constexpr int COL_THREADS = BN / TN;       // 32: one warp spans a row of the tile
constexpr int THREADS = (BM / TM) * COL_THREADS;   // 256

__global__ void __launch_bounds__(THREADS)
recon_matmul_kernel(const float* __restrict__ wn, const float* __restrict__ d,
                    const float* __restrict__ init, float* __restrict__ out,
                    int B, int K, long long D) {
  __shared__ __align__(16) float As[BK][BM];   // wn tile, transposed
  __shared__ __align__(16) float Bs[BK][BN];   // d tile

  const int tid = threadIdx.x;
  const int tx = tid % COL_THREADS;            // column lane: cols tx + 32*j
  const int ty = tid / COL_THREADS;            // row group: rows ty*TM + i
  const int row0 = blockIdx.y * BM;
  const long long col0 = static_cast<long long>(blockIdx.x) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const long long c = col0 + tx + COL_THREADS * j;
    const float s = c < D ? init[c] : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][j] = s;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // wn slice: consecutive threads take consecutive rows, so the
    // transposed shared-memory stores are conflict-free (wn is tiny and
    // stays in L2 across the grid)
#pragma unroll
    for (int e = tid; e < BK * BM; e += THREADS) {
      const int r = e % BM, k = e / BM;
      const int gr = row0 + r, gk = k0 + k;
      As[k][r] = (gr < B && gk < K) ? wn[static_cast<long long>(gr) * K + gk] : 0.0f;
    }
    // d slice: consecutive threads read consecutive columns (coalesced)
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int c = e % BN, k = e / BN;
      const int gk = k0 + k;
      const long long gc = col0 + c;
      Bs[k][c] = (gk < K && gc < D) ? d[static_cast<long long>(gk) * D + gc] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * TM + 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + COL_THREADS * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= B) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long c = col0 + tx + COL_THREADS * j;
      if (c < D) out[static_cast<long long>(r) * D + c] = acc[i][j];
    }
  }
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int recon_matmul_f32(const float* wn, const float* d,
                                const float* init, float* out, int B, int K,
                                long long D, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((D + BN - 1) / BN),
                  static_cast<unsigned>((B + BM - 1) / BM));
  recon_matmul_kernel<<<grid, THREADS, 0, stream>>>(wn, d, init, out, B, K, D);
  return static_cast<int>(cudaGetLastError());
}
