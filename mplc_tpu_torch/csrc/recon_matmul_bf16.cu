// K1-bf16, the fused reconstruction contraction on bf16 operands, for
// Hopper (sm_90a).
//
//   out[b, :] = init[:] + sum_k wn[b, k] * d[k, :]
//   (wn, d bf16; init, out fp32; products and sums in fp32)
//
// Replaces mplc_tpu/ops/recon_kernel.py::_recon_matmul_kernel (the Pallas
// TPU kernel behind _fused_contract, pallas_call at :130) as the JAX
// package instantiates it under precision="bf16" (:183-185, 207-208): bf16
// WN and deltas, preferred_element_type fp32, an fp32 output. wn is [B, K]
// (the renormalized round weights of B coalitions, K = rounds x partners),
// d is [K, D] (the recorded per-round per-partner parameter deltas), init
// is [D], out is [B, D]; all row-major and contiguous. A bf16 x bf16
// product is exact in fp32, so the result is the fp32 sum of the same
// terms as the plain version's, in another order.
//
// What bounds it on an H100 SXM: at the main path's shape (K = 200,
// D = 1,199,888, the stream's rows padded to a multiple of 8 values) one
// launch must read d (0.480 GB) and init (4.8 MB) and write out (B x 4.8
// MB): 0.562 GB at B = 16, 0.168 ms at 3.35 TB/s; 0.638 GB at B = 32,
// 0.191 ms; 0.792 GB at B = 64, 0.236 ms. The products, 2*B*K*D = 30.7
// GFLOP at B = 64, cost 0.031 ms on the bf16 tensor cores (989 TFLOP/s),
// so the kernel is bound by memory and its job is to stream d once, at the
// memory rate, whatever the batch width. wgmma and its 64-row tiles would
// only speed up the 0.031 ms of products, so the products stay on
// mma.sync m16n8k16 (bf16 in, fp32 accumulate).
//
// 1. d streamed by cp.async through a ring of STAGES = 4 stages of BK = 32
//    rows x BN = 128 columns (8 KB of d a stage) in shared memory: the
//    copies of step k + 3 are in flight while the MMAs of step k run
//    (commit_group / wait_group, one barrier a step), 24 KB a block and at
//    least two blocks an SM, about what Little's law asks of each of the
//    132 SMs at 3.35 TB/s. The copies are 16 bytes, cp.async.cg (L2 only,
//    so the one-pass stream does not fill L1), when D is a multiple of 8
//    and d, init and out are 16-byte aligned: every row of d then starts
//    16-byte aligned. flatten_stream pads the recorded stream's rows to a
//    multiple of 8 values for this (ops/recon_kernel.py). Any other D or
//    alignment takes the narrow route: the same ring filled by 2-byte
//    loads (odd D; a view that starts off a 16-byte boundary).
// 2. wn staged once a block: the block's [BM, K] tile, zero-padded along K
//    to a multiple of BK, is loaded into shared memory (16-byte loads when
//    K is a multiple of 8 and wn 16-byte aligned) while the ring's first
//    copies are in flight, and every step reads it from there. A K past
//    KC = 256 is staged in chunks of KC columns, each loaded when the ring
//    reaches it (again for every strip).
// 3. Fragments by ldmatrix: .x4 gives a warp the A fragment of one m16
//    tile for one k16 step from the wn tile; .x4.trans gives the B
//    fragments of its two n8 tiles from the [k][n] d tile. Row strides are
//    padded by 8 values (B_STRIDE = BN + 8, a_stride = kc + 8), an odd
//    number of 16-byte units, so the eight rows of each 8x8 matrix fall in
//    distinct banks, and every copy destination stays 16-byte aligned.
// 4. Coalition tiles that follow the batch width: templated on MT = 1, 2
//    or 4 m16 fragments a block, picked from B (<= 16, <= 32, more); past
//    64 rows the tiles go over blockIdx.y. A narrow batch does the MMAs
//    and fragment loads of its own rows only.
// 5. Sums: the tensor cores round each MMA's sum toward zero, so MMAs
//    chained over all of K pile a biased error onto a growing accumulator.
//    On standard-normal inputs at K = 200 and the main width that put the
//    chained kernel at 1.00-1.13 of the rtol 1e-4 / atol 1e-5 tolerance
//    against the plain version (2.8e-5 to 3.7e-5 from the exact sum). So
//    each step's two MMAs start from zero, a sum of 32 exact products that
//    stays small, and it joins the fp32 accumulator in one round-to-nearest
//    add (one FADD an element a step): 0.66-0.79 of the tolerance, 1.2e-5
//    to 1.4e-5 from the exact sum, where the plain fp32 product (cuBLAS)
//    lies 2.4e-5 to 2.8e-5 from it.
// 6. The epilogue adds init to the accumulators, so a coalition whose
//    weights are all zero gets init + 0 = init, bit for bit; 8-byte
//    stores of out on the 16-byte route, 4-byte ones on the narrow route.
//    The kernel masks its ragged B, K and D edges itself (zero fill,
//    masked stores).
// 7. Grid: at MT = 2 and 4 a persistent grid, as many blocks as fit on the
//    card at once (two an SM), each walking column strips gridDim.x apart,
//    with the ring running on across strips: the wn tile (up to 29.7 KB at
//    MT = 4, almost 60% of a strip's 51 KB of d) is staged once a block,
//    not once a strip, and a strip's epilogue overlaps the next strip's
//    copies. At MT = 1 one block a strip measured faster (its tile is 7.4
//    KB; the blocks then start out of step with each other).
//
// Registers and shared memory (nvcc -Xptxas -v, sm_90a, no spills):
// MT = 4 / 2 / 1 use 116 / 82 / 76 registers on the 16-byte route and
// 120 / 84 / 76 on the narrow one; 64.5 / 49.7 / 42.2 KB of shared memory
// at K = 200 (the 34.8 KB ring and the wn tile).
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's [kernels]
// lines on the bf16 main path's stream, runs of 10 back-to-back calls):
// 0.213 / 0.259 / 0.324 ms at B = 16 / 32 / 64, 1.27x / 1.36x / 1.37x the
// bound, and 0.29 / 0.39 / 0.64 ms for torch.addmm(out_dtype=float32).
// PERF.md has the times of the kernel this one replaced (4-byte register
// staging, 64 rows whatever B), taken in the same call, and the design
// steps.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BN = 128;                    // parameter columns per block
constexpr int BK = 32;                     // recorded rows per stage
constexpr int STAGES = 4;                  // depth of the cp.async ring
constexpr int KC = 256;                    // most wn columns staged at once
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;        // 256
constexpr int WARP_COLS = BN / WARPS;      // 16 columns per warp: two n8 tiles
constexpr int B_STRIDE = BN + 8;           // d tile row, in bf16 values
constexpr int STAGE_ELEMS = BK * B_STRIDE;
constexpr int RING_BYTES = STAGES * STAGE_ELEMS * 2;

static_assert(BK % 16 == 0 && KC % BK == 0 && STAGES >= 2 && WARP_COLS == 16,
              "tiling");
static_assert((B_STRIDE * 2 / 16) % 2 == 1, "conflict-free ldmatrix rows");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst, bypassing L1; zero-filled when !valid
// (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four 8x8 bf16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, register i receives its fragment
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a * b for one m16n8k16 fragment: bf16 A (row) and B (col), fp32 C
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 values travel as their raw 16 bits: the kernel only moves them
// into the tensor cores, which read them as bf16. WIDE: the 16-byte route
// (D a multiple of 8, d, init and out 16-byte aligned); else the narrow
// route. kc: the wn tile's width, K rounded up to BK (at least BK, at
// most KC)
template <int MT, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)   // at least two blocks per SM
recon_matmul_bf16_kernel(const uint16_t* __restrict__ wn,
                         const uint16_t* __restrict__ d,
                         const float* __restrict__ init,
                         float* __restrict__ out, int B, int K, long long D,
                         int kc) {
  constexpr int BM = 16 * MT;                        // coalition rows per block
  constexpr int VEC = WIDE ? 8 : 1;                  // d values per copy
  constexpr int COPIES_PER_ROW = BN / VEC;
  constexpr int B_ROW_STEP = THREADS / COPIES_PER_ROW;
  constexpr int B_COPIES = BK / B_ROW_STEP;          // per thread per stage
  static_assert(THREADS % COPIES_PER_ROW == 0 && BK % B_ROW_STEP == 0, "d staging");

  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* const ring = smem;                       // STAGES x [BK][B_STRIDE]
  uint16_t* const As = smem + STAGES * STAGE_ELEMS;  // [BM][a_stride]
  const int a_stride = kc + 8;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.y * BM;
  const int wcol = warp * WARP_COLS;

  // the block walks the strips blockIdx.x, blockIdx.x + gridDim.x, ...,
  // each in `steps` steps of BK recorded rows; the ring runs on across
  // strips, so one strip's epilogue overlaps the next one's copies
  const int steps = K > 0 ? (K + BK - 1) / BK : 1;
  const long long strips = (D + BN - 1) / BN;
  const long long total =
      (strips - blockIdx.x + gridDim.x - 1) / gridDim.x * steps;
  const long long strip_cols = static_cast<long long>(gridDim.x) * BN;

  // this thread's copies of d: rows b_row + i*B_ROW_STEP of a step, at
  // columns b_col .. b_col + VEC - 1 of the strip. Calls come in step
  // order; ld_ks / ld_col say which step of which strip is next
  const int b_row = tid / COPIES_PER_ROW, b_col = (tid % COPIES_PER_ROW) * VEC;
  const long long b_step = static_cast<long long>(B_ROW_STEP) * D;
  uint16_t* const b_dst = ring + b_row * B_STRIDE + b_col;
  int ld_ks = 0;
  long long ld_col = static_cast<long long>(blockIdx.x) * BN + b_col;

  auto load_stage = [&](int slot) {
    const int k0 = ld_ks * BK;
    // copy i is in when i*B_ROW_STEP < b_rows (WIDE: all VEC values or none)
    const int b_rows = ld_col < D ? K - k0 - b_row : 0;
    const uint16_t* src = d + static_cast<long long>(k0 + b_row) * D + ld_col;
    uint16_t* dst = b_dst + slot * STAGE_ELEMS;
#pragma unroll
    for (int i = 0; i < B_COPIES; ++i, src += b_step, dst += B_ROW_STEP * B_STRIDE) {
      const bool in = i * B_ROW_STEP < b_rows;
      if (WIDE) {
        cp_async16(smem_addr(dst), src, in);
      } else {
        *dst = in ? *src : 0;   // plain loads: visible after the next barriers
      }
    }
    if (++ld_ks == steps) {
      ld_ks = 0;
      ld_col += strip_cols;
    }
  };

  // wn columns kbase .. kbase + kc - 1 of the block's rows, zero past B
  // and K
  const bool wn_wide = K % 8 == 0 && reinterpret_cast<uintptr_t>(wn) % 16 == 0;
  auto stage_wn = [&](int kbase) {
    if (wn_wide) {
      const int units = kc / 8;
      for (int i = tid; i < BM * units; i += THREADS) {
        const int r = i / units, c = (i % units) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row0 + r < B && kbase + c < K)
          v = *reinterpret_cast<const uint4*>(wn + static_cast<long long>(row0 + r) * K + kbase + c);
        *reinterpret_cast<uint4*>(As + r * a_stride + c) = v;
      }
    } else {
      for (int i = tid; i < BM * kc; i += THREADS) {
        const int r = i / kc, c = i % kc;
        As[r * a_stride + c] = (row0 + r < B && kbase + c < K)
            ? wn[static_cast<long long>(row0 + r) * K + kbase + c] : 0;
      }
    }
  };

  // ldmatrix row addresses: for A, lane l gives row l % 16 at k offset
  // (l / 16) * 8 (matrices: rows 0-7 / 8-15 x k 0-7, then k 8-15: a0..a3
  // of m16n8k16); for B (.trans), lane l gives k row (l % 8) + 8 * ((l / 8)
  // % 2) at n offset (l / 16) * 8 (matrices: k 0-7 / 8-15 of n tile 0,
  // then of n tile 1: b0, b1 of each)
  const uint32_t a_lane = smem_addr(As + (lane % 16) * a_stride + (lane / 16) * 8);
  const uint32_t b_lane = smem_addr(ring + ((lane % 8) + 8 * ((lane / 8) % 2)) * B_STRIDE +
                                    wcol + (lane / 16) * 8);

  float acc[MT][2][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;
  };

  // out = init + acc for the strip at col0. Element j of fragment (mt, nt)
  // sits at row mt*16 + g (+8 for j >= 2), column wcol + nt*8 + 2t (+1 for
  // odd j)
  auto epilogue = [&](long long col0) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const long long c = col0 + wcol + nt * 8 + 2 * t;
      if (c >= D) continue;
      float i0, i1;
      if (WIDE) {   // D a multiple of 8: c + 1 < D, and 8-byte aligned
        const float2 v = *reinterpret_cast<const float2*>(init + c);
        i0 = v.x;
        i1 = v.y;
      } else {
        i0 = init[c];
        i1 = c + 1 < D ? init[c + 1] : 0.0f;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + mt * 16 + g + 8 * h;
          if (r >= B) continue;
          float* o = out + static_cast<long long>(r) * D + c;
          const float v0 = i0 + acc[mt][nt][2 * h];
          const float v1 = i1 + acc[mt][nt][2 * h + 1];
          if (WIDE) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            if (c + 1 < D) o[1] = v1;
          }
        }
      }
    }
  };

  zero_acc();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load_stage(s);
    cp_async_commit();
  }
  stage_wn(0);   // while the ring's first copies are in flight

  constexpr int CHUNK_STEPS = KC / BK;
  constexpr int KS = BK / 16;                      // k16 MMAs per step
  int ks = 0, slot = 0, ld_slot = STAGES - 1;
  long long col0 = static_cast<long long>(blockIdx.x) * BN;
  for (long long step = 0; step < total; ++step) {
    cp_async_wait<STAGES - 2>();   // this step's copies have landed ...
    __syncthreads();               // ... for every thread, and the slot
                                   // refilled below is no longer read
    const int kw = (ks % CHUNK_STEPS) * BK;   // the step's column in the wn tile
    if (kw == 0 && step > 0 && steps > CHUNK_STEPS) {   // K past KC: next chunk
      stage_wn(ks * BK);
      __syncthreads();
    }
    if (step + STAGES - 1 < total) load_stage(ld_slot);
    cp_async_commit();
    ld_slot = ld_slot + 1 == STAGES ? 0 : ld_slot + 1;

    // the tensor cores round each MMA's sum toward zero: the step's KS
    // MMAs start from zero, so that sum stays small, and it joins the
    // accumulator in one round-to-nearest fp32 add
    const uint32_t b_slot = b_lane + slot * STAGE_ELEMS * 2;
    uint32_t b[KS][4];
#pragma unroll
    for (int s = 0; s < KS; ++s) ldmatrix_x4_trans(b[s], b_slot + s * 16 * B_STRIDE * 2);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[KS][4];
#pragma unroll
      for (int s = 0; s < KS; ++s)
        ldmatrix_x4(a[s], a_lane + (mt * 16 * a_stride + kw + 16 * s) * 2);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int s = 0; s < KS; ++s) mma_bf16(part, a[s], b[s][2 * nt], b[s][2 * nt + 1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] += part[j];
      }
    }
    slot = slot + 1 == STAGES ? 0 : slot + 1;

    if (++ks == steps) {   // the strip's last step
      epilogue(col0);
      zero_acc();
      ks = 0;
      col0 += strip_cols;
    }
  }
}

template <int MT, bool WIDE>
cudaError_t launch(const uint16_t* wn, const uint16_t* d, const float* init,
                   float* out, int B, int K, long long D, cudaStream_t stream) {
  constexpr int BM = 16 * MT;
  // K = 0 still takes one (all-zero) step, so the tile is at least BK wide
  const int kc = K <= BK ? BK : K < KC ? (K + BK - 1) / BK * BK : KC;
  const int smem = RING_BYTES + BM * (kc + 8) * 2;
  auto kernel = recon_matmul_bf16_kernel<MT, WIDE>;
  // past 48 KB a block's shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long strips = (D + BN - 1) / BN;
  const unsigned row_tiles = static_cast<unsigned>((B + BM - 1) / BM);
  long long blocks = strips;   // MT = 1: one strip a block
  if (MT > 1) {   // as many blocks as fit on the card at once, each walking its strips
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) != cudaSuccess)
      return err;
    const long long resident = static_cast<long long>(sms) * per_sm / row_tiles;
    if (resident >= 1 && resident < blocks) blocks = resident;
  }
  const dim3 grid(static_cast<unsigned>(blocks), row_tiles);
  kernel<<<grid, THREADS, smem, stream>>>(wn, d, init, out, B, K, D, kc);
  return cudaGetLastError();
}

template <bool WIDE>
cudaError_t launch_width(const uint16_t* wn, const uint16_t* d, const float* init,
                         float* out, int B, int K, long long D, cudaStream_t stream) {
  if (B <= 16) return launch<1, WIDE>(wn, d, init, out, B, K, D, stream);
  if (B <= 32) return launch<2, WIDE>(wn, d, init, out, B, K, D, stream);
  return launch<4, WIDE>(wn, d, init, out, B, K, D, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
// wn and d point to bf16 data.
extern "C" int recon_matmul_bf16(const void* wn, const void* d,
                                 const float* init, float* out, int B, int K,
                                 long long D, cudaStream_t stream) {
  const auto* wn16 = static_cast<const uint16_t*>(wn);
  const auto* d16 = static_cast<const uint16_t*>(d);
  // 16-byte copies of d need every row of d 16-byte aligned: D a multiple
  // of 8 and d's base pointer aligned; init and out then take 8-byte
  // accesses at every even column
  const bool wide = D % 8 == 0 && aligned16(d) && aligned16(init) && aligned16(out);
  const cudaError_t err =
      wide ? launch_width<true>(wn16, d16, init, out, B, K, D, stream)
           : launch_width<false>(wn16, d16, init, out, B, K, D, stream);
  return static_cast<int>(err);
}
