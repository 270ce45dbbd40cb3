// Packed-columns AND-OR product on Hopper (sm_90a), with a plain C
// interface for ctypes (no PyTorch headers: this file builds in seconds).
//
//   C[m, w] = OR_{l : A[m, l] != 0} B[l, w]
//
//   A  [M, L] int8   — per-step operand (closure mask AND bit table)
//   B  [L, W] int32  — packed state rows, 32 x-columns per word
//   C  [M, W] int32  — packed output rows
//
// All three are row-major and contiguous.  Words carry the uint32 bit
// pattern in int32 storage; the product only ANDs and ORs whole words,
// so the sign bit is just bit 31.
//
// Both kernels compute every output word exactly: acc |= B[l, w] & mask
// with mask = -(A[m, l] != 0).  There is no count and no threshold, so
// nothing can overflow or wrap whatever L is.
//
// Block tile: TM rows x TW words of C, 256 threads, each thread owning
// RM rows x RW words (32 accumulators in registers).  The contraction
// axis streams through shared memory TL rows at a time.  Blocks never
// share an output tile, so no sum carries between blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;    // rows of C per block
constexpr int TW = 128;   // words of C per block
constexpr int TL = 32;    // contraction rows per shared-memory stage
constexpr int THREADS = 256;
constexpr int RM = 8;     // rows per thread   (TM = 8 warps x RM)
constexpr int RW = 4;     // words per thread  (TW = 32 lanes x RW)

static_assert(TM == (THREADS / 32) * RM, "one warp per RM-row band");
static_assert(TW == 32 * RW, "one lane per RW-word group");

struct Tiles {
  // As[l][m]: all-ones where A[m0 + m, l0 + l] != 0, else zero
  alignas(16) int32_t As[TL][TM];
  // Bs[l][w]: B[l0 + l, w0 + w] (zero past the edges)
  alignas(16) int32_t Bs[TL][TW];
};

// Stage one (TL x TM) A tile and one (TL x TW) B tile.  A is read a
// byte per thread down a column of TL bytes; the 32-byte sector of a
// row stays in L1 across the 8 loads, so each A byte crosses from L2
// once.  B rows are read 128 consecutive words at a time (coalesced).
__device__ __forceinline__ void stage(
    const int8_t* __restrict__ A, const int32_t* __restrict__ B,
    int M, int L, int W, int m0, int w0, int l0, Tiles& t, int tid) {
  {
    const int m = tid & (TM - 1);
    const int g = tid / TM;                 // 0..3: which 8 rows of l
    const int gm = m0 + m;
    const bool row_ok = gm < M;
    const int8_t* arow = A + (size_t)gm * L;
#pragma unroll
    for (int j = 0; j < TL / (THREADS / TM); ++j) {
      const int l = g * (TL / (THREADS / TM)) + j;
      const int gl = l0 + l;
      const int8_t v = (row_ok && gl < L) ? arow[gl] : (int8_t)0;
      t.As[l][m] = v ? -1 : 0;
    }
  }
  {
    const int w = tid & (TW - 1);
    const int lr = tid / TW;                // 0..1
    const int gw = w0 + w;
    const bool col_ok = gw < W;
#pragma unroll
    for (int j = 0; j < TL / (THREADS / TW); ++j) {
      const int l = lr + j * (THREADS / TW);
      const int gl = l0 + l;
      t.Bs[l][w] = (col_ok && gl < L) ? B[(size_t)gl * W + gw] : 0;
    }
  }
}

// acc[r][c] |= As[l][row r] & Bs[l][word c] over the staged TL rows.
// A warp shares its rows, so the As reads are broadcasts; the Bs reads
// are 16-byte vectors over 512 consecutive bytes (conflict-free).
__device__ __forceinline__ void contract(
    const Tiles& t, int tx, int ty, int32_t (&acc)[RM][RW]) {
#pragma unroll 8
  for (int l = 0; l < TL; ++l) {
    const int4 a0 = *reinterpret_cast<const int4*>(&t.As[l][ty * RM]);
    const int4 a1 = *reinterpret_cast<const int4*>(&t.As[l][ty * RM + 4]);
    const int4 b = *reinterpret_cast<const int4*>(&t.Bs[l][tx * RW]);
    const int32_t a[RM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const int32_t bw[RW] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < RM; ++r) {
#pragma unroll
      for (int c = 0; c < RW; ++c) acc[r][c] |= a[r] & bw[c];
    }
  }
}

__device__ __forceinline__ void store(
    int32_t* __restrict__ C, int M, int W, int m0, int w0, int tx, int ty,
    const int32_t (&acc)[RM][RW]) {
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int gm = m0 + ty * RM + r;
    if (gm >= M) break;
#pragma unroll
    for (int c = 0; c < RW; ++c) {
      const int gw = w0 + tx * RW + c;
      if (gw < W) C[(size_t)gm * W + gw] = acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// packed_cols_dense
//
// Replaces distel_tpu/ops/bitmatmul.py::_packed_cols_kernel (reached
// through PackedColsMatmulPlan.__call__ with skip_zero_tiles=False).
//
// Bound on this card: the function moves M*L + 4*L*W + 4*M*W bytes and
// does M*L*W word-ANDs (32*M*L*W bit multiply-adds).  At the main path's
// shapes (L, W in the thousands) the operation count dominates: the
// int8 tensor-core formulation of the same bits would do 2*32*M*L*W ops
// at 1,979 TOP/s, while the 3.35 TB/s memory moves the bytes in far less.
//
// Design: the work is done 32 bits at a time on the integer pipes, one
// LOP3 per output word per contraction row, which does 32 bit-MACs per
// instruction and never unpacks B or repacks C.  Each block loops over
// the whole of L for its own output tile in registers, so C is written
// once and A and B are each read once per output tile.  A tensor-core
// design (unpack B to int8 in shared memory, int8 mma with int32
// accumulation, threshold and repack in the epilogue) is later work.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) packed_cols_dense_kernel(
    const int8_t* __restrict__ A, const int32_t* __restrict__ B,
    int32_t* __restrict__ C, int M, int L, int W) {
  __shared__ Tiles t;
  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  const int w0 = blockIdx.x * TW, m0 = blockIdx.y * TM;
  int32_t acc[RM][RW] = {};
  for (int l0 = 0; l0 < L; l0 += TL) {
    stage(A, B, M, L, W, m0, w0, l0, t, tid);
    __syncthreads();
    contract(t, tx, ty, acc);
    __syncthreads();
  }
  store(C, M, W, m0, w0, tx, ty, acc);
}

// ---------------------------------------------------------------------------
// packed_cols_sparse
//
// Replaces distel_tpu/ops/bitmatmul.py::_packed_cols_sparse_kernel
// (PackedColsMatmulPlan with skip_zero_tiles=True: live-tile CR6 and
// large plans).
//
// Bound on this card: the same function as packed_cols_dense, but the
// work the data needs is only that of the nonzero A entries: nnz(A)*W
// word-ORs, and the B rows that some nonzero entry selects.  At the
// CR6 operand's measured sparsity (most A tiles all zero) the dense
// kernel's cost is almost all dead tiles.
//
// Design: the wrapper lists, per TM-row block, the TL-row contraction
// tiles whose A tile has any nonzero (live_k [GM, GK], n_live [GM]) —
// the counterpart of the TPU kernel's scalar-prefetch flags and its
// last-live redirect.  A block walks only its listed tiles, so a dead
// tile costs no load of A or B and no instruction.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) packed_cols_sparse_kernel(
    const int8_t* __restrict__ A, const int32_t* __restrict__ B,
    const int32_t* __restrict__ live_k, const int32_t* __restrict__ n_live,
    int32_t* __restrict__ C, int M, int L, int W, int GK) {
  __shared__ Tiles t;
  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  const int w0 = blockIdx.x * TW, m0 = blockIdx.y * TM;
  const int32_t* ks = live_k + (size_t)blockIdx.y * GK;
  const int n = n_live[blockIdx.y];
  int32_t acc[RM][RW] = {};
  for (int i = 0; i < n; ++i) {
    stage(A, B, M, L, W, m0, w0, ks[i] * TL, t, tid);
    __syncthreads();
    contract(t, tx, ty, acc);
    __syncthreads();
  }
  store(C, M, W, m0, w0, tx, ty, acc);
}

}  // namespace

extern "C" {

// Tile sizes the wrapper must build its live-tile lists with.
int packed_cols_tile_m() { return TM; }
int packed_cols_tile_l() { return TL; }
int packed_cols_tile_w() { return TW; }

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched); it neither synchronises nor allocates.
int packed_cols_dense(const void* A, const void* B, void* C, int M, int L,
                      int W, void* stream) {
  dim3 grid((W + TW - 1) / TW, (M + TM - 1) / TM);
  packed_cols_dense_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)A, (const int32_t*)B, (int32_t*)C, M, L, W);
  return (int)cudaGetLastError();
}

int packed_cols_sparse(const void* A, const void* B, const void* live_k,
                       const void* n_live, void* C, int M, int L, int W,
                       int GK, void* stream) {
  dim3 grid((W + TW - 1) / TW, (M + TM - 1) / TM);
  packed_cols_sparse_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)A, (const int32_t*)B, (const int32_t*)live_k,
      (const int32_t*)n_live, (int32_t*)C, M, L, W, GK);
  return (int)cudaGetLastError();
}

const char* packed_cols_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
