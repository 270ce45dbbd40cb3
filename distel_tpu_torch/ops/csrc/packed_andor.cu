// Packed-contraction AND-OR product on Hopper (sm_90a), with a plain C
// interface for ctypes (no PyTorch headers: this file builds in seconds).
//
//   C[m, n] = OR_{k < K : bit k of A[m] set} B[k, n]
//
//   A  [M, KW] int32  — state rows packed along the contraction axis:
//                       bit p of word w is contraction index k = 32*w + p
//   B  [K, N]  int8   — 0/1 operand, rows in that logical order
//   C  [M, N]  int8   — 0/1 output
//
// All three are row-major and contiguous.  N is a multiple of 16 and B
// and C are 16-byte aligned (the wrapper pads N).  Words carry the
// uint32 bit pattern in int32 storage.
//
// ---------------------------------------------------------------------------
// packed_andor
//
// Replaces distel_tpu/ops/bitmatmul.py::_andor_kernel (reached through
// PackedMatmulPlan.__call__): the packed engine's CR4 (R against the
// per-step W operand) and CR6 (R against the chain operand D).
//
// Bound on this card: the function must read A once (4*M*KW bytes), the
// B rows that some set bit of A selects ((B rows selected)*N bytes) and
// write C once (M*N bytes); the work the data needs is nnz(A)*N byte-ORs
// (one per set bit of A per output byte).  A dense tensor-core product
// (unpack A to int8, wgmma) would do M*K*N int8 multiply-adds, most of
// them on zero bits: the state R is very sparse (a concept has few
// links), so at full width that is ~2e14 operations a CR6 call.
//
// Design: the work follows A's set bits, never its zeros.  A block owns
// TM rows of C and a TN-byte slice of them (256 threads, 16 bytes each).
// For each row it scans A's words 256 at a time (one coalesced word per
// thread); a pass whose 256 words are all zero costs one barrier
// (__syncthreads_or) and nothing else.  Otherwise each thread with a
// nonzero word lists its set bits (__ffs) in shared memory, and then
// every thread ORs the listed B rows' 16-byte pieces of its slice into a
// 16-byte accumulator in registers: the 0/1 bytes are ORed four to a
// 32-bit lane, which is exact because an OR never carries.  The
// epilogue maps each accumulated byte to (byte != 0) and writes the row
// slice once.  Blocks never share an output slice, so nothing carries
// between blocks, and the slices of one row block are neighbours in the
// launch order, so A's rows are read from HBM about once and from L2 for
// the other slices.  B rows are re-read for every set bit that selects
// them (from L2 when they are hot); sharing them across rows, or an int8
// tensor-core design on unpacked live tiles, is later work.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 16;                // bytes of C per thread
constexpr int TN = THREADS * VEC;      // bytes of C per block
constexpr int TM = 16;                 // rows of C per block
constexpr int SEG = THREADS;           // A words scanned per pass
constexpr int CAP = SEG * 32;          // set bits one pass can list

__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  // 0x01 in every byte of x that is nonzero, 0x00 elsewhere (no carry
  // crosses a byte: (x & 0x7f) + 0x7f <= 0xfe)
  const uint32_t t = ((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x;
  return (t >> 7) & 0x01010101u;
}

__global__ void __launch_bounds__(THREADS) packed_andor_kernel(
    const uint32_t* __restrict__ A, const int8_t* __restrict__ B,
    int8_t* __restrict__ C, int M, int KW, int K, int N) {
  __shared__ int ks[CAP];
  __shared__ int count;
  const int tid = threadIdx.x;
  const int n = blockIdx.x * TN + tid * VEC;
  const bool col_ok = n < N;             // N % VEC == 0: whole vector in
  const int m0 = blockIdx.y * TM;
  if (tid == 0) count = 0;
  __syncthreads();
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + r;
    if (m >= M) break;                   // uniform across the block
    const uint32_t* arow = A + (size_t)m * KW;
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    for (int w0 = 0; w0 < KW; w0 += SEG) {
      const int w = w0 + tid;
      uint32_t word = (w < KW) ? __ldg(arow + w) : 0u;
      // a whole pass of zero words: one barrier, then the next pass
      if (!__syncthreads_or(word != 0u)) continue;
      if (word) {
        int at = atomicAdd(&count, __popc(word));
        const int kbase = w * 32;
        while (word) {
          const int k = kbase + __ffs(word) - 1;
          word &= word - 1u;
          ks[at++] = k < K ? k : -1;     // bits past B's rows select nothing
        }
      }
      __syncthreads();
      const int listed = count;
      if (col_ok) {
#pragma unroll 4
        for (int i = 0; i < listed; ++i) {
          const int k = ks[i];
          if (k < 0) continue;
          const uint4 v = __ldg(
              reinterpret_cast<const uint4*>(B + (size_t)k * N + n));
          acc.x |= v.x;
          acc.y |= v.y;
          acc.z |= v.z;
          acc.w |= v.w;
        }
      }
      __syncthreads();                   // every thread has read the list
      if (tid == 0) count = 0;           // ordered by the next barrier
    }
    if (col_ok) {
      const uint4 out = make_uint4(nonzero_bytes(acc.x), nonzero_bytes(acc.y),
                                   nonzero_bytes(acc.z), nonzero_bytes(acc.w));
      *reinterpret_cast<uint4*>(C + (size_t)m * N + n) = out;
    }
  }
}

}  // namespace

extern "C" {

// Tile and alignment the wrapper must size its grid and buffers with.
int packed_andor_tile_m() { return TM; }
int packed_andor_tile_n() { return TN; }
int packed_andor_align() { return VEC; }

// Launches on `stream` and returns cudaGetLastError() (0 = launched); it
// neither synchronises nor allocates.
int packed_andor(const void* A, const void* B, void* C, int M, int KW, int K,
                 int N, void* stream) {
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  packed_andor_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)A, (const int8_t*)B, (int8_t*)C, M, KW, K, N);
  return (int)cudaGetLastError();
}

const char* packed_andor_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
