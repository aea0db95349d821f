// msm_reduce / msm_fold: the tail of a multi-scalar multiplication, after
// the window-sums kernel (msm.cu) has left one partial a window a block.
//
// Replaces no TPU kernel: the reference package sums the partials with
// curve/points.py:reduce_sum (ops/pallas_msm.py:318) and folds the window
// sums with parallel/msm.py:horner_spine, both in XLA.  In plain PyTorch on
// the card each of them is a tree of point additions on tensors of a few
// thousand limbs, every field operation a launch of its own: some 10,000
// launches a call, paced by the host, for a few milliseconds of arithmetic.
// Here each is one launch, and every value stays on the card.
//
// msm_reduce_kernel.  Partials (5, 20, nwin, blocks) -> window sums
// (5, 20, nwin): one block of threads a window.  The window's partials sit
// in dynamic shared memory as (5 x 20 rows, blocks columns), so consecutive
// threads read consecutive words.  The additions follow reduce_sum's tree
// level by level: of n elements the low half [0, n/2) takes in the high
// half [n/2, 2(n/2)) as extended Niels points, element i of the one plus
// element i of the other into position i, and an odd last element moves to
// position n/2; a barrier ends each level.  So the sum is reduce_sum's
// limb for limb, under the lazy bounds the plain code meets.  A thread
// writes only position i, which no other thread reads in that level; the
// odd element's move waits for a barrier, since position n/2 is read in it.
//
// msm_fold_kernel.  Window sums (5, 20, nwin) and wbits -> one point,
// sum_w [2^(wbits*w)] W_w, by Horner from the most significant window:
// acc = W_{nwin-1}, then for each lower window wbits doublings and one
// addition of W_w as an extended Niels point.  One thread does it all in
// registers: its critical path, (nwin - 1) * wbits doublings (250 for 51
// windows of 5 bits), is the same under any schedule, since
// [2^(wbits*(nwin-1))] W_{nwin-1} needs them.  ops/msm.py:fold_plain takes
// the same steps in the same order.
//
// What bounds them: latency.  msm_reduce's work at 51 windows of 264
// partials is 13,413 additions, ceil(log2 264) = 9 of them on a thread's
// path; msm_fold's is 250 doublings and 50 additions on one thread, about
// 2,250 field products in a chain.  Neither moves more than 110 KB.
//
// The outline boundary.  fe_mul / fe_square are real functions
// (JJ_OUTLINE_MUL, field.cuh); the group operations are inlined.  With the
// products inlined too, a doubling loop and an addition together pass the
// 8,000 instructions past which a loop ran slow on the H100 (PERF.md), and
// one thread alone cannot hide an instruction fetch.
//
// C interface (loaded with ctypes); returns cudaGetLastError() after the
// launch, or the error of cudaFuncSetAttribute, or -1 for a refused shape.
// Built as plain C++ the entry points run the threads in host loops (the
// tests hold that build against the plain versions).

#include <stddef.h>

#define JJ_OUTLINE_MUL
#include "point.cuh"

namespace jj {

constexpr int MSM_REDUCE_MAX_BLOCKS = 512;  // partials a window (shared memory)
constexpr int MSM_REDUCE_THREADS = MSM_REDUCE_MAX_BLOCKS / 2;
constexpr int EXT_WORDS = 5 * NL;           // words of an extended point

// point i of a window's partials in shared memory: row c*NL + j of
// `cols` columns holds limb j of coordinate c
JJ_HD void reduce_load(Ext& p, const int32_t* sm, int cols, int i) {
  ext_load(p, sm, sm + NL * cols, sm + 2 * NL * cols, sm + 3 * NL * cols,
           sm + 4 * NL * cols, cols, i);
}

JJ_HD void reduce_store(int32_t* sm, int cols, int i, const Ext& p) {
  ext_store(sm, sm + NL * cols, sm + 2 * NL * cols, sm + 3 * NL * cols,
            sm + 4 * NL * cols, cols, i, p);
}

// one addition of a level of n elements: position i (< n/2) += niels(i + n/2)
JJ_HD void reduce_add(int32_t* sm, int cols, int n, int i) {
  Ext lo, hi;
  reduce_load(lo, sm, cols, i);
  reduce_load(hi, sm, cols, n / 2 + i);
  ENiels hn;
  pt_to_niels(hn, hi);
  pt_add_extended_niels(lo, hn);
  reduce_store(sm, cols, i, lo);
}

// one thread's fold of window sums ws (5, 20, nwin) into out (5, 20)
JJ_HD void fold_lane(const int32_t* ws, int nwin, int wbits, int32_t* out) {
  const int64_t cs = (int64_t)NL * nwin;
  Ext acc, w;
  ENiels wn;
  ext_load(acc, ws, ws + cs, ws + 2 * cs, ws + 3 * cs, ws + 4 * cs, nwin,
           nwin - 1);
#pragma unroll 1
  for (int i = nwin - 2; i >= 0; --i) {
#pragma unroll 1
    for (int k = 0; k < wbits; ++k) pt_double(acc);
    ext_load(w, ws, ws + cs, ws + 2 * cs, ws + 3 * cs, ws + 4 * cs, nwin, i);
    pt_to_niels(wn, w);
    pt_add_extended_niels(acc, wn);
  }
  ext_store(out, out + NL, out + 2 * NL, out + 3 * NL, out + 4 * NL, 1, 0,
            acc);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(MSM_REDUCE_THREADS)
msm_reduce_kernel(const int32_t* __restrict__ partials, int nwin, int blocks,
                  int32_t* __restrict__ out) {
  extern __shared__ int32_t reduce_smem[];
  const int w = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  for (int q = tid; q < EXT_WORDS * blocks; q += nt) {
    const int row = q / blocks, b = q - row * blocks;
    reduce_smem[q] = partials[((int64_t)row * nwin + w) * blocks + b];
  }
  __syncthreads();
#pragma unroll 1
  for (int n = blocks; n > 1; n = n / 2 + n % 2) {
#pragma unroll 1
    for (int i = tid; i < n / 2; i += nt) reduce_add(reduce_smem, blocks, n, i);
    if (n % 2) {
      __syncthreads();  // position n/2 is read in this level
      for (int row = tid; row < EXT_WORDS; row += nt)
        reduce_smem[row * blocks + n / 2] = reduce_smem[row * blocks + n - 1];
    }
    __syncthreads();
  }
  for (int row = tid; row < EXT_WORDS; row += nt)
    out[(int64_t)row * nwin + w] = reduce_smem[row * blocks];
}

__global__ void msm_fold_kernel(const int32_t* __restrict__ ws, int nwin,
                                int wbits, int32_t* __restrict__ out) {
  fold_lane(ws, nwin, wbits, out);
}
#endif

}  // namespace jj

#ifndef __CUDACC__
#include <vector>
#endif

// partials (5, 20, nwin, blocks) -> out (5, 20, nwin), int32; 1 <= blocks
// <= MSM_REDUCE_MAX_BLOCKS
extern "C" int jj_msm_reduce(const void* partials, int nwin, int64_t blocks,
                             void* out, void* stream) {
  if (nwin < 1 || blocks < 1 || blocks > jj::MSM_REDUCE_MAX_BLOCKS) return -1;
  const int32_t* in = (const int32_t*)partials;
  int32_t* o = (int32_t*)out;
  const int nb = (int)blocks;
#ifdef __CUDACC__
  const size_t bytes = (size_t)jj::EXT_WORDS * nb * 4;
  cudaError_t e = cudaFuncSetAttribute(
      jj::msm_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  // a thread for each addition of the first level, in whole warps
  const int half = nb / 2 > 0 ? nb / 2 : 1;
  const unsigned threads = (unsigned)((half + 31) / 32 * 32);
  jj::msm_reduce_kernel<<<(unsigned)nwin, threads, bytes,
                          (cudaStream_t)stream>>>(in, nwin, nb, o);
  return (int)cudaGetLastError();
#else
  // the kernel's levels for one window after another, a level's additions
  // in a loop; a vector in place of shared memory
  (void)stream;
  std::vector<int32_t> sm((size_t)jj::EXT_WORDS * nb);
  for (int w = 0; w < nwin; ++w) {
    for (int row = 0; row < jj::EXT_WORDS; ++row)
      for (int b = 0; b < nb; ++b)
        sm[(size_t)row * nb + b] = in[((int64_t)row * nwin + w) * nb + b];
    for (int n = nb; n > 1; n = n / 2 + n % 2) {
      for (int i = 0; i < n / 2; ++i) jj::reduce_add(sm.data(), nb, n, i);
      if (n % 2)
        for (int row = 0; row < jj::EXT_WORDS; ++row)
          sm[(size_t)row * nb + n / 2] = sm[(size_t)row * nb + n - 1];
    }
    for (int row = 0; row < jj::EXT_WORDS; ++row)
      o[(int64_t)row * nwin + w] = sm[(size_t)row * nb];
  }
  return 0;
#endif
}

// window sums (5, 20, nwin) -> out (5, 20): sum_w [2^(wbits*w)] W_w, int32
extern "C" int jj_msm_fold(const void* wsums, int nwin, int wbits, void* out,
                           void* stream) {
  if (nwin < 1 || wbits < 1) return -1;
  const int32_t* ws = (const int32_t*)wsums;
  int32_t* o = (int32_t*)out;
#ifdef __CUDACC__
  jj::msm_fold_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(ws, nwin, wbits, o);
  return (int)cudaGetLastError();
#else
  (void)stream;
  jj::fold_lane(ws, nwin, wbits, o);
  return 0;
#endif
}
