// fq_sqrt: Fq's square root, one lane a thread, the whole root in one launch.
//
// Replaces no TPU kernel: the reference package computes the root in XLA
// (jubjub_tpu/fields/sqrt.py), and the port's plain version,
// fields/sqrt.py:_sqrt_tonelli_shanks, runs it as about 1,350 launches of
// mont_square / mont_mul and thousands of plain PyTorch carry chains, each
// sending a 20-limb plane of the whole batch through device memory.  Here
// every value of the computation stays in one thread's registers: a lane
// reads its input once and writes its root and its ok byte once.
//
// The algorithm is the plain version's, value for value.  p - 1 = 2^S * t
// (S = 32).  w = a^((t-1)/2), x = a*w (a^((t+1)/2)), b = x*w = a^t, which
// lies in the 2-Sylow subgroup: b = c^e for the root of unity c of order
// 2^S.  For i = 0..S-1, bit i of e is set iff d^(2^(S-1-i)) == -1, where d
// is b with the bits found so far taken out (d *= cinv^(2^i)); the root is
// x * c^(-e/2) (corr *= cinv^(2^(i-1))), and a is a square iff e is even.
//
// Constant pattern (docs/design.md): every lane and every call runs the
// same sequence of operations; no branch and no load depends on a lane's
// value.
//  - a^((t-1)/2) is a fixed schedule over the public exponent's bits
//    (sqrt_constants.cuh: FQ_SQRT_STEPS, windows of one or two bits, so a
//    multiplier is a or a^3, both in registers).  The branches on a step's
//    entry are uniform across the warp.  No window table is kept: 16
//    entries would be 320 registers and go to local memory.
//  - For bit i the plain version runs a ladder of S-1 squarings and keeps
//    the first S-1-i of them; this kernel runs just those (496 squarings in
//    all, not 992).  Which squarings run depends on the loop indices only.
//  - The bit test is a comparison with the Montgomery form of p - 1 after
//    one conditional subtraction (the value is then canonical); both
//    products of a step are always computed and the bit only picks between
//    computed values (ct_mask / fe_pick).  At i = 0 the correction is 1, so
//    that step's product leaves corr's value as it is (the plain version
//    skips it).
//  - The constant tables are indexed by the loop counter, the same in every
//    thread: broadcast reads from constant memory.
// The outer loops stay rolled (#pragma unroll 1): a loop body holds at most
// two products and a square, far below the 8,000 instructions past which a
// loop ran slow on the H100 (PERF.md).
//
// Inputs and results: a is a (20, n) int32 plane of Montgomery residues,
// 13-bit limbs, value below 5p (a^2 must meet fe_square's precondition, as
// in the plain version).  root: the Montgomery product x * corr, lazily
// reduced below 2p, or 0 where a == 0 mod p; it is the plain version's
// field element, not always its limbs (the products are grouped
// differently), and is undefined where a is no square, as there.  ok[i] is
// 1 where a is a square (0 included), else 0: the plain version's mask.
//
// What bounds it: operations.  A lane does 717 squarings and 149 products
// (ops/sqrt.py:op_counts) against 81 bytes moved; at the card's int32 rate
// that is about 30 ms at 2^20 lanes, the bytes 0.03 ms.
//
// C interface (loaded with ctypes); returns cudaGetLastError() after the
// launch, -1 for a refused shape.  Built as plain C++ the entry point runs
// the lane function in a host loop (used by the tests).

#include "field.cuh"
#include "sqrt_constants.cuh"

namespace jj {

// all ones where the canonical x equals the constant -1 (Montgomery form)
JJ_HD uint32_t eq_minus_one(const Fe& x) {
  int32_t diff = 0;
  static_for<0, NL>([&](auto J) {
    constexpr int j = decltype(J)::value;
    constexpr int32_t m = FqSqrtC::minus_one(j);
    diff |= x.v[j] ^ m;
  });
  return ct_mask(diff == 0);
}

// all ones where a == 0 mod p: a * 2^-260 reduced, then made canonical
JJ_HD uint32_t is_zero_mask(const Fe& a) {
  uint32_t c[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) c[j] = j < NL ? (uint32_t)a.v[j] : 0u;
  Fe z;
  mont_reduce<FqC>(z, c);  // (a + k*p) / 2^260 <= p
  fe_cond_sub_kp<FqC, 1>(z);
  int32_t any = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) any |= z.v[j];
  return ct_mask(any == 0);
}

// w = a^((t-1)/2) along FQ_SQRT_STEPS
JJ_HD void pow_t_minus_one_half(Fe& w, const Fe& a) {
  Fe a3, m;
  fe_square<FqC>(a3, a);
  fe_mul<FqC>(a3, a3, a);
  fe_select(w, (FQ_SQRT_STEPS[0] & 3) == 3, a3, a);
#pragma unroll 1
  for (int k = 1; k < FqSqrtC::NSTEPS; ++k) {
    const int step = FQ_SQRT_STEPS[k];
#pragma unroll 1
    for (int j = 0; j < (step >> 2); ++j) fe_square<FqC>(w, w);
    if (step & 3) {
      fe_select(m, (step & 3) == 3, a3, a);
      fe_mul<FqC>(w, w, m);
    }
  }
}

JJ_HD void fq_sqrt_lane(const int32_t* a_in, int32_t* root, uint8_t* ok,
                        int64_t n, int64_t i) {
  constexpr int S = FqSqrtC::S;
  Fe a, w, x, d, corr, sgn, t;
  fe_load(a, a_in, n, i);
  const uint32_t zero = is_zero_mask(a);
  pow_t_minus_one_half(w, a);
  fe_mul<FqC>(x, a, w);  // a^((t+1)/2)
  fe_mul<FqC>(d, x, w);  // a^t = c^e
  fe_one<FqC>(corr);
  uint32_t odd = 0;
#pragma unroll 1
  for (int k = 0; k < S; ++k) {
    sgn = d;  // d^(2^(S-1-k)) is +1 or -1
#pragma unroll 1
    for (int j = 0; j < S - 1 - k; ++j) fe_square<FqC>(sgn, sgn);
    fe_cond_sub_kp<FqC, 1>(sgn);
    const uint32_t bit = eq_minus_one(sgn);  // bit k of e
#pragma unroll
    for (int j = 0; j < NL; ++j) t.v[j] = FQ_SQRT_CINV_POW[k][j];
    fe_mul<FqC>(t, d, t);
    fe_pick(d, bit, t, d);
#pragma unroll
    for (int j = 0; j < NL; ++j) t.v[j] = FQ_SQRT_HALF_POW[k][j];
    fe_mul<FqC>(t, corr, t);
    fe_pick(corr, bit, t, corr);
    if (k == 0) odd = bit;
  }
  fe_mul<FqC>(t, x, corr);  // a^((t+1)/2) * c^(-e/2)
#pragma unroll
  for (int j = 0; j < NL; ++j) t.v[j] &= (int32_t)~zero;
  fe_store(root, n, i, t);
  ok[i] = (uint8_t)((~odd | zero) & 1u);
}

#ifdef __CUDACC__
__global__ void fq_sqrt_kernel(const int32_t* __restrict__ a,
                               int32_t* __restrict__ root,
                               uint8_t* __restrict__ ok, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) fq_sqrt_lane(a, root, ok, n, i);
}
#endif

}  // namespace jj

// a, root: (20, n) int32 Fq planes; ok: n bytes.  threads: a block's
// threads, a multiple of 32 up to 1024.
extern "C" int jj_fq_sqrt(const void* a, void* root, void* ok, int64_t n,
                          int threads, void* stream) {
  const int32_t* pa = (const int32_t*)a;
  int32_t* pr = (int32_t*)root;
  uint8_t* po = (uint8_t*)ok;
  if (n < 0 || threads <= 0 || threads > 1024 || threads % 32 != 0) return -1;
#ifdef __CUDACC__
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (n)
    jj::fq_sqrt_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        pa, pr, po, n);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (int64_t i = 0; i < n; ++i) jj::fq_sqrt_lane(pa, pr, po, n, i);
  return 0;
#endif
}
