// Scalar helpers for the expressions ops/scan_codegen.py emits from a
// pattern's predicates and folds: PyTorch's semantics for int32 and
// float32 arithmetic, one value at a time.
//
//   * int32 +, -, *, unary - wrap around (two's complement), as tensors do;
//   * // is floor division and % takes the divisor's sign, for ints and
//     floats alike (torch.floor_divide, torch.remainder; the float forms
//     follow c10's div_floor_floating and the remainder kernel step by
//     step);
//   * float -> int32 truncates toward zero (Tensor.to(torch.int32));
//   * float32 state is stored as its int32 bit pattern.
//
// Compiled under nvcc as __host__ __device__ and under a host compiler as
// plain inline functions, so the emitted expressions can be checked on the
// CPU.  Floating-point contraction must be off (nvcc -fmad=false, g++
// -ffp-contract=off): the plain version rounds every operation.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define CEP_HD __host__ __device__ __forceinline__
#define CEP_TABLE __constant__ const
#else
#define CEP_HD inline
#define CEP_TABLE static const
#endif

CEP_HD int32_t cep_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
CEP_HD int32_t cep_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
CEP_HD int32_t cep_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
CEP_HD int32_t cep_neg(int32_t a) { return (int32_t)(0u - (uint32_t)a); }
CEP_HD int32_t cep_abs_i(int32_t a) { return a < 0 ? cep_neg(a) : a; }
CEP_HD float cep_abs_f(float a) { return fabsf(a); }

// Integer division by zero has no tensor result to match (the CPU raises);
// it gives 0 here.  INT_MIN / -1 wraps, as the tensor op does.
CEP_HD int32_t cep_floordiv_i(int32_t a, int32_t b) {
  if (b == 0) return 0;
  if (b == -1) return cep_neg(a);
  const int32_t q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}
CEP_HD int32_t cep_mod_i(int32_t a, int32_t b) {
  if (b == 0 || b == -1) return 0;
  const int32_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

CEP_HD float cep_floordiv_f(float a, float b) {
  if (b == 0.0f) return a / b;
  const float mod = fmodf(a, b);
  float div = (a - mod) / b;
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) div -= 1.0f;
  if (div == 0.0f) return copysignf(0.0f, a / b);
  float fl = floorf(div);
  if (div - fl > 0.5f) fl += 1.0f;
  return fl;
}
CEP_HD float cep_mod_f(float a, float b) {
  float mod = fmodf(a, b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) mod += b;
  return mod;
}

CEP_HD int32_t cep_f2i(float a) { return (int32_t)a; }

CEP_HD float cep_bits_f(int32_t bits) {
  float f;
  memcpy(&f, &bits, sizeof f);
  return f;
}
CEP_HD int32_t cep_f_bits(float f) {
  int32_t bits;
  memcpy(&bits, &f, sizeof bits);
  return bits;
}
