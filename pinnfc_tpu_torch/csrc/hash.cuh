// Counter-based Wang hash shared by the dropout masks of the MC-dropout and the
// training kernels: the TPU kernels' _wang_hash
// (pinnfc_tpu/ops/pallas_mc_dropout.py), bit for bit, in wrapping uint32.
#pragma once

#include <stdint.h>

static __device__ __forceinline__ uint32_t wang_hash(uint32_t x) {
  x = (x ^ 61u) ^ (x >> 16);
  x *= 9u;
  x = x ^ (x >> 4);
  x *= 0x27D4EB2Du;
  x = x ^ (x >> 15);
  x *= 2654435761u;
  x = x ^ (x >> 13);
  return x;
}

// The hashed layer salt wang(salt + 0x9E3779B9) that every element of a mask
// XORs into its counter.
static __device__ __forceinline__ uint32_t hashed_salt(uint32_t salt) {
  return wang_hash(salt + 0x9E3779B9u);
}
