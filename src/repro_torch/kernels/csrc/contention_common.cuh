// What the contention fixpoint kernel (contention_sm90.cu) keeps apart
// from its own loop: the reference's constants, the NaN-keeping float64 max and min, and the split variant's
// per-phase clock.  kernels/build.py hashes every csrc/*.cuh into each
// library's name, so an edit here rebuilds every kernel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LINKS = 8;
constexpr int SMEM_LIMIT = 232448;          // 227 KB, the most a block may take
constexpr double EPS = 1e-12;               // network.py's _EPS
constexpr double TINY = 2.2250738585072014e-308;   // finfo(float64).tiny
constexpr unsigned FULL = 0xffffffffu;

// max / min that keep NaN, as torch.maximum / amax and jnp.max do; exact on
// every other pair.
__device__ __forceinline__ double dmax(double a, double b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ double dmin(double a, double b) {
  return (a < b || a != a) ? a : b;
}

// The phases of a split variant, in the order of its (B, PHASES) output:
// the replay walk (with this round's slot delays); the activity pass (with
// the round's transfer staging and first min); the count pass and its
// reductions; inc and the divisions; the rate update; the event's
// candidates and their min; the update of what remains (with the round's
// new durations and freeze).
enum Phase { P_REPLAY, P_ACTIVITY, P_COUNT, P_INC, P_RATE, P_EVENT, P_REMAIN, PHASES };

// clock64() deltas of a thread's chain, per phase; nothing unless SPLIT.
template <bool SPLIT>
struct Split {
  long long at = 0, cycles[PHASES] = {};
  __device__ __forceinline__ void start() {
    if constexpr (SPLIT) at = clock64();
  }
  __device__ __forceinline__ void stamp(int phase) {
    if constexpr (SPLIT) {
      const long long now = clock64();
      cycles[phase] += now - at;
      at = now;
    }
  }
  // thread 0's cycles, as row b of the (B, PHASES) output
  __device__ __forceinline__ void write(long long* out, int b) const {
    if constexpr (SPLIT) {
      if (threadIdx.x == 0)
        for (int p = 0; p < PHASES; ++p) out[static_cast<int64_t>(b) * PHASES + p] = cycles[p];
    }
  }
};

}  // namespace
