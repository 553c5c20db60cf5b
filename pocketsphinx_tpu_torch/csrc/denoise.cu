// Noise removal's gains recurrence (fe_noise.c:65-364; the JAX package's
// `noise_removal_jax` scan) for sm_90a.
//
// mfspec [B, T, NF] float32 (contiguous): for every (utterance, filter)
// lane, walk the T frames and carry the smoothed power, the noise and
// signal floors and the temporal-masking peak; write the frame's gain
// into gains [B, T, NF].  Frames past an utterance's length flow through
// the recurrence too, as in the JAX scan.
//
// One thread per lane, one launch per batch: the lanes are independent and
// the frames sequential.  Threads of a warp take adjacent filters, so a
// frame's loads and stores are coalesced within an utterance.  A thread
// loads a group of U frames into registers while it steps the group
// before (the loads do not depend on the recurrence), so the memory
// latency hides behind the dependent arithmetic.
//
// Exactness: each operation is the plain torch loop's (`ops/denoise.py`),
// one float32 rounding per operation, in its order; the constants are the
// float32 values torch applies (each rounded from the Python double, the
// (1 - lambda) weights computed in double first), passed in by the
// wrapper.  Built with --fmad=false (no multiply-add contraction) and
// IEEE division, the result is bit-equal to the plain loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Consts {
  float lp, olp;      // LAMBDA_POWER, 1 - LAMBDA_POWER
  float la, ola;      // LAMBDA_A, 1 - LAMBDA_A
  float lb, olb;      // LAMBDA_B, 1 - LAMBDA_B
  float lt, mu;       // LAMBDA_T, MU_T
  float mg, inv_mg;   // MAX_GAIN, 1 / MAX_GAIN
  float tiny;         // the division guard 1e-30
};

constexpr int U = 8;          // frames per register group
constexpr int THREADS = 128;  // threads per block

__global__ void __launch_bounds__(THREADS)
denoise_kernel(const float* __restrict__ x, float* __restrict__ gains,
               int n_lanes, int T, int NF, Consts c) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n_lanes) return;
  const int b = lane / NF, f = lane - b * NF;
  const long long base = (long long)b * T * NF + f;
  const float* in = x + base;
  float* out = gains + base;

  const float x0 = in[0];
  float power = x0;
  float noise = x0 / c.mg;
  float floor_ = x0 / c.mg;
  float peak = 0.0f;

  float cur[U], nxt[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    cur[u] = u < T ? __ldg(in + (long long)u * NF) : 0.0f;
  for (int t0 = 0; t0 < T; t0 += U) {
    const int t1 = t0 + U;
#pragma unroll
    for (int u = 0; u < U; ++u)
      nxt[u] = t1 + u < T ? __ldg(in + (long long)(t1 + u) * NF) : 0.0f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u >= T) break;
      const float xv = cur[u];
      power = c.lp * power + c.olp * xv;
      noise = power >= noise ? c.la * noise + c.ola * power
                             : c.lb * noise + c.olb * power;
      float signal = power - noise;
      signal = signal < 1.0f ? 1.0f : signal;
      floor_ = signal >= floor_ ? c.la * floor_ + c.ola * signal
                                : c.lb * floor_ + c.olb * signal;
      const float cur_in = signal;
      peak = peak * c.lt;
      signal = signal < c.lt * peak ? peak * c.mu : signal;
      peak = cur_in > peak ? cur_in : peak;
      signal = signal < floor_ ? floor_ : signal;
      const float safe = power < c.tiny ? c.tiny : power;
      float gain = signal < c.mg * power ? signal / safe : c.mg;
      gain = gain < c.inv_mg ? c.inv_mg : gain;
      out[(long long)(t0 + u) * NF] = gain;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = nxt[u];
  }
}

}  // namespace

// One launch over the B * NF lanes of mfspec [B, T, NF].  `consts` holds
// the 11 float32 constants of `Consts` in order.  Returns
// cudaGetLastError() after the launch.
extern "C" int denoise_launch(const void* mfspec, void* gains, int B, int T,
                              int NF, const float* consts, void* stream) {
  const Consts c{consts[0], consts[1], consts[2], consts[3],
                 consts[4], consts[5], consts[6], consts[7],
                 consts[8], consts[9], consts[10]};
  const int n_lanes = B * NF;
  if (n_lanes == 0 || T == 0) return (int)cudaSuccess;
  const int blocks = (n_lanes + THREADS - 1) / THREADS;
  denoise_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)mfspec, (float*)gains, n_lanes, T, NF, c);
  return (int)cudaGetLastError();
}

extern "C" const char* denoise_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
