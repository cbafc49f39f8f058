"""Probe the H100's TF32 ``mma.sync.m16n8k8`` that the flash backward
kernels (``analytics_zoo_tpu_torch/csrc/flash_attention_bwd.cu``) are built
on: its throughput as the independent accumulators a warp keeps and the
warps an SM runs grow, the latency of a dependent chain, and how it sums
(the terms of one mma against its C operand).

    python3 mma_probe.py

Needs one CUDA card and ``nvcc``; builds a small library under
``build/analytics_zoo_tpu_torch/`` and prints one line per reading, each
time measured between CUDA events.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from analytics_zoo_tpu_torch.ops import _build

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// each warp keeps CHAINS independent accumulators and issues one mma into
// each per round
template <int CHAINS>
__global__ void rate(float* out, int rounds) {
  float c[CHAINS][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  const uint32_t b[2] = {threadIdx.x * 3u, 7u};
  for (int r = 0; r < rounds; ++r)
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) mma(c[i], a, b);
  float s = 0.f;
  for (int i = 0; i < CHAINS; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// D = A (16 x 8) · B (8 x 8) + C, row-major f32 in and out: one mma
__global__ void once(const float* A, const float* B, const float* C,
                     float* D) {
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  const uint32_t a[4] = {__float_as_uint(A[g * 8 + t]),
                         __float_as_uint(A[(g + 8) * 8 + t]),
                         __float_as_uint(A[g * 8 + t + 4]),
                         __float_as_uint(A[(g + 8) * 8 + t + 4])};
  const uint32_t b[2] = {__float_as_uint(B[t * 8 + g]),
                         __float_as_uint(B[(t + 4) * 8 + g])};
  float c[4] = {C[g * 8 + 2 * t], C[g * 8 + 2 * t + 1],
                C[(g + 8) * 8 + 2 * t], C[(g + 8) * 8 + 2 * t + 1]};
  mma(c, a, b);
  D[g * 8 + 2 * t] = c[0];
  D[g * 8 + 2 * t + 1] = c[1];
  D[(g + 8) * 8 + 2 * t] = c[2];
  D[(g + 8) * 8 + 2 * t + 1] = c[3];
}

extern "C" int run_rate(int chains, int blocks, int threads, int rounds,
                        float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (chains) {
    case 1: rate<1><<<blocks, threads, 0, s>>>(out, rounds); break;
    case 2: rate<2><<<blocks, threads, 0, s>>>(out, rounds); break;
    case 4: rate<4><<<blocks, threads, 0, s>>>(out, rounds); break;
    case 8: rate<8><<<blocks, threads, 0, s>>>(out, rounds); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int run_once(const float* A, const float* B, const float* C,
                        float* D, void* stream) {
  once<<<1, 32, 0, (cudaStream_t)stream>>>(A, B, C, D);
  return (int)cudaGetLastError();
}
"""

ROUNDS = 4096
FLOP = 2 * 16 * 8 * 8   # one m16n8k8


def build() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "mma_probe.cu"
    src.write_text(SOURCE)
    lib = _build.BUILD_DIR / "libmma_probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    so.run_rate.argtypes = [i32, i32, i32, i32, ptr, ptr]
    so.run_once.argtypes = [ptr] * 5
    return so


def rate(lib, sms: int, chains: int, warps: int) -> float:
    """TF32 TFLOP/s with ``warps`` warps on each SM, ``chains`` accumulators
    a warp."""
    out = torch.empty(sms * warps * 32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.run_rate(chains, sms, 32 * warps, 16, out.data_ptr(),
                        stream) == 0
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    assert lib.run_rate(chains, sms, 32 * warps, ROUNDS, out.data_ptr(),
                        stream) == 0
    t1.record()
    torch.cuda.synchronize()
    mmas = sms * warps * chains * ROUNDS
    return mmas * FLOP / (t0.elapsed_time(t1) * 1e-3) / 1e12, \
        t0.elapsed_time(t1) * 1e6 / ROUNDS


def once(lib, c: float, terms) -> float:
    """C + Σ terms (at most 8) as one mma, in element (0, 0)."""
    A = torch.zeros(16, 8)
    B = torch.zeros(8, 8)
    C = torch.zeros(16, 8)
    A[0, :len(terms)] = torch.tensor(terms, dtype=torch.float32)
    B[:, 0] = 1.0
    C[0, 0] = c
    A, B, C = (x.cuda() for x in (A, B, C))
    D = torch.empty(16, 8, device="cuda")
    assert lib.run_once(A.data_ptr(), B.data_ptr(), C.data_ptr(),
                        D.data_ptr(),
                        torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    return D[0, 0].item()


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for chains in (1, 2, 4, 8):
        for warps in (1, 4, 8, 16):
            tflops, ns = rate(lib, sms, chains, warps)
            print(f"rate: {chains} accumulators a warp, {warps} warps an SM: "
                  f"{tflops:.1f} TF32 TFLOP/s ({ns:.2f} ns a round)")
    ulp = 2.0 ** -23
    for e in (22, 23, 24, 25):
        print(f"sum: C = 1, one term 2^-{e}: 1 + "
              f"{(once(lib, 1.0, [2.0 ** -e]) - 1) / ulp:g} ulp")
    print(f"sum: C = 1, one term 1.5 ulp: 1 + "
          f"{(once(lib, 1.0, [1.5 * ulp]) - 1) / ulp:g} ulp")
    print(f"sum: C = 1, eight terms of 0.75 ulp: 1 + "
          f"{(once(lib, 1.0, [0.75 * ulp] * 8) - 1) / ulp:g} ulp")
    print(f"sum: C = 0, terms 1 and seven of 2^-24: 1 + "
          f"{(once(lib, 0.0, [1.0] + [2.0 ** -24] * 7) - 1) / ulp:g} ulp")
    print(f"sum: C = 1, one term -2^-30: 1 - "
          f"{(1 - once(lib, 1.0, [-(2.0 ** -30)])) / ulp:g} ulp")
    return 0


if __name__ == "__main__":
    sys.exit(main())
