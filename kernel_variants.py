#!/usr/bin/env python3
"""Where the time of the w8a8, w4a16 and paged-decode kernels goes, on the
card.

Builds text variants of ``analytics_zoo_tpu_torch/csrc/quant_matmul.cu``
with one part of the ``w8a8`` and ``w4a16`` kernels cut out, and times
each kernel of each at the predict head ((8, 768, 50257); w4a16 with
G = 12) with ``chip_smoke.py``'s timing (CUDA-graph replay, input sets of
more than 100 MB in turn):

- ``as built``: the kernel;
- ``ring only``: no products (the weight ring, and w4a16's scale ring, x,
  the loop);
- ``products only``: no weight or scale copies (x, the loop, the
  products on stale shared memory);
- ``skeleton``: neither (x, the chunk loop and its barriers, the stores).

Then times the paged kernel at the long-cache shape with its rule's
partition count and with others forced.  A variant's output is wrong by
construction; only the kernel as built is held to the plain version.
Run from the repository root on a machine with the card and ``nvcc``::

    python3 kernel_variants.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs
from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import paged_attention as pa
from analytics_zoo_tpu_torch.ops import quant_matmul as qm

COMPUTE = [("    compute(c, ci % kW4Stages, seg * KSEG);", ""),
           ("    compute(c % kW8Stages, k0 - seg * kW8XSeg);", "")]
STAGE = [("      stage(nc, (ci + kW4Stages - 1) % kW4Stages);", ""),
         ("      stage(c, st);", ""),
         ("      stage(c + kW8Stages - 1, (c + kW8Stages - 1) % kW8Stages);",
          ""),
         ("    if (s < nchunks) stage(s, s);", "")]
VARIANTS = {"as built": [], "ring only": COMPUTE, "products only": STAGE,
            "skeleton": COMPUTE + STAGE}


# the variants' sources and libraries, beside the kernels' build
OUT = _build.BUILD_DIR.parent / "kernel_variants"


def build_variant(name: str, cuts) -> ctypes.CDLL:
    text = (_build.CSRC / f"{qm.KERNEL}.cu").read_text()
    for old, new in cuts:
        if old not in text:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    src = OUT / f"{name.replace(' ', '_')}.cu"
    src.write_text(text)
    lib = src.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def w4_call(lib, bf16: bool):
    fn = getattr(lib, "w4a16_matmul_bf16" if bf16 else "w4a16_matmul_f32")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x, wq, sg):
        out = torch.empty(x.shape[0], wq.shape[1], device="cuda")
        err = fn(x.data_ptr(), wq.data_ptr(), sg.data_ptr(), out.data_ptr(),
                 x.shape[0], wq.shape[1], x.shape[1], sg.shape[0],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return call


def w8_call(lib):
    fn = lib.w8a8_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x, w, s):
        out = torch.empty(x.shape[0], w.shape[1], device="cuda")
        err = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
                 x.shape[0], w.shape[1], x.shape[1],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return call


def w8_sets(seed: int):
    """The head's x and weight, then weights and scales drawn on the card:
    more than 100 MB in all, as chip_smoke.w8a8_timing."""
    x, w, s = cs.w8a8_case(np.random.default_rng(seed), 8, 768, 50257)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = cs.n_sets(cs.w8a8_bound(8, 768, 50257)["bytes"])
    return [(x, w, s)] + [
        (x, torch.randint(-128, 128, w.shape, generator=gen, device="cuda",
                          dtype=torch.int8),
         torch.rand(s.shape, generator=gen, device="cuda") * 1e-2 + 1e-4)
        for _ in range(n - 1)]


def w4_sets(seed: int, dtype):
    """The quantized head, then packed weights and scales drawn on the
    card: more than 100 MB in all, as chip_smoke.w4a16_timing."""
    x, wq, sg = cs.w4a16_case(np.random.default_rng(seed), 8, 768, 50257,
                              64, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = cs.n_sets(cs.w4a16_bound(8, 768, 50257, 12)["bytes"])
    return [(x, wq, sg)] + [
        (x, torch.randint(0, 256, wq.shape, generator=gen, device="cuda",
                          dtype=torch.uint8),
         torch.rand(sg.shape, generator=gen, device="cuda") * 0.01 + 1e-3)
        for _ in range(n - 1)]


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(lambda kv: build_variant(*kv),
                                         VARIANTS.items())))
    sets = w8_sets(0)
    ref = qm.w8a8_matmul(*sets[0], impl="torch")
    for variant, lib in libs.items():
        call = w8_call(lib)
        if variant == "as built":
            cs.check(torch.equal(call(*sets[0]), ref),
                     "w8a8: not bitwise equal to the plain version")
        ms = [cs.cuda_ms(cs.cycled([lambda c=c: call(*c) for c in sets]))
              for _ in range(2)]
        print(f"w8a8 {variant}: {ms[0]:.4f} {ms[1]:.4f} ms", flush=True)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        sets = w4_sets(0, dtype)
        ref = qm.w4a16_matmul(*sets[0], impl="torch")
        for variant, lib in libs.items():
            call = w4_call(lib, dtype == torch.bfloat16)
            if variant == "as built":
                cs.check_close(f"w4a16[{name}]", call(*sets[0]), ref,
                               *cs.W4_TOL)
            ms = [cs.cuda_ms(cs.cycled([lambda c=c: call(*c) for c in sets]))
                  for _ in range(2)]
            print(f"w4a16[{name} x] {variant}: {ms[0]:.4f} {ms[1]:.4f} ms",
                  flush=True)
    lens, n_table = cs.paged_timing_lengths(0)["long"]
    for variant in ("f32", "int8"):
        sets = cs.paged_sets(100, lens, n_table, variant == "int8")
        rule = pa.partitions(n_table, None, 96, pa._sm_count(0))[0]
        for parts in (1, 2, 4, 8):
            ms = cs.cuda_ms(cs.cycled([lambda c=c: cs.run_paged(c, "cuda",
                                                                parts)
                                       for c in sets]))
            print(f"paged[{variant}/long] {parts} partition(s)"
                  f"{' (the rule)' if parts == rule else ''}: {ms:.4f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
