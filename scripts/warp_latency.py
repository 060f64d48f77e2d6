#!/usr/bin/env python3
"""Cycles a step of one warp's dependent chains on one NVIDIA GPU: the
latencies behind the LM kernels' warp steps (csrc/pose_graph_lm.cu,
csrc/imu_chain_lm.cu).

    python3 scripts/warp_latency.py

Builds a small kernel with nvcc (the kernels' flags: sm_90a, -O3,
-fmad=false) into build/, runs 4096 dependent steps of each chain on one
warp and prints clock64 cycles a step.  Imports no JAX.
"""

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAINS = [  # (name, one step of x)
    ("fmul + fadd", "x = x * 0.999f + 1e-3f;"),
    ("shfl + fadd",
     "x = __shfl_sync(0xffffffffu, x, (lane + 1) & 31) + 1e-7f;"),
    ("sqrtf + fadd", "x = sqrtf(x) + 1.0f;"),
    ("div + fadd", "x = y / x + 1.0f;"),
    ("div, half the lanes 0 / x, + fadd", "x = z / x + 1.0f;"),
    ("div guarded by a branch on x != 0 (half 0), + fadd",
     "{ float q = z; if (z != 0.0f) q = z / x; x = q + 1.0f; }"),
    ("STS, syncwarp, LDS, syncwarp, + fadd",
     "{ s[lane] = x; __syncwarp(); x = s[(lane + 1) & 31] + 1.0f;"
     " __syncwarp(); }"),
    ("fadd", "x = x + 1e-3f;"),
    ("3 shfl from one row, their sum",
     "{ const int b = 3 * ((lane & 31) / 3 % 9);"
     " x = (__shfl_sync(0xffffffffu, x, b) + __shfl_sync(0xffffffffu, x,"
     " b + 1)) + __shfl_sync(0xffffffffu, x, b + 2); }"),
    ("STS.128, syncwarp, 5 LDS.128, their sum",
     "{ s4[lane] = make_float4(x, x, x, 0.0f); __syncwarp();"
     " const float4 a = s4[(lane + 1) & 31], b = s4[(lane + 2) & 31],"
     " c = s4[(lane + 3) & 31], d = s4[(lane + 4) & 31],"
     " e = s4[(lane + 5) & 31];"
     " x = (((a.x + b.y) + c.z) + d.x) + e.y; __syncwarp(); }"),
    ("if / else if around a div",
     "{ const int j = i & 31; if (lane == j) x = x + 1.0f;"
     " else if (lane > j) x = y / x + 1.0f; }"),
]
SOURCE = """
#include <cuda_runtime.h>
template <int M>
__global__ void chain(float* out, long long* cyc, int n) {
  __shared__ float s[32];
  __shared__ float4 s4[32];
  const int lane = threadIdx.x & 31;
  float x = 1.5f + lane * 1e-3f, y = 1.25f + lane * 1e-3f;
  const float z = (lane & 1) ? 0.0f : y;
  s[lane] = x;
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
%s
  }
  const long long t1 = clock64();
  out[lane] = x;
  if (lane == 0) *cyc = (t1 - t0) / n;
}
extern "C" int run(int mode, float* out, long long* cyc, int n) {
  switch (mode) {
%s
  }
  return (int)cudaGetLastError();
}
"""


def main():
    if not torch.cuda.is_available():
        sys.exit("scripts/warp_latency.py needs a CUDA device")
    body = "\n".join(f"    if (M == {m}) {step}"
                     for m, (_, step) in enumerate(CHAINS))
    cases = "\n".join(f"    case {m}: chain<{m}><<<1, 32>>>(out, cyc, n); "
                      "break;" for m in range(len(CHAINS)))
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    src = os.path.join(build, "warp_latency.cu")
    so = os.path.join(build, "libwarp_latency.so")
    with open(src, "w") as f:
        f.write(SOURCE % (body, cases))
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-o",
                    so, src], check=True)
    lib = ctypes.CDLL(so)
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int]
    out = torch.zeros(32, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for m, (name, _) in enumerate(CHAINS):
        for _ in range(2):  # the second run is the one read
            if lib.run(m, out.data_ptr(), cyc.data_ptr(), 4096):
                raise RuntimeError(f"chain {m} failed to launch")
        torch.cuda.synchronize()
        print(f"warp latency {name}: {int(cyc)} cycles a step", flush=True)


if __name__ == "__main__":
    main()
