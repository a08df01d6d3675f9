"""What float32 FFMA code reaches on the card: a yardstick for ``conv_k2``'s
FFMA GEMM (``kernels/csrc/conv_k2.cu``, namespace gemm).

    python -m anytime3d_tpu_torch.cli.probe_ffma

Builds ``kernels/csrc/ffma_probe.cu`` and prints, each with the card's name
and power limit: the rate of the GEMM's inner loop alone (the thread's outer
products from registers; with the kernel's shared-memory reads and barrier; 8
and 16 rows a thread), and the time of cuBLAS's true-float32 GEMM at the sizes
of the four flagship stages at a batch of 8 (dense, no gather). Needs a CUDA
card and ``nvcc``. The port calls none of this.
"""

from __future__ import annotations

import ctypes
import subprocess


def main() -> None:
    import torch

    from anytime3d_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("probe_ffma: needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    lib = build.load("ffma_probe")
    lib.ffma_probe.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    lib.ffma_probe.restype = ctypes.c_int
    scratch = torch.zeros(1 << 20, device="cuda")
    torch.cuda.synchronize()
    ms, flop = ctypes.c_float(), ctypes.c_double()
    for tm in (8, 16):
        for with_lds in (0, 1):
            rc = lib.ffma_probe(tm, with_lds, 2000, scratch.data_ptr(), ctypes.addressof(ms), ctypes.addressof(flop))
            if rc:
                raise RuntimeError(f"ffma_probe failed: cudaError {rc}")
            print(f"inner loop, {tm} x 8 outputs a thread, operands from "
                  f"{'shared memory, one barrier a stage' if with_lds else 'registers'}: {ms.value:.3f} ms, "
                  f"{flop.value / ms.value / 1e9:.2f} TFLOP/s [{card}]", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    total = 0.0
    for C, N in ((64, 512), (512, 128), (128, 512), (512, 64)):
        a, b = torch.randn(8 * 16**3, 8 * C, device="cuda"), torch.randn(8 * C, N, device="cuda")
        for _ in range(3):
            a @ b
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            a @ b
        end.record()
        end.synchronize()
        t = start.elapsed_time(end) / 20
        total += t
        print(f"cuBLAS float32 [{a.shape[0]}, {a.shape[1]}] x [{a.shape[1]}, {N}]: {t:.4f} ms, "
              f"{2 * a.shape[0] * a.shape[1] * N / t / 1e9:.2f} TFLOP/s [{card}]", flush=True)
    print(f"cuBLAS float32, the four sizes: {total:.4f} ms [{card}]", flush=True)


if __name__ == "__main__":
    main()
