"""The flash kernel's tensor-core route at heads of 80, and what its P.V
width buys, on one CUDA card.

    python3 scripts/torch_flash_variants.py

At h2o-danube-1.8b's attention shapes (bf16, 32 heads of 80, causal,
window 4,096): its prefill in ``chip_smoke.py`` phase 20 (B 2 x S 8,192)
and its training step (B 4 x S 4,096, where the window masks nothing),
it builds, side by side into ``build/dev/``, the kernel of
``csrc/flash_attention.cu`` and a variant derived from that source by
text substitution:

* ``kernel``: the source as it is (P.V by wgmma m64n80k16: O's 80
  columns only);
* ``padded``: P.V over the two 64-column halves, m64n128k16, whose
  columns past 80 multiply the zero-filled part of V (48/80 more P.V
  work, D 128's accumulators).

It prints what ptxas says of each wgmma instance (registers, spills,
C7512/C7513 serialisation warnings), holds each variant's output to the
plain version (bf16 3e-2, lse 1e-4) and elementwise to the kernel-order
plain version (``chip_smoke.tiled_gate``; the scalar route too, at its
own key tile, the same 64), and times, by CUDA events with
the L2 overwritten before each call, in turns (kernel, padded, padded,
kernel), beside the scalar route of the same library on the same
operands (``tensor_cores`` 0), SDPA with the boolean mask and the bound.
Exits non-zero if a variant fails a gate.  Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as fa, ops, ref)

DEV = ROOT / "build" / "dev"
# O's accumulators and the P.V product over padded<D>() columns, not D
PADDED_PV = [
    ("  float o[D / 2];\n#pragma unroll\n  for (int i = 0; i < D / 2; ++i)",
     "  float o[padded<D>() / 2];\n#pragma unroll\n"
     "  for (int i = 0; i < padded<D>() / 2; ++i)"),
    ("for (int j = 0; j < D / 8; ++j) {\n        o[4 * j] *= corr[0];",
     "for (int j = 0; j < padded<D>() / 8; ++j) {\n"
     "        o[4 * j] *= corr[0];"),
    ("void issue_pv(float (&o)[D / 2], const PFrag& pa,",
     "void issue_pv(float (&o)[padded<D>() / 2], const PFrag& pa,"),
    ("    wgmma_pv<D>(o, pa[kk], db);",
     "    wgmma_pv<padded<D>()>(o, pa[kk], db);"),
]
VARIANTS = {   # name: [(old, new), ...] applied to the kernel's source
    "kernel": [],
    "padded": PADDED_PV,
}
# (what, B, H, S, D, window)
SHAPES = (("danube's prefill", 2, 32, 8_192, 80, 4_096),
          ("danube's training step", 4, 32, 4_096, 80, 4_096))


def derive(name: str, source: str) -> Path:
    """The variant's source, written to build/dev/."""
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not once in "
                               f"the kernel's source")
        source = source.replace(old, new)
    path = DEV / f"flash_{name}.cu"
    path.write_text(source, encoding="utf-8")
    return path


def build(sources: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """One nvcc per source, all started together; prints ptxas's lines
    for the wgmma instances."""
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(DEV / f"flash_{name}.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, path in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        entry = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "wgmma" in entry and ("registers" in line or "spill" in line
                                       or "C751" in line):
                print(f"{name}: {entry}: {line.strip()}")
            elif "C751" in line:
                print(f"{name}: {line.strip()}")
        lib = ctypes.CDLL(str(DEV / f"flash_{name}.so"))
        lib.flash_attention_launch.argtypes = fa.ARGTYPES
        lib.flash_attention_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(lib, q, k, v, window: int, tensor_cores: int):
    b, h, s, d = q.shape
    y = torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)

    def launch():
        err = lib.flash_attention_launch(
            1, tensor_cores, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            y.data_ptr(), lse.data_ptr(), b * h, s, s, d, 1, window, 0,
            1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_launch: CUDA error {err}")
        return y, lse
    return launch


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    DEV.mkdir(parents=True, exist_ok=True)
    source = _build.SOURCES["flash_attention"].read_text(encoding="utf-8")
    libs = build({name: derive(name, source) for name in VARIANTS})
    card = cs.card_line()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    bad = []
    for what, b, h, s, d, window in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(29)
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        mask = dict(causal=True, window=window)
        want_y, want_lse = ref.attention_ref(q, k, v, **mask)
        runs = {name: launcher(lib, q, k, v, window, 1)
                for name, lib in libs.items()}
        runs["simt"] = launcher(libs["kernel"], q, k, v, window, 0)
        for name, run in runs.items():
            y, lse = run()
            torch.cuda.synchronize()
            err = (y.float() - want_y.float()).abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            ok = err <= cs.TOL[torch.bfloat16] and lse_err <= 1e-4
            try:
                gate = cs.tiled_gate(y, q, k, v, True, window, 0,
                                     f"{what} {name}")
            except AssertionError as e:
                ok, gate = False, f"; {e}"
            if not ok:
                bad.append(f"{what} {name}")
            print(f"{what} {name}: y max abs err {err:.3e}, lse "
                  f"{lse_err:.3e} {gate}", flush=True)
        del want_y, want_lse
        times = {name: [] for name in runs}
        for name in ("kernel", "padded", "padded", "kernel"):
            times[name].append(cs.time_ms(runs[name], flush, iters=20))
        times["simt"].append(cs.time_ms(runs["simt"], flush, iters=3))
        pos = torch.arange(s, device="cuda")
        keep = (pos[:, None] - pos[None, :] < window) \
            & (pos[:, None] >= pos[None, :])
        sdpa = cs.time_ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(
                              q, k, v, attn_mask=keep), flush, iters=10)
        flops = 4 * b * h * d * ops.kept_pairs(s, s, True, window, 0)
        bound = flops / cs.BF16_FLOPS_PER_S * 1e3
        print(f"{what} (B {b}, H {h}, S {s}, D {d}, causal, window "
              f"{window}): " + "; ".join(
                  f"{name} " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
                  for name, ts in times.items())
              + f"; SDPA (boolean mask) {sdpa:.4f} ms; bound {bound:.4f} "
              f"ms ({flops} flops at 989 TFLOP/s); kernel at "
              f"{bound / min(times['kernel']):.1%} of the bound; {card}",
              flush=True)
        del q, k, v, keep, runs
        torch.cuda.empty_cache()
    print(card)
    if bad:
        print(f"outside the gate: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
