"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):

1. require a CUDA card; print its name and power limit; turn TF32 off;
2. build the hand-written kernels from ``src/repro_torch/kernels/*/csrc``;
3. hold each kernel against its plain PyTorch version on the card at the
   decode shapes of the main path, and time kernel, plain version and a
   library yardstick;
4. serve full-width qwen2-1.5b (random weights from a seed) through
   ``repro_torch.serve.ServeEngine``: 12 requests on 8 slots, checking
   completion, page accounting and that every decode step's attention went
   through the paged-attention kernel;
5. hold the kernel read path against the gather read path on one prompt,
   in bfloat16 (reported) and float32 (held to 5e-2).

The second-to-last line is a JSON object describing each kernel, the last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}   # f32: summation order
KERNEL_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
KERNEL_REPLACES = "src/repro/kernels/paged_attention/paged_attention.py:87"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, flush: torch.Tensor, iters: int = 50) -> float:
    """Median milliseconds of one call by CUDA events, with the L2 cache
    overwritten before each call (the decode path finds its pools cold:
    28 layers of pools and weights pass through L2 between two reads of one
    layer's pool)."""
    for _ in range(5):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_kernel(flush: torch.Tensor) -> dict:
    from repro_torch.kernels.paged_attention import paged_attention as kernel
    from repro_torch.kernels.paged_attention import ref

    b, h, d, page, pps = 8, 12, 128, 16, 32
    n_pages = 1 + b * pps
    lengths_list = [0, 1, 15, 16, 17, 255, 511, 512]
    gen = torch.Generator(device="cuda").manual_seed(1)
    table = (torch.randperm(n_pages - 1, generator=gen, device="cuda")[:b * pps]
             + 1).reshape(b, pps).to(torch.int32)
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for hkv in (2, h):
            q = torch.randn(b, h, d, generator=gen, device="cuda").to(dtype)
            kp = torch.randn(n_pages, page, hkv, d, generator=gen,
                             device="cuda").to(dtype)
            vp = torch.randn(n_pages, page, hkv, d, generator=gen,
                             device="cuda").to(dtype)
            args = (q, kp, vp, table, lengths)
            out = kernel.paged_attention(*args)
            torch.cuda.synchronize()
            plain = ref.paged_attention_ref(*args)
            err = (out.float() - plain.float()).abs().max().item()
            if not torch.isfinite(out.float()).all() or err > TOL[dtype]:
                raise AssertionError(f"paged_attention {dtype} Hkv={hkv}: max "
                                     f"abs err {err} > {TOL[dtype]}")
            if out[0].abs().max().item() != 0.0:
                raise AssertionError("paged_attention: zero-length row is "
                                     "not zero")
            # the library yardstick: SDPA over KV already gathered dense
            # (the gather is not timed); the port never calls SDPA
            kd = kp[table.long()].reshape(b, pps * page, hkv, d) \
                .transpose(1, 2).contiguous()
            vd = vp[table.long()].reshape(b, pps * page, hkv, d) \
                .transpose(1, 2).contiguous()
            mask = (torch.arange(pps * page, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    q4, kd, vd, attn_mask=mask, enable_gqa=hkv != h)

            ms = time_ms(lambda: kernel.paged_attention(*args), flush)
            warm_ms = time_ms(lambda: kernel.paged_attention(*args),
                              torch.empty(0, device="cuda"))
            plain_ms = time_ms(lambda: ref.paged_attention_ref(*args), flush)
            library_ms = time_ms(sdpa, flush)
            elt = q.element_size()
            tokens = sum(min(n, pps * page) for n in lengths_list)
            pages_read = sum(-(-min(n, pps * page) // page)
                             for n in lengths_list)
            n_bytes = (tokens * hkv * d * 2 * elt + 2 * q.numel() * elt
                       + 4 * b + 4 * pages_read)
            flops = 4 * h * d * tokens
            t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
            t_ops = flops / F32_FLOPS_PER_S * 1e3
            name = f"{str(dtype).split('.')[-1]} Hkv={hkv}"
            results[(dtype, hkv)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms)
            print(f"phase 3: paged_attention {name}: max_abs_err={err:.3e} "
                  f"(tol {TOL[dtype]}) ms={ms:.4f} (L2 cold; warm "
                  f"{warm_ms:.4f}) plain_ms={plain_ms:.4f} "
                  f"library_ms={library_ms:.4f} (SDPA on pre-gathered KV) "
                  f"bound_ms={max(t_bytes, t_ops):.6f} ({n_bytes} bytes, "
                  f"{flops} flops) "
                  f"{results[(dtype, hkv)]['bound_by']}-bound", flush=True)
    return results[(torch.bfloat16, 2)]     # the main path's shape and type


def summarize(xs) -> str:
    return (f"p50={np.percentile(xs, 50):.3f} p99={np.percentile(xs, 99):.3f}"
            if xs else "n/a")


def phase_serve(cfg, params) -> int:
    from repro_torch.kernels.paged_attention import paged_attention as kernel
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.scheduler import RequestState

    engine_kw = dict(slots=8, max_len=512, page_size=16, prefill_chunk=64,
                     attn_read="kernel")
    warm = ServeEngine(cfg, params, **engine_kw)       # cuBLAS / allocator
    warm.submit(list(range(1, 80)), max_new_tokens=4)
    warm.run()
    warm.assert_no_leaks()
    del warm

    rng = np.random.default_rng(0)
    prompt_lens = rng.integers(32, 385, size=12)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in prompt_lens]
    eng = ServeEngine(cfg, params, **engine_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.paged_attention.launches = 0
    t0 = time.monotonic()
    reqs = [eng.submit(p, max_new_tokens=32,
                       temperature=0.8 if i % 2 else 0.0, seed=i)
            for i, p in enumerate(prompts)]
    step_ms = {"decode": [], "prefill": []}
    while eng.sched.has_work():
        before = eng.metrics.decode_steps
        s0 = time.monotonic()
        if not eng.step():
            break
        torch.cuda.synchronize()
        kind = "decode" if eng.metrics.decode_steps > before else "prefill"
        step_ms[kind].append((time.monotonic() - s0) * 1e3)
    wall = time.monotonic() - t0
    launches = kernel.paged_attention.launches
    eng.assert_no_leaks()
    for r in reqs:
        if r.state is not RequestState.FINISHED or len(r.out_tokens) != 32:
            raise AssertionError(f"request {r.rid}: {r.state} with "
                                 f"{len(r.out_tokens)} tokens")
    decode_steps = eng.metrics.decode_steps
    if launches != decode_steps * cfg.n_layers or launches == 0:
        raise AssertionError(f"paged_attention launched {launches} times for "
                             f"{decode_steps} decode steps x {cfg.n_layers} "
                             f"layers")
    tokens = sum(len(r.out_tokens) for r in reqs)
    ttft = [r.metrics.ttft * 1e3 for r in reqs]
    print(f"phase 4: served {len(reqs)} requests (prompts "
          f"{int(prompt_lens.min())}-{int(prompt_lens.max())} tokens, "
          f"{int(prompt_lens.sum())} in all; 32 new tokens each; odd "
          f"requests at temperature 0.8) on 8 slots: {tokens} tokens in "
          f"{wall:.3f} s = {tokens / wall:.2f} tokens/s", flush=True)
    print(f"phase 4: TTFT ms {summarize(ttft)}; decode step ms mean "
          f"{statistics.mean(step_ms['decode']):.3f} over "
          f"{len(step_ms['decode'])}; prefill chunk ms mean "
          f"{statistics.mean(step_ms['prefill']):.3f} over "
          f"{len(step_ms['prefill'])}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"paged_attention launches {launches} = {decode_steps} decode "
          f"steps x {cfg.n_layers} layers; page leaks 0; engine "
          f"{json.dumps(eng.metrics.summary())}", flush=True)
    return launches


def read_paths(cfg, params, prompt) -> dict:
    """Greedy tokens and logits of one prompt under each attention read."""
    from repro_torch.serve import ServeEngine

    runs = {}
    for attn_read in ("kernel", "gather"):
        eng = ServeEngine(cfg, params, slots=8, max_len=512, page_size=16,
                          prefill_chunk=64, attn_read=attn_read,
                          capture_logits=True)
        r = eng.submit(prompt, max_new_tokens=8)
        eng.run()
        eng.assert_no_leaks()
        logits = np.stack(r.logits_log)
        if not (np.isfinite(logits).all()
                and logits.shape == (8, cfg.vocab_size)):
            raise AssertionError(f"{attn_read} read: logits shape "
                                 f"{logits.shape}, finite "
                                 f"{np.isfinite(logits).all()}")
        runs[attn_read] = (r.out_tokens, logits)
    (tk, lk), (tg, lg) = runs["kernel"], runs["gather"]
    # logits at position i come from identical inputs while the greedy
    # streams agree before i; past a split the two runs feed other tokens
    same = next((i for i, (a, b) in enumerate(zip(tk, tg)) if a != b),
                len(tk))
    n = min(same + 1, len(tk))
    return dict(err=float(np.abs(lk[:n] - lg[:n]).max()), positions=n,
                streams_equal=tk == tg, logit_std=float(lk.std()))


def phase_reads(cfg, params) -> None:
    """Kernel read vs gather read at full width.  The 5e-2 check is made in
    float32: in bfloat16 the two reads round differently (the kernel keeps
    P.V in float32, the gather path casts P to bfloat16 as the reference
    does) and the random-weight 28-layer model amplifies that to logit
    differences near 0.1, which the bfloat16 line reports without a bound."""
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                size=200).tolist()
    bf16 = read_paths(cfg, params, prompt)
    print(f"phase 5: bfloat16 kernel vs gather read, 200-token greedy "
          f"prompt: max abs logit diff {bf16['err']:.3e} over "
          f"{bf16['positions']} positions (logit std "
          f"{bf16['logit_std']:.3f}); streams equal {bf16['streams_equal']}",
          flush=True)
    f32_cfg = dataclasses.replace(cfg, dtype="float32")
    f32_params = api_init(f32_cfg)
    f32 = read_paths(f32_cfg, f32_params, prompt)
    del f32_params
    if f32["err"] > 5e-2 or not f32["streams_equal"]:
        raise AssertionError(f"float32 kernel vs gather logits differ by "
                             f"{f32['err']}; streams equal "
                             f"{f32['streams_equal']}")
    print(f"phase 5: float32 kernel vs gather read, same prompt and seed: "
          f"max abs logit diff {f32['err']:.3e} over {f32['positions']} "
          f"positions (tol 5e-2); streams equal {f32['streams_equal']}",
          flush=True)


def api_init(cfg):
    """Full-width random weights drawn on the card from seed 0."""
    from repro_torch.models import api

    return api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry
    from repro_torch.kernels import _build

    card = card_line()
    print(f"phase 1: card {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 1: matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.monotonic()
    report = _build.build()
    print(f"phase 2: built {sorted(report)} in {time.monotonic() - t0:.2f} s",
          flush=True)
    for name, log in report.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase 2: {name}: {line.strip()}")

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    kstats = phase_kernel(flush)
    del flush

    cfg = registry.get("qwen2-1.5b")
    t0 = time.monotonic()
    params = api_init(cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"phase 4: {cfg.name} at full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_head "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}): {n_params} random parameters drawn in "
          f"{time.monotonic() - t0:.2f} s", flush=True)
    launches = phase_serve(cfg, params)
    phase_reads(cfg, params)

    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "paged_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches, **kstats}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
