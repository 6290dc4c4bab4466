"""Where the encoder-decoder path's time goes in the PyTorch port, on one
CUDA card.

    python3 scripts/torch_encdec_profile.py

Traces with ``torch.profiler`` at the shapes of ``chip_smoke.py`` phase 14:
whisper-small at full width and depth, random bfloat16 weights from seed
0, seeded N(0, 1) frame embeddings.

* ``encdec.encode`` of B 8 x 4,096 frames, then ``api.prefill`` of the
  same frames with 448 decoder tokens (the decoder's share is the
  difference), each traced once after a warm-up;
* 5 lockstep ``api.decode`` steps of 8 sequences on the frames' cross K/V
  (``precompute_cross``), after 3 untraced ones.

For each it prints the wall time, the device time and launches per call,
the device's busy share of the traced window and the device time by
kernel name (``torch_moe_ssm_profile.traced``).  Imports nothing of JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from torch_moe_ssm_profile import card_line, traced

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

B, FRAMES = 8, 4096


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    from repro_torch.configs import registry
    from repro_torch.models import api, encdec

    cfg = registry.get("whisper-small")
    params = api.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(14)
    batch = api.batch_to({
        "frames": rng.standard_normal((B, FRAMES, cfg.d_model),
                                      dtype=np.float32),
        "dec_tokens": rng.integers(0, cfg.vocab_size, (B, cfg.decoder_len),
                                   dtype=np.int32)}, "cuda")
    with torch.no_grad():
        encdec.encode(params, batch["frames"], cfg)
        traced(f"{cfg.name}: encode B {B} x {FRAMES} frames", 1,
               lambda: encdec.encode(params, batch["frames"], cfg))
        api.prefill(params, batch, cfg, device="cuda")
        traced(f"{cfg.name}: prefill B {B} x {FRAMES} frames x "
               f"{cfg.decoder_len} tokens", 1,
               lambda: api.prefill(params, batch, cfg, device="cuda"))
        cache = api.init_cache(cfg, B, cfg.decoder_len)
        cache["cross_k"], cache["cross_v"] = encdec.precompute_cross(
            params, encdec.encode(params, batch["frames"], cfg), cfg)
        tok = batch["dec_tokens"][:, :1]
        for _ in range(3):
            api.decode(params, tok, cache, cfg)
        traced(f"{cfg.name}: lockstep decode step of {B} sequences over "
               f"{FRAMES} frames of cross K/V", 5,
               lambda: api.decode(params, tok, cache, cfg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
