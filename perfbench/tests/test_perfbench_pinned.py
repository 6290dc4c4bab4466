"""dbrx's weights, their cut into leaves, the reference's logits and the
roofline and MFU counts, pinned to the numbers that the harness gave
before the decoder's layout, leaf kinds and counts moved into
``perfbench/reference/decoder.py`` and its program code into
``perfbench/adapters/decoder.py``.  The pins were computed by that
earlier harness; a change here moves the benchmark.

The drawn buffers are pinned for a 2-layer arch of dbrx's kind at small
widths (the full widths draw 6.3 GB a layer): the seed, the part names,
the order of the cut and the leaf kinds are what the draw depends on, and
the full widths' cut is pinned by its layout.  The logits are pinned on
one thread, since the CPU's reductions split by thread count."""
from __future__ import annotations

import hashlib
import json

import pytest
import torch
from perfbench_tiny import MOE, ROOT, one_thread

from perfbench import manifest, weights
from perfbench.reference import decoder
from perfbench.roofline import counts

DBRX = json.loads((ROOT / "perfbench/configs/dbrx-132b-8l.json").read_text()
                  )["perfbench"]["arch"]
SMALL = dict(DBRX, n_layers=2, d_model=256, n_heads=2, n_kv_heads=1,
             d_head=128, d_ff=384, vocab_size=512)
SEED = 2**31 + 3636
D, V, F = 6144, 100352, 10752
LAYER = [("mixer_norm", (D,), "scale"), ("wq", (D, D), "w"),
         ("wk", (D, 1024), "w"), ("wv", (D, 1024), "w"),
         ("wo", (D, D), "w"), ("ffn_norm", (D,), "scale"),
         ("router", (D, 16), "w"), ("wi_gate", (16, D, F), "w"),
         ("wi_up", (16, D, F), "w"), ("wo_ffn", (16, F, D), "w")]
DRAWN = {"embed": "22f4402d5da4382145cca3bf0f0fd1e6",
         "head": "69a4f9df6f41ecebaacea9d9b4be74ea",
         "final_norm": "e69773fb93ad63fcd2ecf337f20f15ae",
         "layer0": "5006060b9be2112627128c97c343c393",
         "layer1": "fa148e5ff5d4d6c425565ddaddb0f9ca"}
LOGITS = {"f32": "3808ad6950bcabed79cb6241aff5033d",
          "fp8": "39ba3ec9f026ac6a501ee20ff1f39b5a"}


def digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for name, t in tensors.items():
        h.update(name.encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:32]


def test_dbrx_layout_is_the_parents():
    cell = manifest.cell(ROOT, "dbrx-132b-8l.chat")
    assert cell.ref.parts(DBRX) == ["embed", "head", "final_norm"] + [
        f"layer{i}" for i in range(8)]
    assert cell.ref.layout(DBRX, "embed") == [("embed", (V, D), "w")]
    assert cell.ref.layout(DBRX, "head") == [("head", (D, V), "w")]
    assert cell.ref.layout(DBRX, "final_norm") == [("scale", (D,), "scale")]
    for i in range(8):
        assert cell.ref.layout(DBRX, f"layer{i}") == LAYER


@pytest.mark.parametrize("part", sorted(DRAWN))
def test_dbrx_drawn_buffers_are_the_parents(part):
    assert decoder.parts(SMALL) == list(DRAWN)
    assert digest(weights.draw(decoder, SMALL, SEED, part, "cpu")) \
        == DRAWN[part]


@pytest.mark.parametrize("mode", sorted(LOGITS))
def test_reference_logits_are_the_parents(mode):
    seqs = [[(7 * i + 3) % MOE["vocab_size"] for i in range(n)]
            for n in (5, 19)]
    with one_thread():
        out = decoder.logits(
            MOE, lambda p: weights.draw(decoder, MOE, SEED, p, "cpu"), seqs,
            [list(range(len(s))) for s in seqs], modes=("f32", "fp8"))
    assert digest({str(i): t for i, t in enumerate(out[mode])}) \
        == LOGITS[mode]


def test_dbrx_counts_are_the_parents():
    rows = [100, 2000, 4096]
    assert decoder.active_params(DBRX) == 7047217152
    assert decoder.step_flops(DBRX, "decode", rows) == 47200862208
    assert decoder.step_flops(DBRX, "prefill", [], 256, 200) \
        == 2834138136576
    assert counts.paged_attention(DBRX, rows, 16,
                                  decoder.attention_layers(DBRX)) \
        == (1218183168, 203632864)
    assert counts.dispatch_combine(DBRX, 32, decoder.moe_layers(DBRX)) \
        == (12582912, 31467520)
