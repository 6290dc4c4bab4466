"""The plain reference against the port on the CPU at small sizes, and
the float8 control against the reference."""
from __future__ import annotations

import dataclasses

import pytest
import torch
from perfbench_tiny import DENSE, MOE

from perfbench import weights
from perfbench.adapters import decoder as adapter
from perfbench.reference import decoder
from repro_torch.models import lm as port_lm

SEED = 2**31 + 4242


def draw(arch, part):
    return weights.draw(decoder, arch, SEED, part, "cpu")


def port_logits(arch, seqs):
    """The port's own forward in float32 on the benchmark's weights: the
    last position's logits of each sequence."""
    cfg = dataclasses.replace(adapter.model_config(arch, "t"),
                              dtype="float32")
    model = adapter.build_lm(cfg, arch, SEED, "cpu", decoder).float()
    out = []
    for s in seqs:
        tokens = torch.tensor([s])
        out.append(port_lm.prefill_logits(model, {"tokens": tokens}, cfg)[0])
    return out


@pytest.mark.parametrize("arch,tol", [(DENSE, 1e-5), (MOE, 2e-3)],
                         ids=["dense", "moe"])
def test_reference_matches_the_port_in_float32(arch, tol):
    """Float32 on both sides; the port's MoE rounds its expert inputs and
    combine weights to bfloat16 in a float32 model too (about 2^-9 of a
    logit's scale), hence the MoE's wider tolerance."""
    torch.manual_seed(0)
    seqs = [torch.randint(0, arch["vocab_size"], (n,)).tolist()
            for n in (5, 17, 33)]
    ref = decoder.logits(arch, lambda p: draw(arch, p), seqs,
                         [[len(s) - 1] for s in seqs])
    for r, p in zip(ref["f32"], port_logits(arch, seqs)):
        scale = r.abs().max()
        assert (r[0] - p).abs().max() <= tol * scale


def test_reference_reads_every_position_and_clamps():
    arch = dict(MOE, clip_qkv=1e-3)
    seqs = [list(range(1, 12))]
    lo = decoder.logits(arch, lambda p: draw(arch, p), seqs,
                        [list(range(11))])
    hi = decoder.logits(MOE, lambda p: draw(MOE, p), seqs, [list(range(11))])
    assert lo["f32"][0].shape == (11, MOE["vocab_size"])
    # the largest |Q|, |K|, |V| is read before the clamp
    assert min(lo["stats"]["qkv_absmax"], hi["stats"]["qkv_absmax"]) > 1e-3
    assert not torch.allclose(lo["f32"][0], hi["f32"][0])


def test_control_rounds_to_float8():
    x = torch.randn(8, 64)
    w = torch.randn(64, 32)
    exact = x @ w
    low = decoder.matmul(x, w, "fp8")
    err = ((low - exact).norm() / exact.norm()).item()
    assert 0.01 < err < 0.1           # e4m3: 3 mantissa bits
    assert torch.equal(decoder.matmul(x, w, "f32"), exact)


def test_weights_are_the_seeds_and_drawn_per_part():
    a = draw(DENSE, "layer1")
    b = draw(DENSE, "layer1")
    c = weights.draw(decoder, DENSE, SEED + 1, "layer1", "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert a["wq"].dtype == torch.bfloat16
    assert a["mixer_norm"].dtype == torch.float32
    assert decoder.parts(DENSE) == ["embed", "final_norm"] + [
        f"layer{i}" for i in range(DENSE["n_layers"])]
    assert decoder.parts(MOE)[1] == "head"
