"""The weights of a run, drawn from ``--seed`` on the device.

Each part of the model (the embedding, the head, the final norm, each
layer) is one bfloat16 buffer drawn N(0, 0.02) by a single ``normal_``
call from a generator seeded by (run seed, part name), and cut into the
part's tensors.  The program is handed views of these buffers; the plain
reference draws the same part again, one at a time, and computes with it
in float32.  So both sides read the same numbers and neither takes
anything the other made.

Norm scales are 1 + the drawn value and biases the drawn value, so that a
norm's scale or a QKV bias that a program ignored would show.  A
layer-norm bias is zero (dbrx's norms have none); so is every absent
leaf.
"""
from __future__ import annotations

import hashlib

import torch

STD = 0.02


def part_seed(seed: int, part: str) -> int:
    """A 63-bit generator seed for one part of one run's weights."""
    digest = hashlib.sha256(f"{int(seed)}:{part}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def parts(arch: dict) -> list:
    """Names of the model's parts, in the order the program holds them."""
    names = ["embed"]
    if not arch["tie_embeddings"]:
        names.append("head")
    names.append("final_norm")
    names += [f"layer{i}" for i in range(arch["n_layers"])]
    return names


def layout(arch: dict, part: str) -> list:
    """[(name, shape, kind)] of one part; kind is "w" (the drawn value),
    "scale" (1 + it, float32) or "bias" (it)."""
    d, v = arch["d_model"], arch["vocab_size"]
    if part == "embed":
        return [("embed", (v, d), "w")]
    if part == "head":
        return [("head", (d, v), "w")]
    if part == "final_norm":
        return [("scale", (d,), "scale")]
    hq, hkv, dh = arch["n_heads"], arch["n_kv_heads"], arch["d_head"]
    f = arch["d_ff"]
    out = [("mixer_norm", (d,), "scale"),
           ("wq", (d, hq * dh), "w"), ("wk", (d, hkv * dh), "w"),
           ("wv", (d, hkv * dh), "w"), ("wo", (hq * dh, d), "w")]
    if arch["qkv_bias"]:
        out += [("bq", (hq * dh,), "bias"), ("bk", (hkv * dh,), "bias"),
                ("bv", (hkv * dh,), "bias")]
    out.append(("ffn_norm", (d,), "scale"))
    e = arch["n_experts"]
    if e:
        out += [("router", (d, e), "w"), ("wi_gate", (e, d, f), "w"),
                ("wi_up", (e, d, f), "w"), ("wo_ffn", (e, f, d), "w")]
    else:
        out += [("wi_gate", (d, f), "w"), ("wi_up", (d, f), "w"),
                ("wo_ffn", (f, d), "w")]
    return out


def draw(arch: dict, seed: int, part: str, device) -> dict:
    """One part's tensors: "w" and "bias" leaves as bfloat16 views of the
    part's buffer, "scale" leaves as float32."""
    spec = layout(arch, part)
    total = sum(_numel(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(part_seed(seed, part))
    buf = torch.empty(total, dtype=torch.bfloat16, device=device)
    buf.normal_(0.0, STD, generator=gen)
    out, at = {}, 0
    for name, shape, kind in spec:
        n = _numel(shape)
        view = buf[at:at + n].view(shape)
        at += n
        out[name] = view.float() + 1.0 if kind == "scale" else view
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
