"""Plain PyTorch reference of the benchmark's decoder models.

A pre-norm decoder as the configurations' sources publish it: RMS norm
(qwen2) or layer norm without bias (dbrx), rotary embeddings on the
half-split pairs with the configuration's theta, grouped-query attention
(query head h reads KV head h // (Hq / Hkv)), QKV biases where the model
has them, dbrx's clamp of Q, K and V to +-clip_qkv, a SwiGLU FFN, or a
dropless mixture of experts (float32 softmax over every expert, the
top-k renormalised to sum 1, each token through each of its k experts),
the final norm and the head (the embedding's transpose when tied).

Everything runs in float32 with TF32 off, one sequence and one layer at
a time, from weights that :mod:`perfbench.weights` draws again part by
part, so a model far larger than the card in float32 fits.  It imports
nothing of the program.

``mode="fp8"`` is the comparison's control: every product of an
activation with a weight rounds both to float8 e4m3 first, per token and
per output channel scaled to the format's largest value, as a program
that served in fp8 would.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

E4M3_MAX = 448.0
Q_BLOCK = 1024                # query rows a block of the attention


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to float8 e4m3, scaled per slice along ``dim``."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def matmul(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """x [..., K] @ w [K, N] (or a batch of them)."""
    if mode == "fp8":
        return _q8(x, -1) @ _q8(w, -2)
    return x @ w


def norm(x: torch.Tensor, scale: torch.Tensor, arch: dict) -> torch.Tensor:
    eps = float(arch["norm_eps"])
    if arch["norm"] == "layer":
        x = (x - x.mean(-1, keepdim=True)) * torch.rsqrt(
            x.var(-1, keepdim=True, unbiased=False) + eps)
    else:
        x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return x * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [H, S, D], positions 0..S-1."""
    d = x.shape[-1]
    half = d // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = torch.arange(x.shape[1], dtype=torch.float32,
                       device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(x: torch.Tensor, w: dict, arch: dict, mode: str,
              stats: dict) -> torch.Tensor:
    """Causal GQA self-attention of one sequence x [S, D]."""
    s = x.shape[0]
    hq, hkv, dh = arch["n_heads"], arch["n_kv_heads"], arch["d_head"]
    q, k, v = (matmul(x, w[n], mode) for n in ("wq", "wk", "wv"))
    if "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    stats["qkv_absmax"] = max(stats.get("qkv_absmax", 0.0), float(max(
        t.abs().max() for t in (q, k, v))))
    clip = arch.get("clip_qkv")
    if clip:
        q, k, v = (t.clamp(-clip, clip) for t in (q, k, v))
    q = rope(q.view(s, hq, dh).transpose(0, 1), float(arch["rope_theta"]))
    k = rope(k.view(s, hkv, dh).transpose(0, 1), float(arch["rope_theta"]))
    v = v.view(s, hkv, dh).transpose(0, 1)
    rep = hq // hkv
    k = k.repeat_interleave(rep, dim=0)
    v = v.repeat_interleave(rep, dim=0)
    out = torch.empty_like(q)
    keys = torch.arange(s, device=x.device)
    for lo in range(0, s, Q_BLOCK):
        hi = min(s, lo + Q_BLOCK)
        sc = q[:, lo:hi] @ k.transpose(1, 2) / math.sqrt(dh)
        mask = keys[None, :] > torch.arange(lo, hi, device=x.device)[:, None]
        sc = sc.masked_fill(mask, -math.inf)
        out[:, lo:hi] = torch.softmax(sc, dim=-1) @ v
    y = out.transpose(0, 1).reshape(s, hq * dh)
    return matmul(y, w["wo"], mode)


def ffn(x: torch.Tensor, w: dict, arch: dict, mode: str) -> torch.Tensor:
    """SwiGLU FFN, or the dropless mixture of experts, of x [S, D]."""
    if not arch["n_experts"]:
        h = torch.nn.functional.silu(matmul(x, w["wi_gate"], mode)) \
            * matmul(x, w["wi_up"], mode)
        return matmul(h, w["wo_ffn"], mode)
    probs = torch.softmax(matmul(x, w["router"], mode), dim=-1)
    top_w, top_i = torch.topk(probs, arch["top_k"], dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(arch["n_experts"]):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = torch.nn.functional.silu(matmul(xe, w["wi_gate"][e], mode)) \
            * matmul(xe, w["wi_up"][e], mode)
        y.index_add_(0, rows, top_w[rows, slot][:, None]
                     * matmul(h, w["wo_ffn"][e], mode))
    return y


def logits(arch: dict, part: Callable[[str], dict], seqs: list,
           rows: list, modes=("f32",), device=None) -> dict:
    """Logits [len(rows[i]), V] of each sequence ``seqs[i]`` (token ids)
    at its positions ``rows[i]``, for each mode, in float32.  ``part(name)``
    gives a part's weights (any dtype; taken to float32 here).  Returns
    ``{mode: [tensor, ...], "stats": {...}}``."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _logits(arch, part, seqs, rows, modes, device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _f32(w: dict) -> dict:
    return {k: v.float() for k, v in w.items()}


def _logits(arch, part, seqs, rows, modes, device) -> dict:
    stats: dict = {}
    embed = part("embed")["embed"]
    xs = {m: [embed[torch.as_tensor(s, device=embed.device)].float()
              for s in seqs] for m in modes}
    del embed
    for i in range(arch["n_layers"]):
        w = _f32(part(f"layer{i}"))
        for m in modes:
            for j, x in enumerate(xs[m]):
                x = x + attention(norm(x, w["mixer_norm"], arch), w, arch, m,
                                  stats)
                xs[m][j] = x + ffn(norm(x, w["ffn_norm"], arch), w, arch, m)
        del w
    scale = part("final_norm")["scale"].float()
    if arch["tie_embeddings"]:
        head = part("embed")["embed"].float().T
    else:
        head = part("head")["head"].float()
    out = {"stats": stats}
    for m in modes:
        out[m] = [matmul(norm(x[torch.as_tensor(r, device=x.device)], scale,
                              arch), head, m)
                  for x, r in zip(xs[m], rows)]
    return out
