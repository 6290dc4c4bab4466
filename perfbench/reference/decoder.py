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

A configuration file names its reference module (``perfbench.reference``)
and the harness finds it by path.  Besides :func:`logits`, the module
gives the weights' parts, each part's :func:`layout` and each leaf kind's
value (:func:`leaf`), which :func:`perfbench.weights.draw` reads, and the
counts the per-layer readers take: :func:`active_params`,
:func:`step_flops`, :func:`attention_layers` and :func:`moe_layers`.  A
family that extends this one imports it and passes its own layer to
:func:`forward`.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

E4M3_MAX = 448.0
Q_BLOCK = 1024                # query rows a block of the attention


# -- the weights --------------------------------------------------------------

def parts(arch: dict) -> list:
    """Names of the model's parts, in the order the program holds them."""
    names = ["embed"]
    if not arch["tie_embeddings"]:
        names.append("head")
    names.append("final_norm")
    names += [f"layer{i}" for i in range(arch["n_layers"])]
    return names


def layout(arch: dict, part: str) -> list:
    """[(name, shape, kind)] of one part, in the order its buffer is cut;
    ``kind`` is one of :func:`leaf`'s."""
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


def leaf(kind: str, drawn: torch.Tensor) -> torch.Tensor:
    """A leaf from its drawn bfloat16 view: "w" and "bias" are the drawn
    value, "scale" is 1 + it in float32, so that a norm's scale or a QKV
    bias that a program ignored would show.  A layer-norm bias is zero
    (dbrx's norms have none); so is every absent leaf."""
    return drawn.float() + 1.0 if kind == "scale" else drawn


# -- the forward pass ---------------------------------------------------------

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


def block(x: torch.Tensor, w: dict, arch: dict, mode: str,
          stats: dict) -> torch.Tensor:
    """One decoder layer of one sequence x [S, D]."""
    x = x + attention(norm(x, w["mixer_norm"], arch), w, arch, mode, stats)
    return x + ffn(norm(x, w["ffn_norm"], arch), w, arch, mode)


def logits(arch: dict, part: Callable[[str], dict], seqs: list,
           rows: list, modes=("f32",), device=None) -> dict:
    """Logits [len(rows[i]), V] of each sequence ``seqs[i]`` (token ids)
    at its positions ``rows[i]``, for each mode, in float32.  ``part(name)``
    gives a part's weights (any dtype; taken to float32 here).  Returns
    ``{mode: [tensor, ...], "stats": {...}}``."""
    return forward(arch, part, seqs, rows, modes, block)


def forward(arch: dict, part: Callable[[str], dict], seqs: list,
            rows: list, modes, layer: Callable) -> dict:
    """:func:`logits` with ``layer(x, w, arch, mode, stats)`` as every
    layer's function (``w`` the layer's part in float32)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _forward(arch, part, seqs, rows, modes, layer)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _f32(w: dict) -> dict:
    return {k: v.float() for k, v in w.items()}


def _forward(arch, part, seqs, rows, modes, layer) -> dict:
    stats: dict = {}
    embed = part("embed")["embed"]
    xs = {m: [embed[torch.as_tensor(s, device=embed.device)].float()
              for s in seqs] for m in modes}
    del embed
    for i in range(arch["n_layers"]):
        w = _f32(part(f"layer{i}"))
        for m in modes:
            for j, x in enumerate(xs[m]):
                xs[m][j] = layer(x, w, arch, m, stats)
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


# -- the counts the readers take ----------------------------------------------

def attention_layers(arch: dict) -> int:
    """Layers that read the paged KV cache: every one."""
    return arch["n_layers"]


def moe_layers(arch: dict) -> int:
    """Layers that route tokens to experts: every one of a MoE."""
    return arch["n_layers"] if arch["n_experts"] else 0


def active_params(arch: dict) -> int:
    """Parameters one token multiplies with in the layers (no embedding,
    no head): attention, and the FFN or the router and top-k experts."""
    d, f = arch["d_model"], arch["d_ff"]
    hq, hkv, dh = arch["n_heads"], arch["n_kv_heads"], arch["d_head"]
    attn = d * hq * dh * 2 + d * hkv * dh * 2
    if arch["n_experts"]:
        ffn = d * arch["n_experts"] + arch["top_k"] * 3 * d * f
    else:
        ffn = 3 * d * f
    return arch["n_layers"] * (attn + ffn)


def step_flops(arch: dict, kind: str, rows: list, start: int = 0,
               n_valid: int = 0) -> float:
    """Model FLOPs of a decode step (``rows``: attended lengths of its
    active slots) or of a prefill chunk (positions start .. start+n-1):
    2 x active parameters a token, attention's two products over the
    positions each token attends, and the head for each token whose
    logits the step needs (every decode row; a chunk's last position)."""
    params = active_params(arch)
    per_pos = 4 * attention_layers(arch) * arch["n_heads"] * arch["d_head"]
    head = 2 * arch["d_model"] * arch["vocab_size"]
    if kind == "decode":
        return sum(2 * params + head + per_pos * n for n in rows)
    n = n_valid
    attended = n * start + n * (n + 1) // 2
    return n * 2 * params + per_pos * attended + (head if n else 0)
