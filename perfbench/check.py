"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed and the program's state is freed, a sample of
the greedy requests that finished, drawn from the seed across the batch
slots that served them and holding the longest of them, goes to the
configuration's reference module (``perfbench.reference`` in its file):
it runs once over each prompt with the tokens that were served, and each
served token is read at the position that produced it.  The number
compared is the widest gap by which a served token's logit lies below
the reference's best at its position (``max_logit_gap``), their mean
(``mean_logit_gap``), or the largest of the judged requests' own mean
gaps (``max_request_mean_gap``), which a fault in one slot's stream
moves however many sound requests are judged beside it.  That number
reads alone only the requests with at least the limits file's
``min_request_tokens`` judged tokens (the shorter ones stay in the
mean), so that a short request's few near-ties are not read as a fault.
A cell's limits file names the numbers it compares.  A request sampled
at a temperature is not judged this way; the mix holds greedy requests
for this.

The control (``control=True``, read only by ``perfbench/calibrate.py``)
is the reference in float8: at the same positions the token that it puts
first is read by the same gap.
"""
from __future__ import annotations

import numpy as np
import torch

from . import weights


def sample(finished: list, seed: int, tokens: int, max_requests: int
           ) -> list:
    """Greedy finished requests (each with ``prompt``, ``out_tokens``,
    ``params`` and ``slot``, the batch slot that served its last token):
    the longest first, then others drawn from the seed one slot at a time,
    each round through every slot that served one in an order drawn from
    the seed, the longest's slot last, until ``tokens`` served tokens or
    ``max_requests`` requests.  So a fault that breaks some of the batch's
    rows is judged whichever rows it breaks."""
    greedy = [r for r in finished if r.params.temperature == 0.0
              and r.out_tokens]
    if not greedy:
        return []
    greedy.sort(key=lambda r: (len(r.prompt) + len(r.out_tokens), r.rid))
    out = [greedy.pop()]
    rng = np.random.default_rng([int(seed), 2])
    by_slot: dict = {}
    for i in rng.permutation(len(greedy)):
        by_slot.setdefault(greedy[i].slot, []).append(greedy[i])
    order = [list(by_slot)[i] for i in rng.permutation(len(by_slot))]
    order.sort(key=lambda s: s == out[0].slot)
    while any(by_slot[s] for s in order):
        for s in order:
            if (sum(len(r.out_tokens) for r in out) >= tokens
                    or len(out) >= max_requests):
                return out
            if by_slot[s]:
                out.append(by_slot[s].pop(0))
    return out


def served(reqs: list) -> tuple:
    """(sequences, positions, tokens): each request's prompt and served
    tokens but the last, the positions whose logits chose each served
    token, and those tokens."""
    seqs, rows, toks = [], [], []
    for r in reqs:
        seq = list(r.prompt) + list(r.out_tokens[:-1])
        p = len(r.prompt)
        seqs.append(seq)
        rows.append(list(range(p - 1, p - 1 + len(r.out_tokens))))
        toks.append(list(r.out_tokens))
    return seqs, rows, toks


def gaps(ref_logits: list, toks: list) -> list:
    """Each request's tokens' gaps below the reference's best at their
    positions."""
    out = []
    for lg, t in zip(ref_logits, toks):
        t = torch.as_tensor(t, device=lg.device).long()
        out.append((lg.max(-1).values - lg.gather(-1, t[:, None])[:, 0])
                   .cpu())
    return out


def numbers(per_request: list, prefix: str = "") -> dict:
    """The pooled numbers of each request's gaps, and per request its
    tokens and the sum of their gaps."""
    g = torch.cat([torch.zeros(0)] + per_request)
    inf = float("inf")
    return {f"{prefix}max_logit_gap": float(g.max()) if g.numel() else inf,
            f"{prefix}mean_logit_gap": float(g.mean()) if g.numel() else inf,
            f"{prefix}per_request": [[x.numel(), float(x.sum())]
                                     for x in per_request if x.numel()]}


def request_mean_max(per_request: list, min_tokens: int) -> float:
    """The largest mean gap of a judged request of ``min_tokens`` tokens
    or more ([tokens, sum of gaps] each); where none is that long, the
    mean of all of them."""
    groups = [(n, s) for n, s in per_request if n >= min_tokens]
    if not groups and per_request:
        groups = [(sum(n for n, _ in per_request),
                   sum(s for _, s in per_request))]
    return max(s / n for n, s in groups) if groups else float("inf")


def judge(ref, arch: dict, seed: int, reqs: list, device,
          control: bool = False) -> dict:
    """The readings of one run by the reference module ``ref``:
    :func:`numbers` of the served tokens of ``reqs``, the tokens and
    requests judged, the reference's largest |Q|, |K|, |V| (against the
    model's clamp, if it has one), and with ``control`` the same numbers
    of the float8 reference's first tokens at the same positions."""
    seqs, rows, toks = served(reqs)
    modes = ("f32", "fp8") if control else ("f32",)
    out = ref.logits(arch, lambda p: weights.draw(ref, arch, seed, p, device),
                     seqs, rows, modes=modes, device=device)
    g = gaps(out["f32"], toks)
    res = {**numbers(g), "tokens": sum(x.numel() for x in g),
           "requests": len(reqs),
           "qkv_absmax": out["stats"].get("qkv_absmax", 0.0)}
    if control:
        first = [lg.argmax(-1).tolist() for lg in out["fp8"]]
        c = gaps(out["f32"], first)
        res.update(numbers(c, "control_"))
    return res


def control_readings(readings: dict) -> dict:
    """The control's readings under the program's names, for
    :func:`verdict`."""
    return {k[len("control_"):]: v for k, v in readings.items()
            if k.startswith("control_")} | {"tokens": readings["tokens"]}


COMPARED = ("max_logit_gap", "mean_logit_gap", "max_request_mean_gap")


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, the numbers compared each beside its limit).  The cell's
    limits file names the numbers it compares (each at most its limit)
    and the fewest served tokens a run must judge."""
    checks, ok = {}, True
    for name in COMPARED:
        if name in limits:
            lim = limits[name]["limit"]
            value = (request_mean_max(readings["per_request"],
                                      limits[name].get("min_request_tokens",
                                                       1))
                     if name == "max_request_mean_gap" else readings[name])
            checks[name] = {"value": value, "limit": lim}
            ok = ok and value <= lim
    checks["tokens_judged"] = {"value": readings["tokens"],
                               "limit": limits["min_tokens"]}
    ok = ok and len(checks) > 1 and readings["tokens"] >= limits["min_tokens"]
    return ok, checks
