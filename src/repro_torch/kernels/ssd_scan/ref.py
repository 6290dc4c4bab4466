"""Plain PyTorch SSD scans: the kernel's reference versions.

``ssd_ref`` is the twin of the JAX package's ``kernels/ssd_scan/ref.py``
(the per-token recurrence).  ``ssd_chunked_ref`` is the chunked matmul form
that both the TPU kernel and the reference model's ``ssm.ssd_chunked``
compute: the CPU path of :mod:`.ops` and of
:func:`repro_torch.models.ssm.ssd_chunked`, the latter's backward (under
autograd), and what ``chip_smoke.py`` holds the CUDA kernel to on the card.
"""
from __future__ import annotations

import torch

SUB_CHUNK = 64       # the CUDA kernel's sub-chunk rows (csrc/ssd_scan.cu kQ)


def ssd_ref(xh, dt, a_log, b_mat, c_mat, d_skip):
    """xh: [B,S,H,P]; dt: [B,S,H]; a_log, d_skip: [H]; b/c: [B,S,N].

    Returns (y [B,S,H,P], final state [B,H,P,N]), float32: the state
    advances one token at a time."""
    bsz, s, h, p = xh.shape
    n = b_mat.shape[-1]
    a = -torch.exp(a_log.float())
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                        device=xh.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)                          # [B,H]
        upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, t].float(),
                           xh[:, t].float(), b_mat[:, t].float())
        state = state * decay[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", state, c_mat[:, t].float())
        ys.append(y + d_skip.float()[None, :, None] * xh[:, t].float())
    return torch.stack(ys, dim=1), state


def ssd_chunked_ref(xh, dt, a_log, b_mat, c_mat, d_skip, *, chunk: int):
    """The SSD scan in chunked matmul form, float32 throughout; returns y
    [B,S,H,P] float32.  When ``chunk`` does not divide S the last chunk is
    shorter (the CUDA kernel's ragged last sub-chunk).

    Each chunk's intra-chunk decay exp(cum_i - cum_j) is taken of the
    difference masked to -inf above the diagonal, so it is 0 there without
    ever being inf (the difference is positive there and overflows exp in
    long chunks), in the forward and in an autograd backward through this
    function alike."""
    bsz, s, h, p = xh.shape
    q = min(chunk, s)
    xf, dtf = xh.float(), dt.float()
    bf, cf = b_mat.float(), c_mat.float()
    la = dtf * (-torch.exp(a_log.float()))                       # [B,S,H]
    above = ~torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=xh.device))
    state = torch.zeros((bsz, h, p, b_mat.shape[-1]), dtype=torch.float32,
                        device=xh.device)
    ys = []
    for c0 in range(0, s, q):
        sl = slice(c0, c0 + q)
        x_c, dt_c, b_c, c_c = xf[:, sl], dtf[:, sl], bf[:, sl], cf[:, sl]
        rows = x_c.shape[1]
        cum = torch.cumsum(la[:, sl], dim=1)                     # [B,Q,H]
        total = cum[:, -1, :]                                    # [B,H]
        seg = cum[:, :, None, :] - cum[:, None, :, :]            # [B,Qi,Qj,H]
        decay = torch.exp(seg.masked_fill(
            above[None, :rows, :rows, None], float("-inf")))
        scores = torch.einsum("bin,bjn->bij", c_c, b_c)
        att = scores[..., None] * decay
        xdt = x_c * dt_c[..., None]
        y_intra = torch.einsum("bijh,bjhp->bihp", att, xdt)
        y_inter = torch.einsum("bin,bhpn->bihp", c_c, state) \
            * torch.exp(cum)[..., None]
        w_in = torch.exp(total[:, None, :] - cum) * dt_c         # [B,Q,H]
        state = state * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bjn,bjh,bjhp->bhpn", b_c, w_in, x_c)
        ys.append(y_intra + y_inter
                  + d_skip.float()[None, None, :, None] * x_c)
    return torch.cat(ys, dim=1)
