"""The weights of a run, drawn from ``--seed`` on the device.

Each part of the model (for a decoder: the embedding, the head, the final
norm, each layer) is one bfloat16 buffer drawn N(0, 0.02) by a single
``normal_`` call from a generator seeded by (run seed, part name), and
cut into the part's leaves.  The parts, their leaves and what each leaf
kind makes of its drawn value are the configuration's reference module's
(``parts``, ``layout``, ``leaf``; :mod:`perfbench.reference.decoder`), so
a new family draws its own leaves here unchanged.  The program is handed
views of these buffers; the plain reference draws the same part again,
one at a time, and computes with it in float32.  So both sides read the
same numbers and neither takes anything the other made.
"""
from __future__ import annotations

import hashlib

import torch

STD = 0.02


def part_seed(seed: int, part: str) -> int:
    """A 63-bit generator seed for one part of one run's weights."""
    digest = hashlib.sha256(f"{int(seed)}:{part}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def draw(ref, arch: dict, seed: int, part: str, device) -> dict:
    """One part's leaves: views of the part's bfloat16 buffer, each made a
    leaf by ``ref.leaf(kind, view)``."""
    spec = ref.layout(arch, part)
    total = sum(_numel(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(part_seed(seed, part))
    buf = torch.empty(total, dtype=torch.bfloat16, device=device)
    buf.normal_(0.0, STD, generator=gen)
    out, at = {}, 0
    for name, shape, kind in spec:
        n = _numel(shape)
        out[name] = ref.leaf(kind, buf[at:at + n].view(shape))
        at += n
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
