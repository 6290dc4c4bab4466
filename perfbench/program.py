"""The system under test: ``repro_torch``'s ServeEngine on the benchmark's
weights.

With the configurations' adapters (``perfbench/adapters/<name>.py``),
this is the only module of the harness that imports the program.  A
cell's adapter builds the program's model on the weights drawn from the
seed; :func:`start` starts the engine on it with the traffic file's
geometry, reading decode attention through the paged-attention kernel.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class System:
    cfg: object
    lm: object
    engine: object


def engine(cfg, lm, engine_kw: dict, device, clock):
    """A fresh ServeEngine over ``lm`` with a traffic file's geometry."""
    from repro_torch.serve import ServeEngine
    return ServeEngine(cfg, lm, slots=engine_kw["slots"],
                       max_len=engine_kw["max_len"],
                       page_size=engine_kw["page_size"],
                       n_pages=engine_kw.get("n_pages"),
                       prefill_chunk=engine_kw["prefill_chunk"],
                       attn_read="kernel", clock=clock, device=device)


def start(cell, seed: int, device, clock) -> System:
    """The engine on this run's weights, on ``device``: the model that the
    cell's adapter (:class:`perfbench.manifest.Cell`) builds."""
    cfg = cell.adapter.model_config(cell.arch, cell.config_name)
    lm = cell.adapter.build_lm(cfg, cell.arch, seed, device, cell.ref)
    return System(cfg, lm, engine(cfg, lm, cell.traffic["engine"], device,
                                  clock))


def request_states():
    """The program's request states (FINISHED, and the terminal set)."""
    from repro_torch.serve.scheduler import TERMINAL, RequestState
    return RequestState, TERMINAL


def backpressure():
    from repro_torch.serve.engine import Backpressure
    return Backpressure
