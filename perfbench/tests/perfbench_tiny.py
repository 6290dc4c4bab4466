"""A temporary benchmark tree with tiny cells, for the CPU tests.

``tiny_tree(tmp)`` copies the manifest and the data, metric, reference
and adapter files of ``perfbench/`` into ``tmp`` and adds two tiny
configurations of the decoder family (a dense decoder and a 4-expert MoE
with dbrx's norms and clamp) under a closed and an open traffic mix, each
with its limits file.  The harness's code is imported from the
repository; only the files it finds by name come from the tree.
"""
from __future__ import annotations

import contextlib
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

DENSE = {"n_layers": 4, "d_model": 512, "n_heads": 4, "n_kv_heads": 2,
         "d_head": 128, "d_ff": 2048, "vocab_size": 4096, "norm": "rms",
         "norm_eps": 1e-6, "rope_theta": 1e6, "qkv_bias": True,
         "tie_embeddings": True, "n_experts": 0, "top_k": 0,
         "clip_qkv": None}
MOE = dict(DENSE, d_ff=1024, norm="layer", norm_eps=1e-5, qkv_bias=False,
           tie_embeddings=False, n_experts=4, top_k=2, clip_qkv=8,
           capacity_factor=2.0)
CLOSED = {"loop": "closed", "clients": 4, "requests_per_client": 8,
          "prompt_len": [4, 40], "out_len": [4, 24], "temperature_mix": 0.5,
          "base_seed": 0,
          "engine": {"slots": 4, "max_len": 64, "page_size": 8,
                     "prefill_chunk": 16, "n_pages": None},
          "check": {"tokens": 64, "max_requests": 6}}
OPEN = dict(CLOSED, loop="open", rate_rps=3.0, ramp_seconds=0.5,
            drain_seconds=20)
# set from the CPU readings of 12 seeds of each closed and open cell
# (program / float8 control): dense widest gap <= 0.0094 / closed >= 0.0276;
# MoE mean gap <= 0.0026 / >= 0.0042 (closed >= 0.0074).  The largest
# mean gap of a request of 8 tokens or more reads <= 0.0046 and the
# control >= 0.0025: at this size it does not separate the control, which
# the mean gap fails; it is held here for a fault in one slot
LIMITS = {"tiny-dense": {"max_logit_gap": {"limit": 0.02}, "min_tokens": 16},
          "tiny-moe": {"mean_logit_gap": {"limit": 0.004},
                       "max_request_mean_gap": {"limit": 0.03,
                                                "min_request_tokens": 8},
                       "min_tokens": 16}}
CELLS = ("tiny-dense.tclosed", "tiny-dense.topen", "tiny-moe.tclosed",
         "tiny-moe.topen")


@contextlib.contextmanager
def one_thread():
    """Torch on one thread while a tiny run goes: with the test workers
    side by side, more threads only wait for each other."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def tiny_tree(tmp: Path) -> Path:
    base = tmp / "perfbench"
    for d in ("configs", "traffic", "limits", "end_to_end", "per_layer",
              "reference", "adapters"):
        shutil.copytree(ROOT / "perfbench" / d, base / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, arch in (("tiny-dense", DENSE), ("tiny-moe", MOE)):
        write(base / "configs" / f"{name}.json", {"perfbench": {
            "arch": arch, "reference": "perfbench/reference/decoder.py",
            "adapter": "perfbench/adapters/decoder.py"}})
        man["configs"].append({"name": name, "source": "test",
                               "file": f"perfbench/configs/{name}.json",
                               "reduced": [], "why": "test"})
    write(base / "traffic" / "tclosed.json", CLOSED)
    write(base / "traffic" / "topen.json", OPEN)
    for cell in CELLS:
        config, traffic = cell.split(".")
        man["workloads"].append({"name": cell, "config": config,
                                 "traffic": traffic, "chips": 1,
                                 "why": "test"})
        write(base / "limits" / f"{cell}.json", LIMITS[config])
    closed = [c for c in CELLS if c.endswith("tclosed")]
    opened = [c for c in CELLS if c.endswith("topen")]
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            chat = m["name"] == "itl_p95_ms" or m["name"].endswith(".chat")
            m["workloads"] += opened if chat else closed
    write(tmp / "BENCHMARK.json", man)
    return tmp
